"""The port's quick-start tools (python -m ds2i_torch.tools.<tool>), run
in-process as tests/test_tools_cli.py runs the JAX package's: gen_collection,
create_freq_index --check (opt and block_optpfor), create_wand_data, and
queries with the cursor, resident (--device cpu), native and
--latency-sweep modes, asserted on their stats lines. Each file the
port's tools write is byte-equal to the JAX package's tool's on the same
arguments. Without --device the resident engine wants the CUDA card and
raises where there is none.

About 20 s serially."""

import importlib
import io
import json
import os
import sys
from contextlib import redirect_stdout
from unittest import mock

import numpy as np
import pytest
import torch

QUERY_OPS = "and:ranked_and:wand:maxscore"


def run_tool(pkg, mod, argv):
    """Run `python -m <pkg>.tools.<mod> argv` in this process; its stats
    lines."""
    m = importlib.import_module(f"{pkg}.tools.{mod}")
    out = io.StringIO()
    with mock.patch.object(sys, "argv", [mod] + [str(a) for a in argv]), redirect_stdout(out):
        m.main()
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The walkthrough's files, written by the port's tools, and the
    tools' stats lines."""
    d = tmp_path_factory.mktemp("cli")
    out = {"coll": str(d / "coll"), "wand": str(d / "wand.bin"), "stats": {}}
    out["stats"]["gen"] = run_tool("ds2i_torch", "gen_collection",
                                   [out["coll"], 400, "--terms", 900, "--postings", 15000,
                                    "--queries", 25])
    for name in ("opt", "block_optpfor"):
        out[name] = str(d / f"{name}.bin")
        out["stats"][name] = run_tool("ds2i_torch", "create_freq_index",
                                      [name, out["coll"], out[name], "--check"])
    run_tool("ds2i_torch", "create_wand_data", [out["coll"], out["wand"]])
    with open(out["coll"] + ".queries") as f, open(out["coll"] + ".queries8", "w") as g:
        g.writelines(f.readlines()[:8])  # the latency sweep's log
    return out


def test_gen_collection(files, tmp_path):
    (line,) = files["stats"]["gen"]
    assert line["type"] == "collection" and line["num_docs"] == 400 and line["postings"] > 0
    ref = str(tmp_path / "ref")
    run_tool("ds2i_tpu", "gen_collection",
             [ref, 400, "--terms", 900, "--postings", 15000, "--queries", 25])
    for ext in (".docs", ".freqs", ".sizes", ".queries"):
        assert open(files["coll"] + ext, "rb").read() == open(ref + ext, "rb").read(), ext


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_create_freq_index_check(files, tmp_path, name):
    stats = files["stats"][name]
    assert stats[0]["type"] == name and stats[0]["postings"] > 0
    assert any("bits_per_posting" in s and "size" in s for s in stats)
    if name == "opt":  # the partitioned types' stats line
        assert any(s.get("partitions", 0) > 0 for s in stats)
    ref = str(tmp_path / "ref.bin")
    ref_stats = run_tool("ds2i_tpu", "create_freq_index",
                         [name, files["coll"], ref, "--check"])
    assert [sorted(s) for s in ref_stats] == [sorted(s) for s in stats]
    assert open(files[name], "rb").read() == open(ref, "rb").read()


def test_create_wand_data(files, tmp_path):
    ref = str(tmp_path / "ref.wand")
    run_tool("ds2i_tpu", "create_wand_data", [files["coll"], ref])
    assert open(files["wand"], "rb").read() == open(ref, "rb").read()


def _queries(files, name, ops, *extra, log=".queries"):
    return run_tool("ds2i_torch", "queries",
                    [name, ops, files[name], files["wand"], "--queries", files["coll"] + log,
                     *extra])


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_queries_cursor(files, name):
    stats = _queries(files, name, QUERY_OPS)
    assert [s["query"] for s in stats] == QUERY_OPS.split(":")
    assert all(s["avg"] > 0 and s["q50"] <= s["q95"] for s in stats)


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_queries_resident_on_cpu(files, tmp_path, name):
    cache = str(tmp_path / "cache")
    # the second run loads the engine's state from --cache-dir
    for ops in (QUERY_OPS, "ranked_and:wand"):
        stats = _queries(files, name, ops, "--engine", "resident", "--device", "cpu",
                         "--cache-dir", cache)
        assert [s["query"] for s in stats] == ops.split(":")
        assert all(s["engine"] == "resident" and s["avg"] > 0 for s in stats)
    assert any(f.endswith("_blockmax.npz") for f in os.listdir(cache))


def test_queries_native(files):
    stats = _queries(files, "block_optpfor", "and:ranked_and:ranked_or",
                     "--engine", "native")
    assert [s["query"] for s in stats] == ["and", "ranked_and", "ranked_or"]
    assert all(s["engine"] == "native" and s["avg"] > 0 for s in stats)


def test_queries_latency_sweep_on_cpu(files):
    stats = _queries(files, "block_optpfor", "ranked_and", "--latency-sweep", "--device", "cpu",
                     log=".queries8")
    assert [s["batch"] for s in stats] == ["1", "16", "64", "1024", "full"]
    assert all(s["mode"] == "latency_sweep" and np.isfinite(s["lat_ms_q50"]) for s in stats)
    assert stats[0]["batches"] == 8


def test_queries_resident_without_a_card_raises(files):
    if torch.cuda.is_available():
        pytest.skip("the default device, the CUDA card, is there")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _queries(files, "block_optpfor", "ranked_and", "--engine",
                 "resident")
