"""The port's quick-start tools (python -m ds2i_torch.tools.<tool>), run
in-process as tests/test_tools_cli.py runs the JAX package's: gen_collection,
create_freq_index --check (opt and block_optpfor), create_wand_data, and
queries with the cursor, resident (--device cpu), native and
--latency-sweep modes, asserted on their stats lines; then the WSDM'15
chain of tests/test_tools_cli.py:56-97 (profile_queries, closed form and
--replay; profile_decoding, host and resident on the CPU;
dec_time_regression; optimal_hybrid_index --check; the hybrid served).
Each file the port's tools write is byte-equal to the JAX package's
tool's on the same arguments (profile_decoding's records equal but for
their times). Without --device the resident engine wants the CUDA card
and raises where there is none.

About 25 s serially."""

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


# -- the WSDM'15 tool chain (tests/test_tools_cli.py:56-97, through the port) --


@pytest.fixture(scope="module")
def chain(files, tmp_path_factory):
    """The port's chain over block_optpfor: profile_queries (closed form and
    --replay), profile_decoding (host, and resident on the CPU),
    dec_time_regression, optimal_hybrid_index --check; its files."""
    d = tmp_path_factory.mktemp("chain")
    f = {k: str(d / k) for k in ("bs", "bs_replay", "prof", "prof_dev", "prof_host8", "weights",
                                 "lambdas", "mixed")}
    idx, q = files["block_optpfor"], ["--queries", files["coll"] + ".queries"]
    for out, extra in ((f["bs"], []), (f["bs_replay"], ["--replay"])):
        run_tool("ds2i_torch", "profile_queries",
                 ["block_optpfor", "ranked_and", idx, files["wand"], *q, "--out", out, *extra])
    run_tool("ds2i_torch", "profile_decoding",
             ["block_optpfor", idx, "0.5", "--out", f["prof"], "--replays", "2"])
    run_tool("ds2i_torch", "profile_decoding",
             ["block_optpfor", idx, "0.08", "--out", f["prof_host8"], "--replays", "1"])
    run_tool("ds2i_torch", "profile_decoding",
             ["block_optpfor", idx, "0.08", "--out", f["prof_dev"], "--engine", "resident",
              "--copies", "8", "--replays", "4", "--device", "cpu"])
    run_tool("ds2i_torch", "dec_time_regression", [f["prof"], "--out", f["weights"]])
    f["hybrid_stats"] = run_tool(
        "ds2i_torch", "optimal_hybrid_index",
        ["block_optpfor", f["weights"], f["bs"], idx, f["lambdas"], "60000", f["mixed"],
         "--check", files["coll"]])
    return f


def test_profile_queries_equals_jax_and_replay(files, chain, tmp_path):
    """The closed-form block stats equal the serial cursor replay and the
    JAX tool's, byte for byte."""
    text = open(chain["bs"]).read()
    assert text and text == open(chain["bs_replay"]).read()
    ref = str(tmp_path / "ref.tsv")
    run_tool("ds2i_tpu", "profile_queries",
             ["block_optpfor", "ranked_and", files["block_optpfor"], files["wand"], "--queries",
              files["coll"] + ".queries", "--out", ref])
    assert text == open(ref).read()


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_profile_decoding_records(files, chain, tmp_path):
    """Host mode: the JAX tool's records on the same sample, time aside.
    Resident mode on the CPU (the kernels' plain versions): the JAX
    schema, the host mode's features record for record, every kernel's
    groups timed (K1s among them) and most times positive."""
    ref = str(tmp_path / "ref.jsonl")
    run_tool("ds2i_tpu", "profile_decoding",
             ["block_optpfor", files["block_optpfor"], "0.08", "--out", ref, "--replays", "1"])
    host, jref = _records(chain["prof_host8"]), _records(ref)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "time"} for r in rs]  # noqa: E731
    assert host and strip(host) == strip(jref)
    dev = _records(chain["prof_dev"])
    assert set(dev[0]) == set(jref[0]) and strip(dev) == strip(host)
    assert sum(r["time"] > 0 for r in dev) >= len(dev) // 2


def test_resident_profiler_times_every_kernel(files):
    """DeviceProfiler on the CPU: the groups of a sample reach K1 (E = 0),
    K1s (E > 0), K7 and K2, each timed once."""
    from ds2i_torch.codecs.interpolative import UNKNOWN_SUM
    from ds2i_torch.codecs.mixed import BLOCK_TYPES, compr_params
    from ds2i_torch.tools.common import load_index
    from ds2i_torch.tools.profile_decoding import DeviceProfiler

    index = load_index(files["block_optpfor"], "block_optpfor")
    prof = DeviceProfiler(copies=8, reps=2, device="cpu")
    recs = []
    li = max(range(index.size()), key=index.list_length)
    ib = index.get_blocks(li)[0]
    freqs, _ = index.codec.decode(ib.freqs_bytes, 0, UNKNOWN_SUM, ib.size)
    for t in range(BLOCK_TYPES):
        for param in range(compr_params(t)):
            from ds2i_torch.codecs.mixed import MixedBlock
            from ds2i_torch.codecs.time_prediction import FeatureVector, values_statistics

            fv = FeatureVector()
            values_statistics(freqs, fv)
            if MixedBlock.compression_stats(t, param, freqs, UNKNOWN_SUM, 128, fv) is None:
                continue
            recs.append({})
            prof.add(t, param, freqs, UNKNOWN_SUM, recs[-1])
    assert prof.flush() == sum(prof.timed.values())
    assert {"optpfor", "optpfor_s16", "varint", "interp"} <= set(prof.timed)
    assert all(r["time"] >= 0 for r in recs)


def test_dec_time_regression_equals_jax(chain, tmp_path):
    ref = str(tmp_path / "ref.tsv")
    run_tool("ds2i_tpu", "dec_time_regression", [chain["prof"], "--out", ref])
    text = open(chain["weights"]).read()
    assert text.startswith("type") and text == open(ref).read()


def test_optimal_hybrid_index_equals_jax(files, chain, tmp_path):
    """Lambdas and the block_mixed index byte-equal to the JAX tool's on the
    same weights, block stats and index (--check passed in both)."""
    assert any(s.get("type") == "block_mixed" for s in chain["hybrid_stats"])
    lam, mixed = str(tmp_path / "lambdas.bin"), str(tmp_path / "mixed.bin")
    ref_stats = run_tool("ds2i_tpu", "optimal_hybrid_index",
                         ["block_optpfor", chain["weights"], chain["bs"], files["block_optpfor"],
                          lam, "60000", mixed, "--check", files["coll"]])
    assert ref_stats == chain["hybrid_stats"]
    assert open(chain["lambdas"], "rb").read() == open(lam, "rb").read()
    assert open(chain["mixed"], "rb").read() == open(mixed, "rb").read()


def test_hybrid_serves_the_same_results(files, chain):
    """The rebuilt block_mixed index, served by the resident engine on the
    CPU, gives block_optpfor's ranked results."""
    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.queries import read_queries
    from ds2i_torch.tools.common import load_index, load_wand_data

    w = load_wand_data(files["wand"])
    qs = read_queries(files["coll"] + ".queries")
    mixed = load_index(chain["mixed"], "block_mixed")
    a = ResidentEngine(load_index(files["block_optpfor"], "block_optpfor"), w, device="cpu")
    b = ResidentEngine(mixed, w, device="cpu")
    assert {"optp", "interp"} <= {st[0] for st in b.group_statics_d + b.group_statics_f}
    for got, exp in zip(b.ranked_and(qs, k=10), a.ranked_and(qs, k=10)):
        assert len(got) == len(exp)
        np.testing.assert_allclose(got, exp, rtol=1e-6)
