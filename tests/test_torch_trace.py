"""The port's tracing (ds2i_torch/utils/trace.py) and plan counters
(plan["counts"]) on the engine's plain path (device="cpu"): a pruned
AND batch and an exhaustive batch through prepare, dispatch and collect
under torch.profiler (CPU activity) leave every ds2i.* span in the
exported chrome trace, the probe's sub-plan nested in ds2i.probe; with
no profiler, span() is the shared no-op context; each plan's counts
equal an independent count from the plan's own arrays. Only the port is
built (no JAX). About 10 s serially."""

import json

import numpy as np
import pytest
import torch

from ds2i_torch.engine import ResidentEngine
from ds2i_torch.host import GlobalParameters, WandData, make_index_type
from ds2i_torch.utils import trace

SPANS = ("ds2i.parse", "ds2i.prune", "ds2i.probe", "ds2i.theta_cache", "ds2i.split",
         "ds2i.layout", "ds2i.upload", "ds2i.decode", "ds2i.join", "ds2i.download",
         "ds2i.wait", "ds2i.unpack")
# three long lists over one dense docid range, so that AND rows of them
# keep more than the probe's AND_PROBE_MIN_BLOCKS blocks, and short ones
LENS = (3600, 3400, 3000, 1200, 400, 90, 17, 3)
QUERIES = [[0, 1, 2], [0, 1], [1, 2, 3], [0, 4], [2, 5], [3, 6], [0, 1, 2, 3], [7], [4, 5, 6],
           [1, 3], [0, 2, 2], [5, 7]]


def _index(tname, num_docs=4000, seed=3):
    rng = np.random.RandomState(seed)
    lists = []
    for n in LENS:
        docs = np.sort(rng.choice(num_docs, size=n, replace=False)).astype(np.int64)
        freqs = np.where(rng.rand(n) < 0.05, rng.randint(5, 60, n), 1).astype(np.int64)
        lists.append((docs, freqs))
    b = make_index_type(tname).builder(num_docs, GlobalParameters())
    for docs, freqs in lists:
        b.add_posting_list(len(docs), docs, freqs, int(freqs.sum()))
    sizes = rng.randint(50, 400, num_docs).astype(np.int64)
    return b.build(), WandData.build(sizes, lists), lists


@pytest.fixture(scope="module")
def built():
    return {t: _index(t) for t in ("block_optpfor", "opt")}


def _engine(built, tname, cache_dir=None):
    index, wdata, lists = built[tname]
    eng = ResidentEngine(index, wdata, device="cpu", cache_dir=cache_dir)
    eng.build_blockmax(lists)
    return eng


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("ds2i.prune") is trace.span("ds2i.unpack") is trace._OFF
    with trace.span("ds2i.prune") as entered:
        assert entered is None


def test_every_span_lands_in_the_trace_and_the_probe_nests_its_sub_plan(built, tmp_path):
    # opt: the plain pair decode is a few ops a part (the plain block
    # decoders' thousands would swell the trace)
    eng = _engine(built, "opt", cache_dir=str(tmp_path / "cache"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert trace.span("ds2i.parse") is not trace._OFF
        pruned = eng.prepare(QUERIES, k=10, ops=("and",), prune=True)
        eng.collect(pruned, eng.dispatch(pruned))
        exhaustive = eng.prepare(QUERIES, k=10, ops=("and",))
        eng.collect(exhaustive, eng.dispatch(exhaustive))
    assert pruned["counts"]["probe_rows"] > 0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = {e["name"] for e in events if e["name"].startswith("ds2i.")}
    assert names == set(SPANS)
    probes = [e for e in events if e["name"] == "ds2i.probe"]
    assert len(probes) == 1
    p0, p1 = probes[0]["ts"], probes[0]["ts"] + probes[0]["dur"]
    inside = {e["name"] for e in events
              if e is not probes[0] and p0 <= e["ts"] and e["ts"] + e["dur"] <= p1}
    assert {"ds2i.layout", "ds2i.upload", "ds2i.wait", "ds2i.decode", "ds2i.unpack"} <= inside
    # the batch's own stages lie outside the probe
    outside = {e["name"] for e in events if e["ts"] > p1 or e["ts"] + e["dur"] < p0}
    assert {"ds2i.parse", "ds2i.prune", "ds2i.theta_cache", "ds2i.layout"} <= outside


def _uploaded_bytes(plan):
    """The bytes dispatch copies for a plan on the CPU, from its host
    arrays: the int64 tile maps, the non-empty CTA tables and the plain
    join's bucket tables and int64 pack index."""
    n = 0
    for p in plan["plans"]:
        n += 8 * (len(p["gtile_ids"]) + len(p["gtile_f"]) + len(p["blkperm"]))
        n += sum(h.nbytes for h in p["layout"].tables.values() if len(h))
        n += sum(b["dir"].nbytes + b["qwtab"].nbytes + b["tgt"].nbytes for b in p["buckets"])
        n += 8 * len(p["pack_idx"])
    return n


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("tname", ["block_optpfor", "opt"])
def test_plan_counts_equal_an_independent_count(built, tname, prune):
    eng = _engine(built, tname)
    plan = eng.prepare(QUERIES, k=10, ops=("and",), prune=prune)
    c = plan["counts"]
    assert set(c) == {"dir_blocks", "dir_kept", "probe_rows", "refined_rows", "decode_blocks",
                      "upload_bytes"}
    # every block of each query's distinct terms
    assert c["dir_blocks"] == sum(int(eng.list_blocks[t]) for q in QUERIES for t in set(q))
    # the final directory: the join's real entries over the parts
    assert c["dir_kept"] == sum(len(p["join"].ent) for p in plan["plans"])
    if prune:
        assert 0 < c["dir_kept"] < c["dir_blocks"]
        terms, qw, counts = eng._prep_terms(QUERIES, True)
        dir0 = eng._pruned_directory(terms, qw, counts, 10, np.repeat(np.arange(len(counts)),
                                                                       counts), mode="and")
        assert c["probe_rows"] == int(np.sum(dir0[3] > eng.AND_PROBE_MIN_BLOCKS)) > 0
        # the final directory recomputed the rows the probe gave a threshold
        tmax = max(2, 1 << (int(counts.max()) - 1).bit_length())
        theta = eng._and_prefix_probe(dir0, terms, qw, counts, 10, tmax, {"probe_rows": 0})
        assert c["refined_rows"] == int(np.isfinite(theta).sum()) > 0
    else:
        assert c["dir_kept"] == c["dir_blocks"] and c["probe_rows"] == c["refined_rows"] == 0
    # the blocks of each part's tiles (pad rows left out)
    assert c["decode_blocks"] == sum(
        int(eng.tile_blocks[g[g != eng.pad_tile]].sum())
        for g in (np.asarray(p["gtile_ids"]) for p in plan["plans"]))
    assert c["upload_bytes"] == 0
    eng.collect(plan, eng.dispatch(plan))
    assert c["upload_bytes"] == _uploaded_bytes(plan) > 0
    # a second dispatch of the plan finds its tables on the device
    eng.collect(plan, eng.dispatch(plan))
    assert c["upload_bytes"] == _uploaded_bytes(plan)
