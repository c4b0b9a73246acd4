"""The port's scale-out path on the CPU (device="cpu", the plain PyTorch
path): DocShardedEngine (ds2i_torch.parallel.doc_sharded) against the
port's single engine, and over block_optpfor against the JAX package's
DocShardedEngine (its exhaustive ops: the pruned ones must equal them),
each over an index of its own package; the shards'
planners on terms a shard lacks (term_remap -1) against the JAX shards'
plan arrays; from_collection against the reshard of a built index;
make_engine's choice; and ResidentEngine(devices=) replicas with parts
round-robin. Counts exact, top-10 scores within rtol 1e-3, pruned equal
to exhaustive. The query log gets one AND query per shard of a term the
shard lacks beside a common one.

About 60 s serially; the JAX shard engines' compiles, all in the `ref`
fixture, take a third of it."""

import gc

import jax
import numpy as np
import pytest

from ds2i_tpu.parallel import DocShardedEngine as JaxDocShardedEngine

from ds2i_torch.engine import ResidentEngine, make_engine
from ds2i_torch.host import BinaryFreqCollection
from ds2i_torch.parallel import (
    DocShardedEngine, shard_collection_by_doc_range, shard_index_by_doc_range,
)

from test_torch_host_copy import _assert_tree_equal, assert_same_walk, build_index, build_wdata
from test_torch_resident import _assert_topk_close, _plan_arrays

NQ = 24
SHARDS = 3
OPS = ("ranked_and", "ranked_or", "wand", "maxscore")
ALL_OPS = OPS + ("ranked_and_prune",)


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """As in tests/test_torch_blockmax.py: release each test's JAX
    executables before the next test compiles its own."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    from ds2i_tpu.io import generate_collection

    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=600, num_terms=900, postings_target=20_000,
                        num_queries=NQ, max_query_len=4)
    return base


@pytest.fixture(scope="module")
def queries(coll):
    """The log, then per shard an AND query of a term the shard lacks
    (postings elsewhere) beside the log's most common term."""
    from ds2i_torch.host import read_queries

    qs = read_queries(coll + ".queries")
    _, remaps, _, dfs = shard_index_by_doc_range(build_index(coll, "block_optpfor", "port"),
                                                 SHARDS)
    common = int(np.argmax(dfs))
    for r in remaps:
        lacking = np.flatnonzero((r < 0) & (dfs > 0))
        qs.append([int(lacking[0]), common])
    return qs


@pytest.fixture(scope="module")
def engines(coll):
    """name -> (port index, port wdata, port single engine, port sharded
    engine) for block_optpfor and opt."""
    assert_same_walk()
    wd = build_wdata(coll, "port")
    out = {}
    for name in ("block_optpfor", "opt"):
        index = build_index(coll, name, "port")
        out[name] = (index, wd, ResidentEngine(index, wd, device="cpu"),
                     DocShardedEngine(index, wd, num_shards=SHARDS, device="cpu"))
    return out


def _run(eng, op, qs):
    if op == "and_counts" or op == "or_counts":
        return getattr(eng, op)(qs)
    if op == "ranked_and_prune":
        return eng.ranked_and(qs, k=10, prune=True)
    return getattr(eng, op)(qs, k=10)


@pytest.fixture(scope="module")
def ref(coll, queries):
    """The JAX DocShardedEngine over block_optpfor, run once: the result
    of each exhaustive op, and each shard's parse and plan arrays
    (exhaustive and pruned AND). Its block-max tables come from each
    shard's lists (build_blockmax), not its decode pass: fewer
    compiles."""
    eng = JaxDocShardedEngine(build_index(coll, "block_optpfor", "ref"),
                              build_wdata(coll, "ref"), num_shards=SHARDS)
    shards = []
    for e in eng.engines:
        e.build_blockmax([e.index.decode_list(i) for i in range(e.index.size())])
        shards.append((e.term_remap, e._prep_terms(queries, True),
                       {prune: _plan_arrays(e.prepare(queries, k=10, ops=("and",), prune=prune))
                        for prune in (False, True)}))
    return {op: _run(eng, op, queries)
            for op in ("and_counts", "or_counts", "ranked_and", "ranked_or")}, shards


@pytest.mark.parametrize("name", ["block_optpfor", "opt"])
def test_counts_equal_single_engine_and_jax_shards(engines, ref, queries, name):
    _, _, single, sharded = engines[name]
    # a doc range without postings of some term: its shard maps it to -1
    assert any((e.term_remap < 0).any() for e in sharded.engines)
    for op in ("and_counts", "or_counts"):
        got = getattr(sharded, op)(queries)
        np.testing.assert_array_equal(got, getattr(single, op)(queries), err_msg=op)
        if name == "block_optpfor":
            np.testing.assert_array_equal(got, ref[0][op], err_msg=op)


@pytest.mark.parametrize("op", ALL_OPS)
@pytest.mark.parametrize("name", ["block_optpfor", "opt"])
def test_topk_equal_single_engine_and_jax_shards(engines, ref, queries, name, op):
    _, _, single, sharded = engines[name]
    got = _run(sharded, op, queries)
    exact = single.ranked_and(queries, k=10) if op.startswith("ranked_and") else (
        single.ranked_or(queries, k=10))
    _assert_topk_close(got, _run(single, op, queries), queries)
    _assert_topk_close(got, exact, queries)  # pruned equal to exhaustive
    if name == "block_optpfor":
        _assert_topk_close(got, ref[0]["ranked_and" if op.startswith("ranked_and")
                                        else "ranked_or"], queries)


def test_shard_plans_equal_jax_shards(engines, ref, queries):
    """Each shard's plan, exhaustive and pruned (terms it lacks remapped
    to -1: no tiles, no blocks, still in the AND target), equals the JAX
    shard's array for array; the query weights take the collection's
    idf."""
    sharded = engines["block_optpfor"][3]
    for s, (port_e, (remap, parsed, plans)) in enumerate(zip(sharded.engines, ref[1])):
        np.testing.assert_array_equal(port_e.term_remap, remap)
        terms, qw, counts = port_e._prep_terms(queries, True)
        for got, exp in zip((terms, qw, counts), parsed):
            np.testing.assert_array_equal(got, exp)
        missing = terms < 0
        assert missing.any(), s
        _, ntiles = port_e._term_tiles(terms)
        assert not ntiles[missing].any() and not port_e._term_blocks(terms)[missing].any()
        span_row = np.repeat(np.arange(len(counts)), counts)
        rows = np.unique(span_row[missing])
        for prune in (False, True):
            got = port_e.prepare(queries, k=10, ops=("and",), prune=prune)
            assert _plan_arrays(got) == plans[prune], (s, prune)
            # a row with a lacking term keeps its full AND target
            tgt = {int(q): int(t) for p in got["plans"] for b in p["buckets"]
                   for q, t in zip(b["rows"], b["tgt"])}
            assert all(tgt.get(int(r), counts[r]) == counts[r] for r in rows)


def test_pruned_directory_drops_lacking_terms(engines, queries):
    """_pruned_directory keeps no entry of a -1 span in any mode, and an
    AND row with a lacking term keeps no entry at all."""
    eng = engines["block_optpfor"][3].engines[0]
    eng._ensure_blockmax()
    terms, qw, counts = eng._prep_terms(queries, True)
    span_row = np.repeat(np.arange(len(counts)), counts)
    missing = terms < 0
    for kw in ({"mode": "or"}, {"mode": "or", "essential": True}, {"mode": "and"},
               {"probe_rank": 2}):
        gk, sk, rb, rnb = eng._pruned_directory(terms, qw, counts, 10, span_row, **kw)
        assert not missing[sk].any(), kw
        if kw.get("mode") == "and":
            assert not np.isin(rb, span_row[missing]).any()


def test_from_collection_equals_reshard(coll, engines, queries):
    index, wd, _, sharded = engines["block_optpfor"]
    subs, remaps, bounds, gdfs = shard_index_by_doc_range(index, SHARDS)
    csubs, cremaps, cbounds, cgdfs = shard_collection_by_doc_range(
        BinaryFreqCollection(coll), "block_optpfor", SHARDS)
    np.testing.assert_array_equal(bounds, cbounds)
    np.testing.assert_array_equal(gdfs, cgdfs)
    for s, cs, r, cr in zip(subs, csubs, remaps, cremaps):
        np.testing.assert_array_equal(r, cr)
        _assert_tree_equal(cs.tree(), s.tree())
    built = DocShardedEngine.from_collection(BinaryFreqCollection(coll), "block_optpfor", wd,
                                             num_shards=SHARDS, device="cpu")
    np.testing.assert_array_equal(built.and_counts(queries), sharded.and_counts(queries))
    _assert_topk_close(built.ranked_or(queries, k=10), sharded.ranked_or(queries, k=10), queries)


def test_make_engine_picks_each_class(engines, queries):
    """As tests/test_engine.py's make_engine case: a ResidentEngine under
    the limit, a DocShardedEngine with equal results above it."""
    index, wd, single, _ = engines["block_optpfor"]
    small = make_engine(index, wd, device="cpu")
    assert isinstance(small, ResidentEngine)
    forced = make_engine(index, wd, limit=len(index.lists) // 3, device="cpu")
    assert isinstance(forced, DocShardedEngine) and forced.num_shards >= 3
    np.testing.assert_array_equal(forced.and_counts(queries), small.and_counts(queries))
    _assert_topk_close(forced.ranked_and(queries, k=10), single.ranked_and(queries, k=10),
                       queries)
    ef, ef_wd = engines["opt"][:2]
    assert isinstance(make_engine(ef, ef_wd, device="cpu"), ResidentEngine)
    nbytes = (len(ef.docs_sequences.bits_bv.words) + len(ef.freqs_sequences.bits_bv.words)) * 8
    assert isinstance(make_engine(ef, ef_wd, limit=nbytes // 2, device="cpu"), DocShardedEngine)


@pytest.mark.parametrize("name", ["block_optpfor", "opt"])
def test_replicas_round_robin_equal_one_device(engines, queries, name):
    """As tests/test_engine.py's multi-device case: four replicas, parts
    round-robin, results equal to the one-device engine's."""
    index, wd, single, _ = engines[name]
    multi = ResidentEngine(index, wd, devices=["cpu"] * 4, max_part_queries=8)
    assert len(multi._replicas) == 4
    assert len({id(r.docs_words) for r in multi._replicas}) == 4  # copies, not aliases
    assert len(multi.prepare(queries)["plans"]) >= 4
    _assert_topk_close(multi.ranked_and(queries, k=10), single.ranked_and(queries, k=10),
                       queries)
    _assert_topk_close(multi.wand(queries, k=10), single.ranked_or(queries, k=10), queries)
    np.testing.assert_array_equal(multi.or_counts(queries), single.or_counts(queries))
    for r in multi._replicas[1:]:  # the norm cache, copied to every replica
        assert r.den_blocks is not multi.state.den_blocks
        np.testing.assert_array_equal(r.den_blocks.numpy(), multi.state.den_blocks.numpy())
        np.testing.assert_array_equal(r.tile_gblk0.numpy(), multi.state.tile_gblk0.numpy())


def test_device_and_devices_together_raise(engines):
    index, wd = engines["block_optpfor"][:2]
    with pytest.raises(ValueError, match="device= or devices="):
        ResidentEngine(index, wd, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="devices= or device="):
        DocShardedEngine(index, wd, num_shards=2, device="cpu", devices=["cpu"])
