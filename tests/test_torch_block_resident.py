"""ds2i_torch.engine.ResidentEngine in split mode (device="cpu", the plain
PyTorch path) over block_optpfor and block_interpolative indexes, against
the JAX ResidentEngine and the numpy oracle, each engine over an index
built by its own package from one collection: tables, statics, plan arrays
and the norm cache exactly, decoded lists and boolean counts exactly,
top-10 BM25 scores within rtol 1e-3 (the f16 download rounds at 2^-11,
and XLA's f32 divide is not IEEE)."""

import gc

import jax
import numpy as np
import pytest
import torch

from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine
from ds2i_tpu.index.hybrid import rebuild_mixed
from ds2i_tpu.io import generate_collection
from ds2i_tpu.queries import and_query, or_query, ranked_and_query, ranked_or_query, read_queries

from ds2i_torch.engine import ResidentEngine, resident_state_from_arrays
from ds2i_torch.engine.tiles import F_NVALS
from ds2i_torch.ops.block_decode import block_stream_torch

from test_torch_host_copy import assert_same_walk, build_index, build_wdata
from test_torch_resident import _assert_topk_close, _plan_arrays

NQ = 24  # queries per check
BLOCK_TYPES = ["block_optpfor", "block_interpolative"]


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release the JAX executables each test compiled before the next
    one (the fixture of tests/test_wand_device.py): this module's JAX
    engines compile large XLA-CPU programs, and a full suite's
    live-executable population is what crashes XLA-CPU's compiler in a
    worker."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


@pytest.fixture(scope="module")
def setup(coll):
    """name -> (index, wdata, port engine, JAX engine, port index): each
    engine over an index of its own package, both on the same walk."""
    assert_same_walk()
    wdata, port_wdata = build_wdata(coll, "ref"), build_wdata(coll, "port")
    out = {}
    for name in BLOCK_TYPES:
        index, port_index = build_index(coll, name, "ref"), build_index(coll, name, "port")
        out[name] = (index, wdata, ResidentEngine(port_index, port_wdata, device="cpu"),
                     JaxResidentEngine(index, wdata), port_index)
    return out


@pytest.fixture(scope="module")
def queries(coll):
    return read_queries(coll + ".queries")[:NQ]


def check_tables_and_words(port, ref):
    """Per-stream statics (exception groups remapped to "optp"), gids, the
    field tables with BF_EX_BASE filled, and the one resident word stream
    (index bytes + patch pairs), uploaded once."""
    assert port.split and ref.split
    assert port.group_statics_d == ref.group_statics_d
    assert port.group_statics_f == ref.group_statics_f
    np.testing.assert_array_equal(port.tile_gid_d, ref.tile_gid_d)
    np.testing.assert_array_equal(port.tile_gid_f, ref.tile_gid_f)
    s = port.state
    np.testing.assert_array_equal(s.tiles_docs.numpy(), np.asarray(ref.tiles_docs))
    np.testing.assert_array_equal(s.tiles_freqs.numpy(), np.asarray(ref.tiles_freqs))
    np.testing.assert_array_equal(s.docs_words.numpy().view(np.uint32), np.asarray(ref.docs_words))
    assert s.freqs_words is s.docs_words
    assert s.nbytes() == sum(t.numel() * t.element_size() for t in (
        s.docs_words, s.tiles_docs, s.tiles_freqs, s.norm_den, s.den_blocks, s.tile_gblk0)
        if t is not None)
    return {st[0] for st in port.group_statics_d + port.group_statics_f}


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_tables_and_words_match_jax(setup, name):
    _, _, port, ref, _ = setup[name]
    kinds = check_tables_and_words(port, ref)
    if name == "block_optpfor":
        assert "optp" in kinds


def check_every_tile_decodes_as_the_host(index, port):
    """block_stream_torch over every group of both streams equals
    index.decode_list on every list, and writes the pads."""
    s, nt = port.state, port.pad_tile
    nvals = port.tiles.docs[:, F_NVALS]
    decoded = {}
    for stream, gid, stats, table in (
        ("docs", port.tile_gid_d, port.group_statics_d, s.tiles_docs),
        ("freqs", port.tile_gid_f, port.group_statics_f, s.tiles_freqs),
    ):
        rows = np.zeros((nt, 128), np.int64)
        groups, gids, _, _, _ = port._order_groups(np.arange(nt), gid, stats)
        for off, R, st in groups:
            ids = gids[off:off + R]
            out = block_stream_torch(s.docs_words, table[torch.from_numpy(ids.astype(np.int64))],
                                     st, port.num_docs, stream == "docs").numpy()
            assert out.shape == (R, st[-1]) and out.dtype == np.int32
            real = ids < nt
            j = np.arange(st[-1])[None, :]
            pads = j >= np.append(nvals, 0)[ids][:, None]
            assert np.all(out[pads] == (port.num_docs if stream == "docs" else 0))
            rows[ids[real], :st[-1]] = out[real]
        decoded[stream] = rows
    for li in range(index.size()):
        tiles = range(int(port.list_tile_start[li]), int(port.list_tile_start[li + 1]))
        hd, hf = index.decode_list(li)
        np.testing.assert_array_equal(
            np.concatenate([decoded["docs"][t, :nvals[t]] for t in tiles]), hd, err_msg=f"list {li}")
        np.testing.assert_array_equal(
            np.concatenate([decoded["freqs"][t, :nvals[t]] for t in tiles]), hf, err_msg=f"list {li}")


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_every_tile_decodes_as_the_host(setup, name):
    index, _, port, _, _ = setup[name]
    check_every_tile_decodes_as_the_host(index, port)


@pytest.fixture(scope="module")
def small_parts(coll, setup):
    """name -> (port engine, JAX engine) over setup's indexes with small
    part budgets, built once for every plan case."""
    kw = dict(max_part_slots=1 << 13, max_part_queries=32)
    port_wdata = build_wdata(coll, "port")
    return {name: (ResidentEngine(setup[name][4], port_wdata, device="cpu", **kw),
                   JaxResidentEngine(setup[name][0], setup[name][1], **kw))
            for name in BLOCK_TYPES}


@pytest.mark.parametrize("ops", [("and",), ("or",), ("counts",)])
@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_plan_arrays_match_jax(coll, small_parts, name, ops):
    """Small part budgets force several parts; every plan array equals the
    JAX engine's, gtile_f, blkperm and groups_f included."""
    port, ref = small_parts[name]
    qs = read_queries(coll + ".queries")
    ranked = ops != ("counts",)
    got = port.prepare(qs, k=10, ops=ops, ranked=ranked)
    exp = ref.prepare(qs, k=10, ops=ops, ranked=ranked)
    assert len(got["plans"]) > 1
    assert all(p["groups_f"] for p in got["plans"])
    assert _plan_arrays(got) == _plan_arrays(exp)


def check_norm_cache(port, ref):
    port._ensure_norm_cache()
    ref._ensure_norm_cache()
    np.testing.assert_array_equal(port.state.den_blocks.numpy(), np.asarray(ref.den_blocks))
    np.testing.assert_array_equal(port.state.tile_gblk0.numpy(), np.asarray(ref.tile_gblk0))


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_norm_cache_matches_jax(setup, name):
    check_norm_cache(*setup[name][2:4])


def check_counts(index, port, ref, queries):
    """and/or counts exactly equal to the JAX engine's and the oracle's."""
    got_and, got_or = port.and_counts(queries), port.or_counts(queries)
    np.testing.assert_array_equal(got_and, ref.and_counts(queries))
    np.testing.assert_array_equal(got_or, ref.or_counts(queries))
    for i, terms in enumerate(queries):
        assert got_and[i] == and_query(index, terms), f"AND q={terms}"
        assert got_or[i] == or_query(index, terms), f"OR q={terms}"


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_counts_match_jax_and_oracle(setup, queries, name):
    index, _, port, ref, _ = setup[name]
    check_counts(index, port, ref, queries)


def check_ranked(index, wdata, port, ref, queries):
    """Top-10 ranked_and / ranked_or within rtol 1e-3 of the JAX engine's
    and the oracle's; returns the port's (and, or) results."""
    got_and, got_or = port.ranked_and(queries, k=10), port.ranked_or(queries, k=10)
    _assert_topk_close(got_and, ref.ranked_and(queries, k=10), queries)
    _assert_topk_close(got_or, ref.ranked_or(queries, k=10), queries)
    _assert_topk_close(got_and, [ranked_and_query(index, wdata, q, k=10) for q in queries], queries)
    _assert_topk_close(got_or, [ranked_or_query(index, wdata, q, k=10) for q in queries], queries)
    return got_and, got_or


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_ranked_match_jax_and_oracle(setup, queries, name):
    index, wdata, port, ref, _ = setup[name]
    check_ranked(index, wdata, port, ref, queries)


def test_from_state_over_block_index(coll, setup, queries):
    """An engine over the JAX engine's resident arrays (its one word
    stream given for both fields, norm cache included) serves the same
    results: over block_optpfor (exception patch words appended) and over
    block_qmx (the QMX kernel's fields)."""
    wdata, port_wdata = setup["block_optpfor"][1], build_wdata(coll, "port")
    qmx = (build_index(coll, "block_qmx", "ref"), build_index(coll, "block_qmx", "port"))
    engines = {
        "block_optpfor": setup["block_optpfor"][2:5],
        "block_qmx": (ResidentEngine(qmx[1], port_wdata, device="cpu"),
                      JaxResidentEngine(qmx[0], wdata), qmx[1]),
    }
    for name, (port, ref, port_index) in engines.items():
        ref._ensure_norm_cache()
        words = np.asarray(ref.docs_words)
        state = resident_state_from_arrays(
            words, words, np.asarray(ref.tiles_docs), np.asarray(ref.tiles_freqs),
            np.asarray(ref.norm_den), den_blocks=np.asarray(ref.den_blocks),
            tile_gblk0=np.asarray(ref.tile_gblk0), device="cpu",
        )
        assert state.freqs_words is state.docs_words
        eng = ResidentEngine.from_state(port_index, state)
        assert eng.ranked_and(queries) == port.ranked_and(queries), name
        assert eng.ranked_or(queries) == port.ranked_or(queries), name
        np.testing.assert_array_equal(eng.or_counts(queries), port.or_counts(queries))
        with pytest.raises(ValueError, match="does not belong"):
            ResidentEngine.from_state(setup["block_interpolative"][4], state)
    assert any(st[0] == "qmx" for st in engines["block_qmx"][0].group_statics_d)


@pytest.mark.parametrize("name", ["opt", "block_optpfor", "block_mixed"])
def test_foreign_index_raises(setup, coll, name):
    """An index built by ds2i_tpu, whatever its type, is refused with its
    own message: the port's engine serves only its own package's indexes."""
    if name == "block_mixed":
        index = setup["block_optpfor"][0]
        nb = sum(len(index.get_blocks(li)) for li in range(index.size()))
        index = rebuild_mixed(index, np.zeros(2 * nb, np.uint8), np.full(2 * nb, 10, np.uint8))
    elif name == "opt":
        index = build_index(coll, name, "ref")
    else:
        index = setup[name][0]
    assert type(index).__module__.startswith("ds2i_tpu.")
    with pytest.raises(TypeError, match="serves indexes built by ds2i_torch"):
        ResidentEngine(index, device="cpu")


def test_no_card_is_an_error(setup, monkeypatch):
    """device=None means CUDA: without a card the engine raises, never
    serving from the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, _, port_index = setup["block_optpfor"]
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentEngine(port_index)
