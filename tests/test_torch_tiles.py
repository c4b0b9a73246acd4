"""The port's host copies (ds2i_torch.engine.tiles, tiles_fast,
ds2i_torch.ops.segments) must build exactly the JAX package's tile
tables."""

import numpy as np
import pytest

import ds2i_tpu.engine.tiles as jax_tiles
import ds2i_tpu.ops.segments as jax_segments
from ds2i_tpu import GlobalParameters
from ds2i_tpu.engine.tiles_fast import build_tile_tables_ef as jax_build_ef
from ds2i_tpu.index.types import make_index_type
from ds2i_tpu.io import BinaryFreqCollection, generate_collection

import ds2i_torch.engine.tiles as torch_tiles
import ds2i_torch.ops.segments as torch_segments

_TABLE_FIELDS = ("docs", "freqs", "tile_list", "list_tile_start", "win_words", "lb_words")


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


def build(coll_base, name):
    c = BinaryFreqCollection(coll_base)
    b = make_index_type(name).builder(c.num_docs, GlobalParameters())
    for docs, freqs in c:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
    return b.build()


def _assert_tables_equal(got, exp):
    for f in _TABLE_FIELDS:
        g, e = getattr(got, f), getattr(exp, f)
        assert g.dtype == e.dtype, f
        np.testing.assert_array_equal(g, e, err_msg=f)


def test_constants_match():
    for name in ("TILE", "N_FIELDS", "F_KIND", "F_WIN_WORD0", "F_WIN_BITOFF", "F_WIN_LEN",
                 "F_SEL_ADJ", "F_LOWER_BITS", "F_LB_WORD0", "F_LB_BITOFF", "F_BASE",
                 "F_NVALS", "F_PREV_CUM"):
        assert getattr(torch_tiles, name) == getattr(jax_tiles, name), name
    for name in ("SEG_EF", "SEG_EF_STRICT", "SEG_RB", "SEG_AO"):
        assert getattr(torch_segments, name) == getattr(jax_segments, name), name


@pytest.mark.parametrize("name", ["ef", "single", "uniform", "opt"])
def test_tile_tables_match_jax(coll, name):
    index = build(coll, name)
    _assert_tables_equal(torch_tiles.build_tile_tables(index), jax_tiles.build_tile_tables(index))


def test_generic_walk_matches_jax_fast_path_on_ef(coll, monkeypatch):
    """The copied generic per-list walk, forced on a plain `ef` index,
    equals the JAX package's vectorized fast path."""
    index = build(coll, "ef")
    exp = jax_build_ef(index)
    import ds2i_tpu.index.types as types_mod

    monkeypatch.setattr(types_mod, "is_plain_ef_index", lambda _: False)
    _assert_tables_equal(torch_tiles.build_tile_tables(index), exp)


def test_segment_tables_match_jax(coll):
    """sequence_segments of the copy equals the original, list by list,
    on the partitioned `opt` index (every segment kind)."""
    index = build(coll, "opt")
    bv = index.docs_sequences.bits()
    got, exp = torch_segments.SegmentTable(), jax_segments.SegmentTable()
    for i in range(0, index.size(), 7):
        _, n, off = index._header(i)
        for mod, table in ((torch_segments, got), (jax_segments, exp)):
            mod.sequence_segments(index.docs_sequence_type, bv, off, index.num_docs(), n,
                                  index.params, table, list_id=i)
    assert set(got.kind) == {torch_segments.SEG_EF, torch_segments.SEG_RB, torch_segments.SEG_AO}
    for k, v in exp.arrays().items():
        np.testing.assert_array_equal(got.arrays()[k], v, err_msg=k)
