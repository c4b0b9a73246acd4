"""The port's host copies (ds2i_torch.engine.tiles, tiles_fast,
ds2i_torch.ops.segments), over the port's own index, must build exactly
the JAX package's tile tables over the JAX package's index of the same
collection."""

import numpy as np
import pytest

import ds2i_tpu.engine.tiles as jax_tiles
import ds2i_tpu.ops.segments as jax_segments
from ds2i_tpu.engine.tiles_fast import build_tile_tables_ef as jax_build_ef
from ds2i_tpu.io import generate_collection

import ds2i_torch.engine.tiles as torch_tiles
import ds2i_torch.index.types as port_types
import ds2i_torch.ops.segments as torch_segments

from test_torch_host_copy import build_index

_TABLE_FIELDS = ("docs", "freqs", "tile_list", "list_tile_start", "win_words", "lb_words")


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


def build(coll_base, name):
    """(JAX package's index, the port's index) of one collection."""
    return build_index(coll_base, name, "ref"), build_index(coll_base, name, "port")


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
    ref, port = build(coll, name)
    _assert_tables_equal(torch_tiles.build_tile_tables(port), jax_tiles.build_tile_tables(ref))


def test_generic_walk_matches_jax_fast_path_on_ef(coll, monkeypatch):
    """The copied generic per-list walk, forced on a plain `ef` index,
    equals the JAX package's vectorized fast path."""
    ref, port = build(coll, "ef")
    exp = jax_build_ef(ref)
    monkeypatch.setattr(port_types, "is_plain_ef_index", lambda _: False)
    _assert_tables_equal(torch_tiles.build_tile_tables(port), exp)


def test_segment_tables_match_jax(coll):
    """sequence_segments of the copy equals the original, list by list,
    on the partitioned `opt` index (every segment kind)."""
    ref, port = build(coll, "opt")
    got, exp = torch_segments.SegmentTable(), jax_segments.SegmentTable()
    for i in range(0, ref.size(), 7):
        for mod, index, table in ((torch_segments, port, got), (jax_segments, ref, exp)):
            _, n, off = index._header(i)
            mod.sequence_segments(index.docs_sequence_type, index.docs_sequences.bits(), off,
                                  index.num_docs(), n, index.params, table, list_id=i)
    assert set(got.kind) == {torch_segments.SEG_EF, torch_segments.SEG_RB, torch_segments.SEG_AO}
    for k, v in exp.arrays().items():
        np.testing.assert_array_equal(got.arrays()[k], v, err_msg=k)
