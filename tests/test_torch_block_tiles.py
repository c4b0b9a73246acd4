"""The port's host copy ds2i_torch.engine.block_tiles, over the port's
own index, must build exactly the JAX package's block tile tables, group
statics, gids and exception patch words over the JAX package's index of
the same collection, through the native walk and through the Python
walk."""

import numpy as np
import pytest

import ds2i_tpu.engine.block_tiles as jax_bt
import ds2i_tpu.native as native
from ds2i_tpu.io import generate_collection

import ds2i_torch.engine.block_tiles as torch_bt
import ds2i_torch.native as port_native

from test_torch_host_copy import assert_same_walk, build_index

_TABLE_FIELDS = ("docs", "freqs", "tile_list", "list_tile_start", "win_words", "lb_words")


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


@pytest.fixture(scope="module")
def indexes(coll):
    """name -> (JAX package's index, the port's index)."""
    assert_same_walk()
    return {name: (build_index(coll, name, "ref"), build_index(coll, name, "port"))
            for name in ("block_optpfor", "block_interpolative")}


def _words(index):
    data = np.asarray(index.lists, dtype=np.uint8)
    return np.concatenate([data, np.zeros((-len(data)) % 4 + 8, np.uint8)]).view("<u4")


def _assert_built_equal(got, exp):
    (gt, gsd, ggd, gsf, ggf), (et, esd, egd, esf, egf) = got, exp
    for f in _TABLE_FIELDS:
        g, e = getattr(gt, f), getattr(et, f)
        assert g.dtype == e.dtype, f
        np.testing.assert_array_equal(g, e, err_msg=f)
    assert gsd == esd and gsf == esf
    np.testing.assert_array_equal(ggd, egd)
    np.testing.assert_array_equal(ggf, egf)


def test_constants_match():
    for name in ("KIND_OPT", "KIND_INTERP", "KIND_VAR", "KIND_QMX", "BF_W0", "BF_B", "BF_NEX",
                 "BF_EX_W0", "BF_BOFF", "BF_EX_BOFF", "BF_EX_BASE", "_E_BUCKETS", "_NC_BUCKETS",
                 "_WIN_BUCKETS", "_G_BUCKETS", "_NW_BUCKETS", "_S_BUCKETS", "_MODE_COUNT"):
        assert getattr(torch_bt, name) == getattr(jax_bt, name), name


@pytest.mark.parametrize("walk", ["native", "python"])
@pytest.mark.parametrize("name", ["block_optpfor", "block_interpolative"])
def test_block_tables_match_jax(indexes, name, walk, monkeypatch):
    """Tables, statics and gids; the Python walk is taken in both packages
    when the native builder is unavailable."""
    if walk == "python":
        for mod in (native, port_native):
            monkeypatch.setattr(mod, "block_tables_native", lambda *a, **k: None)
    ref, port = indexes[name]
    got, exp = torch_bt.build_block_tables(port), jax_bt.build_block_tables(ref)
    _assert_built_equal(got, exp)
    kinds = {s[0] for s in got[1] + got[3]}
    assert kinds == ({"opt", "interp"} if name == "block_optpfor" else {"interp"})


@pytest.mark.parametrize("walk", ["native", "python"])
def test_exception_patches_match_jax(indexes, walk, monkeypatch):
    if walk == "python":
        for mod in (native, port_native):
            monkeypatch.setattr(mod, "s16_exception_patches_native", lambda *a, **k: None)
    ref, port = indexes["block_optpfor"]
    t, pt = jax_bt.build_block_tables(ref)[0], torch_bt.build_block_tables(port)[0]
    got_patch, got_bases = torch_bt.build_exception_patches(_words(port), [pt.docs, pt.freqs])
    exp_patch, exp_bases = jax_bt.build_exception_patches(_words(ref), [t.docs, t.freqs])
    assert got_patch.dtype == exp_patch.dtype
    assert len(got_patch) > 0
    np.testing.assert_array_equal(got_patch, exp_patch)
    for g, e in zip(got_bases, exp_bases):
        np.testing.assert_array_equal(g, e)
