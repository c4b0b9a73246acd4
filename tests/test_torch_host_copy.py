"""The port's own copies of the host layers (ds2i_torch.{io, index,
queries, native, ...}) against the originals in ds2i_tpu: the same
collection files byte for byte, word-for-word equal indexes of every
index type the port serves, equal decoded lists, equal WandData and
equal oracle answers. The helpers here build one index per package from
one collection; the other port tests use them, so each engine gets an
index of its own package."""

import os

import numpy as np
import pytest

import ds2i_tpu.native as ref_native
from ds2i_tpu import GlobalParameters as RefParams
from ds2i_tpu.index.types import make_index_type as ref_index_type
from ds2i_tpu.io import BinaryFreqCollection as RefCollection
from ds2i_tpu.io import generate_collection as ref_generate
from ds2i_tpu.io import read_sizes as ref_sizes
from ds2i_tpu import queries as ref_queries

import ds2i_torch.native as port_native
from ds2i_torch import host as port_host
from ds2i_torch import queries as port_queries

SERVED_TYPES = ["ef", "single", "uniform", "opt", "block_optpfor", "block_interpolative"]

_PKGS = {
    "ref": (ref_index_type, RefParams, RefCollection, ref_sizes, ref_queries.WandData),
    "port": (port_host.make_index_type, port_host.GlobalParameters,
             port_host.BinaryFreqCollection, port_host.read_sizes, port_host.WandData),
}


def build_index(coll, name, pkg):
    """`name` index of collection `coll`, built by ds2i_tpu (pkg="ref")
    or by the port's copy (pkg="port")."""
    make_type, params, collection, _, _ = _PKGS[pkg]
    c = collection(coll)
    b = make_type(name).builder(c.num_docs, params())
    for docs, freqs in c:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
    return b.build()


def build_wdata(coll, pkg):
    _, _, collection, sizes, wand_data = _PKGS[pkg]
    return wand_data.build(sizes(coll), collection(coll))


def assert_same_walk():
    """Both packages take the same block-table walk (native where the
    library loads, else Python): they number group statics differently,
    so plan arrays compare only within one walk."""
    assert ref_native.available() == port_native.available(), (
        "ds2i_tpu and ds2i_torch take different table walks (one native "
        "library loads, the other does not); their plans are not comparable")


def _assert_tree_equal(got, exp, path="index"):
    if isinstance(exp, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(exp), path
        for key in exp:
            _assert_tree_equal(got[key], exp[key], f"{path}.{key}")
    elif isinstance(exp, (list, tuple)):
        assert len(got) == len(exp), path
        for i, (g, e) in enumerate(zip(got, exp)):
            _assert_tree_equal(g, e, f"{path}[{i}]")
    elif isinstance(exp, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == exp.dtype, path
        np.testing.assert_array_equal(got, exp, err_msg=path)
    else:
        assert got == exp, path


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    ref_generate(base, num_docs=600, num_terms=900, postings_target=20_000,
                 num_queries=40, max_query_len=4)
    return base


def test_generate_collection_is_byte_equal(tmp_path):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(num_docs=300, num_terms=400, postings_target=6_000, num_queries=10, seed=7)
    ref_generate(a, **kw)
    port_host.generate_collection(b, **kw)
    names = sorted(f for f in os.listdir(tmp_path) if f.startswith("ref"))
    assert names
    for f in names:
        with open(tmp_path / f, "rb") as x, open(tmp_path / ("port" + f[3:]), "rb") as y:
            assert x.read() == y.read(), f


@pytest.mark.parametrize("name", SERVED_TYPES)
def test_index_words_and_lists_equal(coll, name):
    assert_same_walk()
    ref, port = build_index(coll, name, "ref"), build_index(coll, name, "port")
    assert type(port).__module__.startswith("ds2i_torch.")
    _assert_tree_equal(port.tree(), ref.tree())
    assert port.size() == ref.size() and port.num_docs() == ref.num_docs()
    for li in range(ref.size()):
        (gd, gf), (ed, ef) = port.decode_list(li), ref.decode_list(li)
        np.testing.assert_array_equal(gd, ed, err_msg=f"docs of list {li}")
        np.testing.assert_array_equal(gf, ef, err_msg=f"freqs of list {li}")


def test_wand_data_equal(coll):
    got, exp = build_wdata(coll, "port"), build_wdata(coll, "ref")
    for key in ("norm_lens", "max_term_weight"):
        g, e = getattr(got, key), getattr(exp, key)
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e, err_msg=key)


@pytest.mark.parametrize("op", ["and_query", "or_query", "ranked_and_query", "ranked_or_query"])
def test_oracle_equal(coll, op):
    ref_idx, port_idx = build_index(coll, "opt", "ref"), build_index(coll, "opt", "port")
    ref_w, port_w = build_wdata(coll, "ref"), build_wdata(coll, "port")
    qs = ref_queries.read_queries(coll + ".queries")
    assert port_queries.read_queries(coll + ".queries") == qs
    for q in qs:
        if op in ("and_query", "or_query"):
            got, exp = getattr(port_queries, op)(port_idx, q), getattr(ref_queries, op)(ref_idx, q)
        else:
            got = getattr(port_queries, op)(port_idx, port_w, q, 10)
            exp = getattr(ref_queries, op)(ref_idx, ref_w, q, 10)
        assert got == exp, (op, q)
