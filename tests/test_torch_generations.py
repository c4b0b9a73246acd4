"""The port's three earlier engine generations (ds2i_torch.engine
QueryEngine, FlatQueryEngine and TileQueryEngine) and its DeviceIndex
against the JAX package's and the numpy oracle, on the CPU (the plain
PyTorch path): the mirror of tests/test_engine.py:45-103.

  - DeviceIndex.decode_docs and decode_freq_cums equal to the JAX
    DeviceIndex's on every list of the four EF-family index types;
  - boolean AND/OR counts exact against the oracle and the JAX engine of
    the same generation, on ef, single, uniform and opt;
  - ranked top-10 within rtol 1e-3 of the oracle and of the JAX engine on
    ef and opt, and with a duplicate query term;
  - each engine refuses an index the port did not build.

Each engine gets an index built by its own package
(test_torch_host_copy.build_index). Serial time ~60 s on the CPU, most
of it the JAX engines' compiles."""

import gc

import jax
import numpy as np
import pytest

import ds2i_tpu.engine as jax_engine
from ds2i_tpu.io import generate_collection

from ds2i_torch.engine import DeviceIndex, FlatQueryEngine, QueryEngine, TileQueryEngine
from ds2i_torch.host import (
    and_query, or_query, ranked_and_query, ranked_or_query, read_queries,
)

from test_torch_host_copy import build_index, build_wdata

ENGINES = ["QueryEngine", "FlatQueryEngine", "TileQueryEngine"]
PORT = {"QueryEngine": QueryEngine, "FlatQueryEngine": FlatQueryEngine,
        "TileQueryEngine": TileQueryEngine}


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release the JAX executables each test compiled before the next one
    (the fixture of tests/test_wand_device.py)."""
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
def built(coll):
    """(name, pkg) -> index, built once a module."""
    cache = {}

    def get(name, pkg):
        if (name, pkg) not in cache:
            cache[name, pkg] = build_index(coll, name, pkg)
        return cache[name, pkg]

    return get


def _engines(built, coll, name, cls, ranked):
    port_w = build_wdata(coll, "port") if ranked else None
    ref_w = build_wdata(coll, "ref") if ranked else None
    port = PORT[cls](built(name, "port"), port_w, device="cpu")
    ref = getattr(jax_engine, cls)(built(name, "ref"), ref_w)
    return port, ref, port_w


def _close(got, exp, q):
    assert len(got) == len(exp), q
    if exp:
        np.testing.assert_allclose(got, exp, rtol=1e-3, err_msg=f"q={q}")


@pytest.mark.parametrize("name", ["ef", "single", "uniform", "opt"])
def test_device_index_decode_equals_jax(built, name):
    port = DeviceIndex(built(name, "port"), device="cpu")
    ref = jax_engine.DeviceIndex(built(name, "ref"))
    np.testing.assert_array_equal(port.list_n, ref.list_n)
    lists = np.arange(port.num_lists)
    for i in range(0, len(lists), 1000):
        ids = lists[i:i + 1000]
        L = 1 << int(np.ceil(np.log2(max(2, port.max_list_len(ids)))))
        for fn in ("decode_docs", "decode_freq_cums"):
            got = getattr(port, fn)(ids, L)
            assert got.dtype.is_floating_point is False and got.shape == (len(ids), L)
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, fn)(ids, L)),
                                          err_msg=fn)


@pytest.mark.parametrize("cls", ENGINES)
@pytest.mark.parametrize("name", ["ef", "opt", "single", "uniform"])
def test_boolean_counts_match_oracle_and_jax(coll, built, name, cls):
    port, ref, _ = _engines(built, coll, name, cls, ranked=False)
    index = built(name, "port")
    queries = read_queries(coll + ".queries")[:40]
    got_and, got_or = port.and_counts(queries), port.or_counts(queries)
    np.testing.assert_array_equal(got_and, ref.and_counts(queries))
    np.testing.assert_array_equal(got_or, ref.or_counts(queries))
    for i, terms in enumerate(queries):
        assert got_and[i] == and_query(index, terms), f"AND mismatch q={terms}"
        assert got_or[i] == or_query(index, terms), f"OR mismatch q={terms}"


@pytest.mark.parametrize("cls", ENGINES)
@pytest.mark.parametrize("name", ["ef", "opt"])
def test_ranked_matches_oracle_and_jax(coll, built, name, cls):
    port, ref, wdata = _engines(built, coll, name, cls, ranked=True)
    index = built(name, "port")
    queries = read_queries(coll + ".queries")[:30]
    got_or, got_and = port.ranked_or(queries, k=10), port.ranked_and(queries, k=10)
    ref_or, ref_and = ref.ranked_or(queries, k=10), ref.ranked_and(queries, k=10)
    for i, terms in enumerate(queries):
        _close(got_or[i], ranked_or_query(index, wdata, terms, k=10), terms)
        _close(got_and[i], ranked_and_query(index, wdata, terms, k=10), terms)
        _close(got_or[i], ref_or[i], terms)
        _close(got_and[i], ref_and[i], terms)
    assert port.wand(queries[:5]) == got_or[:5] and port.maxscore(queries[:5]) == got_or[:5]


@pytest.mark.parametrize("cls", ENGINES)
def test_duplicate_terms(coll, built, cls):
    port, ref, wdata = _engines(built, coll, "ef", cls, ranked=True)
    (r1,) = port.ranked_or([[5, 5]], k=10)
    np.testing.assert_allclose(r1, ranked_or_query(built("ef", "port"), wdata, [5, 5], k=10),
                               rtol=1e-3)
    np.testing.assert_allclose(r1, ref.ranked_or([[5, 5]], k=10)[0], rtol=1e-3)


def test_engines_share_a_device_index_and_refuse_a_foreign_one(coll, built):
    dindex = DeviceIndex(built("opt", "port"), device="cpu")
    queries = read_queries(coll + ".queries")[:20]
    counts = [PORT[c](dindex).and_counts(queries) for c in ENGINES]
    for c in counts[1:]:
        np.testing.assert_array_equal(c, counts[0])
    for cls in (DeviceIndex, *PORT.values()):
        with pytest.raises(TypeError, match="built by ds2i_torch"):
            cls(built("opt", "ref"), device="cpu")
