"""ds2i_torch.engine.ResidentEngine (device="cpu", the plain PyTorch
path) against the JAX ResidentEngine and the numpy oracle, each engine
over an index built by its own package from one collection: plan arrays
and the norm cache exactly, boolean counts exactly, top-10 BM25 scores
within rtol 1e-3 (the f16 download rounds at 2^-11, and XLA's f32 divide
is not IEEE)."""

import gc

import jax
import numpy as np
import pytest

from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine
from ds2i_tpu.io import generate_collection
from ds2i_tpu.queries import and_query, or_query, ranked_and_query, ranked_or_query, read_queries

from ds2i_torch.engine import ResidentEngine, resident_state_from_arrays

from test_torch_host_copy import assert_same_walk, build_index, build_wdata

NQ = 24  # queries per check; the JAX interpret-mode engine compiles per layout


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
    """name -> (index, wdata, port engine, JAX pallas-interpret engine,
    port index): each engine over an index of its own package."""
    wdata, port_wdata = build_wdata(coll, "ref"), build_wdata(coll, "port")
    out = {}
    for name in ("ef", "opt"):
        index, port_index = build_index(coll, name, "ref"), build_index(coll, name, "port")
        out[name] = (index, wdata, ResidentEngine(port_index, port_wdata, device="cpu"),
                     JaxResidentEngine(index, wdata, pallas=2), port_index)
    return out


@pytest.fixture(scope="module")
def queries(coll):
    return read_queries(coll + ".queries")[:NQ]


def _plan_arrays(plan):
    """The comparable content of a prepare() plan."""
    out = {"n": plan["n"], "k": plan["k"], "ops": plan["ops"]}
    for pi, p in enumerate(plan["plans"]):
        for key in ("gtile_ids", "gtile_f", "blkperm", "pack_idx"):
            out[f"{pi}.{key}"] = np.asarray(p[key]).tolist()
        for key in ("groups", "groups_f", "fscale", "sent_dir", "k", "ops", "tmax"):
            out[f"{pi}.{key}"] = p[key]
        for bi, b in enumerate(p["buckets"]):
            for key in ("L", "Bb"):
                out[f"{pi}.{bi}.{key}"] = b[key]
            for key in ("rows", "dir", "qwtab", "tgt"):
                out[f"{pi}.{bi}.{key}"] = (np.asarray(b[key]).dtype.str, np.asarray(b[key]).tolist())
    return out


@pytest.fixture(scope="module")
def small_parts(coll):
    """(port engine, JAX engine) over `opt` with small part budgets,
    built once for every plan case."""
    assert_same_walk()
    kw = dict(max_part_slots=1 << 13, max_part_queries=32)
    return (ResidentEngine(build_index(coll, "opt", "port"), build_wdata(coll, "port"),
                           device="cpu", **kw),
            JaxResidentEngine(build_index(coll, "opt", "ref"), build_wdata(coll, "ref"), **kw))


@pytest.mark.parametrize("ops", [("and",), ("or",), ("counts",)])
def test_plan_arrays_match_jax(coll, small_parts, ops):
    """Small part budgets force several parts; every plan array equals the
    JAX engine's (both engines are built with the same budgets)."""
    port, ref = small_parts
    qs = read_queries(coll + ".queries")
    ranked = ops != ("counts",)
    got = port.prepare(qs, k=10, ops=ops, ranked=ranked)
    exp = ref.prepare(qs, k=10, ops=ops, ranked=ranked)
    assert len(got["plans"]) > 1
    assert _plan_arrays(got) == _plan_arrays(exp)


@pytest.mark.parametrize("name", ["ef", "opt"])
def test_norm_cache_matches_jax(setup, name):
    _, _, port, ref, _ = setup[name]
    port._ensure_norm_cache()
    ref._ensure_norm_cache()
    np.testing.assert_array_equal(port.state.den_blocks.numpy(), np.asarray(ref.den_blocks))
    np.testing.assert_array_equal(port.state.tile_gblk0.numpy(), np.asarray(ref.tile_gblk0))


@pytest.mark.parametrize("name", ["ef", "opt"])
def test_counts_match_jax_and_oracle(setup, queries, name):
    index, _, port, ref, _ = setup[name]
    got_and, got_or = port.and_counts(queries), port.or_counts(queries)
    np.testing.assert_array_equal(got_and, ref.and_counts(queries))
    np.testing.assert_array_equal(got_or, ref.or_counts(queries))
    for i, terms in enumerate(queries):
        assert got_and[i] == and_query(index, terms), f"AND q={terms}"
        assert got_or[i] == or_query(index, terms), f"OR q={terms}"


def _assert_topk_close(got, exp, queries):
    for g, e, q in zip(got, exp, queries):
        assert len(g) == len(e), f"q={q}"
        if e:
            np.testing.assert_allclose(g, e, rtol=1e-3, err_msg=f"q={q}")


@pytest.mark.parametrize("name", ["ef", "opt"])
def test_ranked_match_jax_and_oracle(setup, queries, name):
    index, wdata, port, ref, _ = setup[name]
    got_and, got_or = port.ranked_and(queries, k=10), port.ranked_or(queries, k=10)
    _assert_topk_close(got_and, ref.ranked_and(queries, k=10), queries)
    _assert_topk_close(got_or, ref.ranked_or(queries, k=10), queries)
    _assert_topk_close(got_and, [ranked_and_query(index, wdata, q, k=10) for q in queries], queries)
    _assert_topk_close(got_or, [ranked_or_query(index, wdata, q, k=10) for q in queries], queries)


def test_from_state_of_jax_arrays(setup, queries):
    """An engine over the JAX engine's resident arrays (read back as
    numpy, norm cache included) serves the same results."""
    _, _, port, ref, port_index = setup["opt"]
    ref._ensure_norm_cache()
    state = resident_state_from_arrays(
        np.asarray(ref.docs_words), np.asarray(ref.freqs_words),
        np.asarray(ref.tiles_docs), np.asarray(ref.tiles_freqs),
        np.asarray(ref.norm_den), den_blocks=np.asarray(ref.den_blocks),
        tile_gblk0=np.asarray(ref.tile_gblk0), device="cpu",
    )
    eng = ResidentEngine.from_state(port_index, state)
    assert eng.ranked_and(queries) == port.ranked_and(queries)
    assert eng.ranked_or(queries) == port.ranked_or(queries)
    np.testing.assert_array_equal(eng.and_counts(queries), port.and_counts(queries))
    other = setup["ef"][4]
    with pytest.raises(ValueError, match="does not belong"):
        ResidentEngine.from_state(other, state)


@pytest.mark.parametrize("name", ["ef", "opt"])
def test_duplicate_terms(setup, name):
    index, wdata, port, ref, _ = setup[name]
    (got,) = port.ranked_or([[5, 5]], k=10)
    exp = ranked_or_query(index, wdata, [5, 5], k=10)
    np.testing.assert_allclose(got, exp, rtol=1e-3)
    np.testing.assert_allclose(got, ref.ranked_or([[5, 5]], k=10)[0], rtol=1e-3)
    assert port.and_counts([[5, 5]])[0] == and_query(index, [5, 5])

