"""ResidentEngine (device="cpu", the plain PyTorch path) over
block_varint, block_qmx and block_mixed, each engine over an index of its
own package: and/or counts exactly and top-10 ranked_and / ranked_or
within rtol 1e-3 of the JAX engine and the numpy oracle; and_skip
(ranked_and(prune=True) after build_blockmax), wand and maxscore equal to
the exhaustive ops. About 90 s serially on the build host's CPU."""

import gc

import jax
import pytest

from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine
from ds2i_tpu.io import BinaryFreqCollection, generate_collection
from ds2i_tpu.queries import read_queries

from ds2i_torch.engine import ResidentEngine

from test_torch_block_codecs import NEW_TYPES
from test_torch_block_resident import check_counts, check_ranked
from test_torch_host_copy import assert_same_walk, build_index, build_wdata
from test_torch_resident import _assert_topk_close

NQ = 24  # queries per check


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
def served(coll):
    """name -> (index, wdata, port engine, JAX engine, queries), each
    engine over an index of its own package."""
    assert_same_walk()
    qs = read_queries(coll + ".queries")[:NQ]
    wdata, port_wdata = build_wdata(coll, "ref"), build_wdata(coll, "port")
    out = {}
    for name in NEW_TYPES:
        index = build_index(coll, name, "ref")
        out[name] = (index, wdata,
                     ResidentEngine(build_index(coll, name, "port"), port_wdata, device="cpu"),
                     JaxResidentEngine(index, wdata), qs)
    return out


@pytest.mark.parametrize("name", NEW_TYPES)
def test_counts_and_ranked_match_jax_and_oracle(served, name):
    index, wdata, port, ref, qs = served[name]
    check_counts(index, port, ref, qs)
    check_ranked(index, wdata, port, ref, qs)


@pytest.mark.parametrize("name", NEW_TYPES)
def test_pruned_ops_equal_exhaustive(coll, served, name):
    """and_skip (ranked_and(prune=True)) from build_blockmax over the
    collection equals the exhaustive ranked_and; wand and maxscore equal
    ranked_or (equal lengths, rtol 1e-3)."""
    _, _, port, _, qs = served[name]
    port.build_blockmax(BinaryFreqCollection(coll))
    pruned = port.ranked_and(qs, k=10, prune=True)
    _assert_topk_close(pruned, port.ranked_and(qs, k=10), qs)
    assert sum(map(len, pruned)) > 0
    exact = port.ranked_or(qs, k=10)
    for op in ("wand", "maxscore"):
        _assert_topk_close(getattr(port, op)(qs, k=10), exact, qs)
