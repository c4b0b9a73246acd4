"""Every part of a several-part plan over block_varint, block_qmx and
block_mixed: the port's split_decode_part_torch (and its CPU wrapper)
against the JAX engine's _decode_part, ranked (docs32 exactly, BM25 w32
bit for bit) and boolean (presence weights), each engine over an index of
its own package. The kernels' inputs, the all-tiles part and the launches
are in tests/test_torch_block_codecs.py. About 90 s serially on the build
host's CPU (one JAX compile per part and mode)."""

import gc

import jax
import pytest

from ds2i_tpu.io import generate_collection

from test_torch_block_codecs import NEW_TYPES
from test_torch_split_decode import build_engines, check_part_decode_equals_jax


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
def engines(coll):
    return build_engines(coll, NEW_TYPES)


@pytest.mark.parametrize("ranked", [True, False])
@pytest.mark.parametrize("name", NEW_TYPES)
def test_part_decode_equals_jax_decode_part(engines, name, ranked):
    check_part_decode_equals_jax(*engines[name], ranked)
