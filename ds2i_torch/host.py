"""The host-side (numpy and C++) layers of the port, in one place.

Collection IO, index construction (with rebuild_mixed, which re-encodes
a block index into block_mixed, and mixed_choices, a seeded choice of
its codecs), BM25 wand data and the cursor oracle
are the port's own copies of ds2i_tpu's (ds2i_torch.{io, index, queries,
global_params, ...}; tests/test_torch_host_copy.py pins them to the
originals, tests/test_torch_nojax.py shows the port imports neither JAX
nor ds2i_tpu). They are re-exported here so the port's entry points
(chip_smoke.py) name one module.
"""

from .global_params import GlobalParameters
from .index.hybrid import mixed_choices, rebuild_mixed
from .index.types import make_index_type
from .io import BinaryFreqCollection, generate_collection, read_sizes
from .queries import (
    WandData, and_query, or_query, ranked_and_query, ranked_or_query, read_queries,
)

__all__ = [
    "BinaryFreqCollection", "GlobalParameters", "WandData", "and_query",
    "generate_collection", "make_index_type", "mixed_choices", "or_query",
    "ranked_and_query", "ranked_or_query", "read_queries", "read_sizes", "rebuild_mixed",
]
