"""The host-side (numpy) layers the port shares with ds2i_tpu.

Collection IO, index construction, BM25 wand data and the cursor oracle
are numpy and C++ code of ds2i_tpu that loads without JAX (tested by
tests/test_torch_nojax.py). They are re-exported here so the port's
entry points (chip_smoke.py) name one package.
"""

from ds2i_tpu.global_params import GlobalParameters
from ds2i_tpu.index.types import make_index_type
from ds2i_tpu.io import BinaryFreqCollection, generate_collection, read_sizes
from ds2i_tpu.queries import (
    WandData, and_query, or_query, ranked_and_query, ranked_or_query, read_queries,
)

__all__ = [
    "BinaryFreqCollection", "GlobalParameters", "WandData", "and_query",
    "generate_collection", "make_index_type", "or_query", "ranked_and_query",
    "ranked_or_query", "read_queries", "read_sizes",
]
