from .base import Enumerator, INF_BITS
from .ef import CompactEliasFano, CompactRankedBitvector, AllOnesSequence, StrictEliasFano
from .selectors import IndexedSequence, StrictSequence, PositiveSequence
from .partitioned import (
    optimal_partition,
    PartitionedSequence,
    PartitionedSequenceStrict,
    UniformPartitionedSequence,
    UniformPartitionedSequenceStrict,
)
from .selectors import make_positive_sequence

