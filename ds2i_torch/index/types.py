"""Index-type registry (index_types.hpp:18-42).

EF-family types (block types are registered by ds2i_torch.index.block_index
when it is imported):

  ef      = freq_index<compact_elias_fano, positive<strict_elias_fano>>
  single  = freq_index<indexed_sequence,   positive<strict_sequence>>
  uniform = freq_index<uniform_partitioned<indexed>, positive<uniform_partitioned<strict>>>
  opt     = freq_index<partitioned<indexed>, positive<partitioned<strict>>>
"""

from ..sequences import (
    CompactEliasFano,
    IndexedSequence,
    PartitionedSequence,
    PartitionedSequenceStrict,
    StrictEliasFano,
    StrictSequence,
    UniformPartitionedSequence,
    UniformPartitionedSequenceStrict,
    make_positive_sequence,
)
from .freq_index import FreqIndex

INDEX_TYPES = {}


def _register(name, docs_seq, freqs_base):
    cls = type(
        f"FreqIndex_{name}",
        (FreqIndex,),
        {
            "index_type_name": name,
            "docs_sequence_type": docs_seq,
            "freqs_sequence_type": make_positive_sequence(freqs_base),
        },
    )
    INDEX_TYPES[name] = cls
    return cls


EFIndex = _register("ef", CompactEliasFano, StrictEliasFano)
SingleIndex = _register("single", IndexedSequence, StrictSequence)
UniformIndex = _register("uniform", UniformPartitionedSequence, UniformPartitionedSequenceStrict)
OptIndex = _register("opt", PartitionedSequence, PartitionedSequenceStrict)


def make_index_type(name):
    if name not in INDEX_TYPES and name.startswith("block_"):
        from . import block_index  # noqa: F401  registers block types
    return INDEX_TYPES[name]


def is_plain_ef_index(index):
    """True for freq_index<compact_elias_fano, positive<strict_elias_fano>>
    instances — the compositions with exactly one EF segment per stream."""
    from ..sequences.ef import CompactEliasFano, StrictEliasFano
    from ..sequences.selectors import PositiveSequence

    d = getattr(index, "docs_sequence_type", None)
    f = getattr(index, "freqs_sequence_type", None)
    return (
        d is CompactEliasFano
        and isinstance(f, type)
        and issubclass(f, PositiveSequence)
        and f.base_sequence_type is StrictEliasFano
    )
