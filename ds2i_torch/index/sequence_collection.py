"""Standalone collection of sequences (sequence_collection.hpp) — not
doc/freq pairs; used for generic sequence storage and tests. Per-sequence
header: gamma(universe_bits) + gamma(n), with the universe rounded up to
2^universe_bits + 1 (sequence_collection.hpp:59-69)."""

import numpy as np

from ..bitvec import BitReader, read_gamma, write_gamma
from ..bitvec.bitvector import ceil_log2
from ..global_params import GlobalParameters
from .bitvector_collection import BitvectorCollection


class SequenceCollection:
    """Parameterized by a sequence type (e.g. IndexedSequence)."""

    def __init__(self, sequence_type, params, sequences):
        self.sequence_type = sequence_type
        self.params = params
        self.sequences = sequences

    class Builder:
        def __init__(self, sequence_type, params):
            self.sequence_type = sequence_type
            self.params = params
            self.builder = BitvectorCollection.Builder(params)

        def add_sequence(self, values, universe):
            from ..bitvec import BitVectorBuilder

            values = np.asarray(values, dtype=np.uint64)
            n = len(values)
            universe_bits = ceil_log2(universe)
            bvb = BitVectorBuilder()
            write_gamma(bvb, universe_bits)
            write_gamma(bvb, n)
            # round up universe to a 2^k + 1 so the header is compact
            self.sequence_type.write(bvb, values, (1 << universe_bits) + 1, n, self.params)
            self.builder.append(bvb)

        def build(self):
            return SequenceCollection(self.sequence_type, self.params, self.builder.build())

    @classmethod
    def builder(cls, sequence_type, params=None):
        return cls.Builder(sequence_type, params or GlobalParameters())

    def size(self):
        return self.sequences.size()

    def decode(self, i):
        r = BitReader(self.sequences.bits(), self.sequences.get_offset(i))
        universe_bits = read_gamma(r)
        n = read_gamma(r)
        return self.sequence_type.decode(
            self.sequences.bits(), r.position(), (1 << universe_bits) + 1, n, self.params
        )

    def enumerator(self, i):
        r = BitReader(self.sequences.bits(), self.sequences.get_offset(i))
        universe_bits = read_gamma(r)
        n = read_gamma(r)
        return self.sequence_type.enumerator(
            self.sequences.bits(), r.position(), (1 << universe_bits) + 1, n, self.params
        )

    def tree(self):
        return {"m_sequences": self.sequences.tree()}

    @classmethod
    def from_tree(cls, sequence_type, t, params=None):
        params = params or GlobalParameters()
        return cls(
            sequence_type, params, BitvectorCollection.from_tree(t["m_sequences"], params)
        )
