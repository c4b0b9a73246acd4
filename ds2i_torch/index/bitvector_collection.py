"""Concatenated bit-slices with an EF-coded endpoint directory
(bitvector_collection.hpp:12-91)."""

import numpy as np

from ..bitvec import BitVector, BitVectorBuilder
from ..sequences.ef import CompactEliasFano


class BitvectorCollection:
    def __init__(self, size, endpoints_bv, bits_bv, params):
        self._size = size
        self.endpoints_bv = endpoints_bv
        self.bits_bv = bits_bv
        self._params = params
        self._endpoints_cache = None

    class Builder:
        def __init__(self, params):
            self.params = params
            self.endpoints = [0]
            self.bits = BitVectorBuilder()

        def append(self, bvb):
            self.bits.append_builder(bvb)
            self.endpoints.append(self.bits.size)

        def build(self):
            size = len(self.endpoints) - 1
            bits_bv = self.bits.build()
            eb = BitVectorBuilder()
            if size:
                CompactEliasFano.write(
                    eb,
                    np.asarray(self.endpoints[:size], dtype=np.uint64),
                    max(bits_bv.nbits, 1),
                    size,
                    self.params,
                )
            return BitvectorCollection(size, eb.build(), bits_bv, self.params)

    def __len__(self):
        return self._size

    def size(self):
        return self._size

    def bits(self):
        return self.bits_bv

    def endpoints(self):
        """All list start offsets, decoded once (vectorized)."""
        if self._endpoints_cache is None:
            if self._size == 0:
                self._endpoints_cache = np.zeros(0, dtype=np.uint64)
            else:
                self._endpoints_cache = CompactEliasFano.decode(
                    self.endpoints_bv, 0, max(self.bits_bv.nbits, 1), self._size, self._params
                )
        return self._endpoints_cache

    def get_offset(self, i):
        """Bit offset where slice i starts."""
        return int(self.endpoints()[i])

    def tree(self):
        return {
            "m_size": self._size,
            "m_endpoints": self.endpoints_bv.tree(),
            "m_bitvectors": self.bits_bv.tree(),
        }

    @classmethod
    def from_tree(cls, t, params):
        return cls(
            int(t["m_size"]),
            BitVector.from_tree(t["m_endpoints"]),
            BitVector.from_tree(t["m_bitvectors"]),
            params,
        )
