"""Per-sequence codec selectors and the positive-sequence wrapper.

- IndexedSequence: picks min-bitsize among {EF, ranked bitvector, all-ones},
  writing 1 type bit unless all-ones is implicit (indexed_sequence.hpp:12-87).
- StrictSequence: same selection for strictly-increasing sequences using
  strict EF, with zero-indexing disabled (ef_log_sampling0 = 63,
  rb_log_rank1_sampling = 63 — strict_sequence.hpp:24-30).
- PositiveSequence: stores positive ints (frequencies) as the strictly
  monotone prefix sum, encoded with a strict base (positive_sequence.hpp).
"""

import dataclasses

import numpy as np

from .base import Enumerator, INF_BITS
from .ef import AllOnesSequence, CompactEliasFano, CompactRankedBitvector, StrictEliasFano

_U64 = np.uint64

ELIAS_FANO = 0
RANKED_BITVECTOR = 1
ALL_ONES = 2
TYPE_BITS = 1  # all_ones is implicit


class IndexedSequence:
    @staticmethod
    def _best(params, universe, n):
        best_cost = AllOnesSequence.bitsize(params, universe, n)
        best_type = ALL_ONES
        ef_cost = CompactEliasFano.bitsize(params, universe, n) + TYPE_BITS
        if ef_cost < best_cost:
            best_cost, best_type = ef_cost, ELIAS_FANO
        rb_cost = CompactRankedBitvector.bitsize(params, universe, n) + TYPE_BITS
        if rb_cost < best_cost:
            best_cost, best_type = rb_cost, RANKED_BITVECTOR
        return best_cost, best_type

    @staticmethod
    def bitsize(params, universe, n):
        return IndexedSequence._best(params, universe, n)[0]

    @staticmethod
    def write(bvb, values, universe, n, params):
        best_cost, best_type = IndexedSequence._best(params, universe, n)
        if AllOnesSequence.bitsize(params, universe, n) != 0:
            bvb.append_bits(best_type, TYPE_BITS)
        if best_type == ELIAS_FANO:
            CompactEliasFano.write(bvb, values, universe, n, params)
        elif best_type == RANKED_BITVECTOR:
            CompactRankedBitvector.write(bvb, values, universe, n, params)
        else:
            AllOnesSequence.write(bvb, values, universe, n, params)

    @staticmethod
    def decode(bv, offset, universe, n, params):
        if AllOnesSequence.bitsize(params, universe, n) == 0:
            return AllOnesSequence.decode(bv, offset + TYPE_BITS, universe, n, params)
        t = bv.get_bits(offset, TYPE_BITS)
        if t == ELIAS_FANO:
            return CompactEliasFano.decode(bv, offset + TYPE_BITS, universe, n, params)
        return CompactRankedBitvector.decode(bv, offset + TYPE_BITS, universe, n, params)

    @staticmethod
    def enumerator(bv, offset, universe, n, params):
        return Enumerator(IndexedSequence.decode(bv, offset, universe, n, params), universe)


def strict_params(params):
    # zeros need not be indexed for strict sequences
    return dataclasses.replace(params, ef_log_sampling0=63, rb_log_rank1_sampling=63)


class StrictSequence:
    @staticmethod
    def _best(params, universe, n):
        sparams = strict_params(params)
        best_cost = AllOnesSequence.bitsize(params, universe, n)
        best_type = ALL_ONES
        ef_cost = StrictEliasFano.bitsize(sparams, universe, n) + TYPE_BITS
        if ef_cost < best_cost:
            best_cost, best_type = ef_cost, ELIAS_FANO
        rb_cost = CompactRankedBitvector.bitsize(sparams, universe, n) + TYPE_BITS
        if rb_cost < best_cost:
            best_cost, best_type = rb_cost, RANKED_BITVECTOR
        return best_cost, best_type

    @staticmethod
    def bitsize(params, universe, n):
        return StrictSequence._best(params, universe, n)[0]

    @staticmethod
    def write(bvb, values, universe, n, params):
        sparams = strict_params(params)
        best_cost, best_type = StrictSequence._best(params, universe, n)
        if AllOnesSequence.bitsize(params, universe, n) != 0:
            bvb.append_bits(best_type, TYPE_BITS)
        if best_type == ELIAS_FANO:
            StrictEliasFano.write(bvb, values, universe, n, sparams)
        elif best_type == RANKED_BITVECTOR:
            CompactRankedBitvector.write(bvb, values, universe, n, sparams)
        else:
            AllOnesSequence.write(bvb, values, universe, n, sparams)

    @staticmethod
    def decode(bv, offset, universe, n, params):
        sparams = strict_params(params)
        if AllOnesSequence.bitsize(params, universe, n) == 0:
            return AllOnesSequence.decode(bv, offset + TYPE_BITS, universe, n, sparams)
        t = bv.get_bits(offset, TYPE_BITS)
        if t == ELIAS_FANO:
            return StrictEliasFano.decode(bv, offset + TYPE_BITS, universe, n, sparams)
        return CompactRankedBitvector.decode(bv, offset + TYPE_BITS, universe, n, sparams)

    @staticmethod
    def enumerator(bv, offset, universe, n, params):
        return Enumerator(StrictSequence.decode(bv, offset, universe, n, params), universe)


class PositiveEnumerator:
    """positive_sequence enumerator: move(i) returns the i-th positive value
    (the gap of the underlying strict prefix-sum sequence); exposes base()."""

    __slots__ = ("_gaps", "_base")

    def __init__(self, gaps, base_enum):
        self._gaps = gaps
        self._base = base_enum

    def move(self, position):
        return (int(position), int(self._gaps[position]))

    def base(self):
        return self._base


class PositiveSequence:
    """Base sequence defaults to StrictSequence (positive_sequence.hpp:11)."""

    base_sequence_type = StrictSequence

    @classmethod
    def write(cls, bvb, values, universe, n, params):
        assert n > 0
        v = np.asarray(values, dtype=_U64)
        assert np.all(v > 0), "positive_sequence requires positive values"
        cum = np.cumsum(v, dtype=_U64)
        cls.base_sequence_type.write(bvb, cum, universe, n, params)

    @classmethod
    def decode(cls, bv, offset, universe, n, params):
        cum = cls.base_sequence_type.decode(bv, offset, universe, n, params)
        return np.diff(cum, prepend=_U64(0))

    @classmethod
    def enumerator(cls, bv, offset, universe, n, params):
        cum = cls.base_sequence_type.decode(bv, offset, universe, n, params)
        gaps = np.diff(cum, prepend=_U64(0))
        return PositiveEnumerator(gaps, Enumerator(cum, universe))


_positive_cache = {}


def make_positive_sequence(base):
    """positive_sequence<Base> — e.g. make_positive_sequence(StrictEliasFano)
    for the `ef` index's freq streams (index_types.hpp:18-19)."""
    if base not in _positive_cache:
        _positive_cache[base] = type(
            f"PositiveSequence_{base.__name__}", (PositiveSequence,), {"base_sequence_type": base}
        )
    return _positive_cache[base]
