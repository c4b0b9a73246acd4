"""Elias-Fano family: compact EF, ranked bitvector, all-ones, strict EF.

Bit layouts are identical to the reference so bits-per-posting matches:

compact_elias_fano (compact_elias_fano.hpp:14-136):
  lower_bits l = msb(universe/n) if universe > n else 0
  layout: [pointers0][pointers1][higher_bits][lower_bits]
    higher_bits: length n + (universe >> l) + 2, bit set at (v>>l) + i + 1
    pointers0[k-1] = position of the (k << log_sampling0)-th zero (k>=1)
    pointers1[k-1] = position of the one for element i = k << log_sampling1
    (slots whose sampled index falls exactly at the end are left zero,
     matching the reference's strict `<` loop bounds)

compact_ranked_bitvector (compact_ranked_bitvector.hpp:14-115):
  layout: [rank1_samples][pointers1][plain bits of length universe]
    rank1_samples[k-1] = #elements < (k << log_rank1_sampling)
    pointers1[k-1]     = value of element at index k << log_sampling1

Encoding here is fully vectorized (numpy bulk ops on the bit substrate)
instead of the reference's per-element loop — same bits out.
"""

import numpy as np

from ..bitvec.bitvector import ceil_log2, msb
from .base import Enumerator, INF_BITS

_U64 = np.uint64


class EFOffsets:
    __slots__ = (
        "universe", "n", "log_sampling0", "log_sampling1", "lower_bits", "mask",
        "higher_bits_length", "pointer_size", "pointers0", "pointers1",
        "pointers0_offset", "pointers1_offset", "higher_bits_offset",
        "lower_bits_offset", "end",
    )

    def __init__(self, base_offset, universe, n, params):
        universe, n = int(universe), int(n)
        assert n > 0
        self.universe = universe
        self.n = n
        self.log_sampling0 = params.ef_log_sampling0
        self.log_sampling1 = params.ef_log_sampling1
        self.lower_bits = msb(universe // n) if universe > n else 0
        self.mask = (1 << self.lower_bits) - 1
        self.higher_bits_length = n + (universe >> self.lower_bits) + 2
        self.pointer_size = ceil_log2(self.higher_bits_length)
        self.pointers0 = (self.higher_bits_length - n) >> self.log_sampling0
        self.pointers1 = n >> self.log_sampling1
        self.pointers0_offset = base_offset
        self.pointers1_offset = self.pointers0_offset + self.pointers0 * self.pointer_size
        self.higher_bits_offset = self.pointers1_offset + self.pointers1 * self.pointer_size
        self.lower_bits_offset = self.higher_bits_offset + self.higher_bits_length
        self.end = self.lower_bits_offset + n * self.lower_bits


class CompactEliasFano:
    @staticmethod
    def offsets(base_offset, universe, n, params):
        return EFOffsets(base_offset, universe, n, params)

    @staticmethod
    def bitsize(params, universe, n):
        return EFOffsets(0, universe, n, params).end

    @staticmethod
    def write(bvb, values, universe, n, params):
        of = EFOffsets(bvb.size, universe, n, params)
        bvb.zero_extend(of.end - bvb.size)

        v = np.asarray(values, dtype=_U64)
        assert len(v) == of.n
        if of.n > 1 and np.any(np.diff(v.astype(np.int64)) < 0):
            raise ValueError("Sequence is not sorted")
        if np.any(v >= _U64(universe)):
            raise ValueError("Value out of universe bounds")

        l = of.lower_bits
        high = (v >> _U64(l)) + np.arange(1, of.n + 1, dtype=_U64)
        bvb.set_ones(_U64(of.higher_bits_offset) + high)

        if l:
            offs = of.lower_bits_offset + np.arange(of.n, dtype=_U64) * _U64(l)
            bvb.set_fields(offs, v & _U64(of.mask), l)

        if of.pointers1:
            idx = np.arange(1, of.pointers1 + 1, dtype=np.int64) << of.log_sampling1
            keep = idx < of.n
            if np.any(keep):
                slots = np.nonzero(keep)[0]  # slot k-1 for k = slots+1
                offs = of.pointers1_offset + slots.astype(_U64) * _U64(of.pointer_size)
                bvb.set_fields(offs, high[idx[keep]], of.pointer_size)

        if of.pointers0:
            bits = np.zeros(of.higher_bits_length, dtype=bool)
            bits[high] = True
            zpos = np.nonzero(~bits)[0]
            idx = np.arange(1, of.pointers0 + 1, dtype=np.int64) << of.log_sampling0
            keep = idx < len(zpos)
            if np.any(keep):
                slots = np.nonzero(keep)[0]
                offs = of.pointers0_offset + slots.astype(_U64) * _U64(of.pointer_size)
                bvb.set_fields(offs, zpos[idx[keep]].astype(_U64), of.pointer_size)

    @staticmethod
    def decode(bv, offset, universe, n, params):
        of = EFOffsets(offset, universe, n, params)
        ones = bv.select_ones(of.higher_bits_offset, of.higher_bits_offset + of.higher_bits_length)
        ones = ones.astype(_U64) - _U64(of.higher_bits_offset)
        assert len(ones) == of.n, f"corrupt EF: {len(ones)} ones, expected {of.n}"
        vh = ones - np.arange(1, of.n + 1, dtype=_U64)
        l = of.lower_bits
        if l:
            offs = of.lower_bits_offset + np.arange(of.n, dtype=_U64) * _U64(l)
            low = bv.get_fields(offs, l)
            return (vh << _U64(l)) | low
        return vh

    @staticmethod
    def enumerator(bv, offset, universe, n, params):
        return Enumerator(CompactEliasFano.decode(bv, offset, universe, n, params), universe)

    @staticmethod
    def read_pointers(bv, offset, universe, n, params):
        """(pointers0[], pointers1[]) raw arrays — for layout tests."""
        of = EFOffsets(offset, universe, n, params)
        p0 = bv.get_fields(
            of.pointers0_offset + np.arange(of.pointers0, dtype=_U64) * _U64(of.pointer_size),
            of.pointer_size,
        )
        p1 = bv.get_fields(
            of.pointers1_offset + np.arange(of.pointers1, dtype=_U64) * _U64(of.pointer_size),
            of.pointer_size,
        )
        return p0, p1


class RBOffsets:
    __slots__ = (
        "universe", "n", "log_rank1_sampling", "log_sampling1", "rank1_sample_size",
        "pointer_size", "rank1_samples", "pointers1", "rank1_samples_offset",
        "pointers1_offset", "bits_offset", "end",
    )

    def __init__(self, base_offset, universe, n, params):
        universe, n = int(universe), int(n)
        self.universe = universe
        self.n = n
        self.log_rank1_sampling = params.rb_log_rank1_sampling
        self.log_sampling1 = params.rb_log_sampling1
        self.rank1_sample_size = ceil_log2(n + 1)
        self.pointer_size = ceil_log2(universe)
        self.rank1_samples = universe >> self.log_rank1_sampling
        self.pointers1 = n >> self.log_sampling1
        self.rank1_samples_offset = base_offset
        self.pointers1_offset = self.rank1_samples_offset + self.rank1_samples * self.rank1_sample_size
        self.bits_offset = self.pointers1_offset + self.pointers1 * self.pointer_size
        self.end = self.bits_offset + universe


class CompactRankedBitvector:
    @staticmethod
    def offsets(base_offset, universe, n, params):
        return RBOffsets(base_offset, universe, n, params)

    @staticmethod
    def bitsize(params, universe, n):
        return RBOffsets(0, universe, n, params).end

    @staticmethod
    def write(bvb, values, universe, n, params):
        of = RBOffsets(bvb.size, universe, n, params)
        bvb.zero_extend(of.end - bvb.size)

        v = np.asarray(values, dtype=_U64)
        assert len(v) == of.n
        if of.n > 1:
            d = np.diff(v.astype(np.int64))
            if np.any(d == 0):
                raise ValueError("Duplicate element")
            if np.any(d < 0):
                raise ValueError("Sequence is not sorted")
        if np.any(v >= _U64(universe)):
            raise ValueError("Value out of universe bounds")

        bvb.set_ones(_U64(of.bits_offset) + v)

        if of.rank1_samples:
            spos = np.arange(1, of.rank1_samples + 1, dtype=np.int64) << of.log_rank1_sampling
            keep = spos < of.universe
            if np.any(keep):
                slots = np.nonzero(keep)[0]
                ranks = np.searchsorted(v, spos[keep], side="left").astype(_U64)
                offs = of.rank1_samples_offset + slots.astype(_U64) * _U64(of.rank1_sample_size)
                bvb.set_fields(offs, ranks, of.rank1_sample_size)

        if of.pointers1:
            idx = np.arange(1, of.pointers1 + 1, dtype=np.int64) << of.log_sampling1
            keep = idx < of.n
            if np.any(keep):
                slots = np.nonzero(keep)[0]
                offs = of.pointers1_offset + slots.astype(_U64) * _U64(of.pointer_size)
                bvb.set_fields(offs, v[idx[keep]], of.pointer_size)

    @staticmethod
    def decode(bv, offset, universe, n, params):
        of = RBOffsets(offset, universe, n, params)
        ones = bv.select_ones(of.bits_offset, of.bits_offset + of.universe)
        assert len(ones) == of.n, f"corrupt RB: {len(ones)} ones, expected {of.n}"
        return ones.astype(_U64) - _U64(of.bits_offset)

    @staticmethod
    def enumerator(bv, offset, universe, n, params):
        return Enumerator(CompactRankedBitvector.decode(bv, offset, universe, n, params), universe)


class AllOnesSequence:
    """Implicit 0,1,...,n-1 when universe == n (all_ones_sequence.hpp:10-75)."""

    @staticmethod
    def bitsize(params, universe, n):
        return 0 if universe == n else INF_BITS

    @staticmethod
    def write(bvb, values, universe, n, params):
        assert universe == n

    @staticmethod
    def decode(bv, offset, universe, n, params):
        return np.arange(n, dtype=_U64)

    @staticmethod
    def enumerator(bv, offset, universe, n, params):
        return Enumerator(np.arange(n, dtype=_U64), universe)


class StrictEliasFano:
    """EF for strictly increasing sequences: stores v_i - i over universe-n+1
    (strict_elias_fano.hpp:12-62)."""

    @staticmethod
    def bitsize(params, universe, n):
        assert universe >= n
        return CompactEliasFano.bitsize(params, universe - n + 1, n)

    @staticmethod
    def write(bvb, values, universe, n, params):
        v = np.asarray(values, dtype=_U64)
        shifted = v - np.arange(n, dtype=_U64)
        CompactEliasFano.write(bvb, shifted, universe - n + 1, n, params)

    @staticmethod
    def decode(bv, offset, universe, n, params):
        base = CompactEliasFano.decode(bv, offset, universe - n + 1, n, params)
        return base + np.arange(n, dtype=_U64)

    @staticmethod
    def enumerator(bv, offset, universe, n, params):
        return Enumerator(StrictEliasFano.decode(bv, offset, universe, n, params), universe)
