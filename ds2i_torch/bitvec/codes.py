"""Gamma/delta integer codes over the bit substrate.

Same codes as the reference (integer_codes.hpp:6-45):
  gamma(n): nn = n+1, l = msb(nn); emit (1 << l) | ... as l+1 bits
            (so the l low bits of that field are zeros and the top bit is 1),
            then the remaining l bits of nn (nn ^ 2^l).
  delta(n): nn = n+1, l = msb(nn); gamma(l) then l bits of nn ^ 2^l.

Note the reference's bit order: append_bits writes LSB-first, so the "unary"
l zeros of gamma are read back with skip_zeros then take(l).
"""

from .bitvector import msb


def gamma_bitsize(n):
    l = msb(n + 1)
    return 2 * l + 1


def delta_bitsize(n):
    l = msb(n + 1)
    return gamma_bitsize(l) + l


def write_gamma(bvb, n):
    n = int(n)
    nn = n + 1
    l = msb(nn)
    hb = 1 << l
    bvb.append_bits(hb, l + 1)
    bvb.append_bits(nn ^ hb, l)


def write_gamma_nonzero(bvb, n):
    assert n > 0
    write_gamma(bvb, n - 1)


def read_gamma(reader):
    l = reader.skip_zeros()
    return (reader.take(l) | (1 << l)) - 1


def read_gamma_nonzero(reader):
    return read_gamma(reader) + 1


def write_delta(bvb, n):
    n = int(n)
    nn = n + 1
    l = msb(nn)
    hb = 1 << l
    write_gamma(bvb, l)
    bvb.append_bits(nn ^ hb, l)


def read_delta(reader):
    l = read_gamma(reader)
    return (reader.take(l) | (1 << l)) - 1
