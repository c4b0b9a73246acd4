"""Binary interpolative coding (interpolative_coding.hpp:40-146 semantics):
32-bit little-endian word bit stream; centered minimal binary code
(write_int: b = msb(u), m = 2^(b+1) - u; short codes first); recursive
midpoint order. Used standalone and as the mandatory partial-block codec
for every other block codec (block_codecs.hpp:101-148)."""

import sys

import numpy as np

from .vbyte import TightVariableByte

sys.setrecursionlimit(10000)

UNKNOWN_SUM = 0xFFFFFFFF


class BitWriter32:
    def __init__(self):
        self.words = []
        self.size = 0

    def write(self, bits, length):
        if not length:
            return
        bits = int(bits) & ((1 << length) - 1)
        pos = self.size % 32
        self.size += length
        if pos == 0:
            self.words.append(bits & 0xFFFFFFFF)
        else:
            self.words[-1] |= (bits << pos) & 0xFFFFFFFF
            if length > 32 - pos:
                self.words.append(bits >> (32 - pos))

    def write_int(self, val, u):
        """Centered minimal binary code for val in [0, u)."""
        assert 0 <= val < u
        b = u.bit_length() - 1  # msb(u)
        m = (1 << (b + 1)) - u
        if val < m:
            self.write(val, b)
        else:
            val += m
            self.write(val >> 1, b)
            self.write(val & 1, 1)

    def write_interpolative(self, values, lo_i, hi_i, low, high):
        """Encode values[lo_i:hi_i] with bounds [low, high]."""
        n = hi_i - lo_i
        if n <= 0:
            return
        h = lo_i + n // 2
        val = int(values[h])
        self.write_int(val - low, high - low + 1)
        self.write_interpolative(values, lo_i, h, low, val)
        self.write_interpolative(values, h + 1, hi_i, val, high)

    def tobytes(self):
        return np.asarray(self.words, dtype="<u4").view(np.uint8)[: (self.size + 7) // 8]


class BitReader32:
    def __init__(self, buf, pos=0):
        self.buf = buf  # uint8 array
        self.byte0 = pos
        self.word_idx = 0
        self.avail = 0
        self.acc = 0
        self.pos = 0

    def read(self, length):
        if not length:
            return 0
        while self.avail < length:
            off = self.byte0 + self.word_idx * 4
            w = int.from_bytes(bytes(self.buf[off : off + 4]), "little")
            self.acc |= w << self.avail
            self.avail += 32
            self.word_idx += 1
        val = self.acc & ((1 << length) - 1)
        self.acc >>= length
        self.avail -= length
        self.pos += length
        return val

    def read_int(self, u):
        b = u.bit_length() - 1
        m = (1 << (b + 1)) - u
        val = self.read(b)
        if val >= m:
            val = (val << 1) + self.read(1) - m
        return val

    def read_interpolative(self, out, lo_i, hi_i, low, high):
        n = hi_i - lo_i
        if n <= 0:
            return
        h = lo_i + n // 2
        val = low + self.read_int(high - low + 1)
        out[h] = val
        self.read_interpolative(out, lo_i, h, low, val)
        self.read_interpolative(out, h + 1, hi_i, val, high)


class InterpolativeBlock:
    block_size = 128
    overflow = 0

    @staticmethod
    def encode(values, sum_of_values, n, out_list):
        """values: gaps (uint32). Appends uint8 arrays to out_list."""
        v = np.asarray(values[:n], dtype=np.uint64)
        cum = np.cumsum(v).astype(np.uint64)
        if sum_of_values == UNKNOWN_SUM:
            sum_of_values = int(cum[-1])
            out_list.append(TightVariableByte.encode([sum_of_values]))
        bw = BitWriter32()
        bw.write_interpolative(cum, 0, n - 1, 0, int(sum_of_values))
        out_list.append(bw.tobytes())

    @staticmethod
    def decode(buf, pos, sum_of_values, n):
        """Returns (gaps uint32[n], new_pos)."""
        if sum_of_values == UNKNOWN_SUM:
            vals, pos = TightVariableByte.decode(buf, pos, 1)
            sum_of_values = int(vals[0])
        out = np.empty(n, dtype=np.int64)
        out[n - 1] = sum_of_values
        consumed = 0
        if n > 1:
            br = BitReader32(buf, pos)
            br.read_interpolative(out, 0, n - 1, 0, int(sum_of_values))
            out[1:] = np.diff(out)
            consumed = (br.pos + 7) // 8
        return out.astype(np.uint32), pos + consumed
