"""OptPFor (OPT-PFD) 128-integer block codec.

Reimplementation of the scheme used by the reference via FastPFor's
OPTPFor<4, Simple16> (block_codecs.hpp:150-227): per block, pick the bit
width b over FastPFor's possLogs grid minimizing total size; values with
more than b bits become exceptions whose low b bits stay in the slot and
whose positions/high bits are Simple16-coded. The FastPFor submodule is
absent upstream, so the exact header/stream layout here is this module's
own (documented below); the optimization rule and compression behavior
match.

Layout (byte-aligned, little-endian):
  u8  b            bit width (0..32)
  u8  n_exceptions
  [ceil(n*b/32) u32]  slot words, b-bit packed
  if n_exceptions: simple16 words of [pos gaps (first abs, then gap-1),
                                      then (high_part - 1) per exception]

Partial blocks (< 128 values) fall back to binary interpolative coding,
exactly like the reference (block_codecs.hpp:196-199).
"""

import numpy as np

from .interpolative import UNKNOWN_SUM, InterpolativeBlock
from .simple16 import simple16_decode, simple16_encode

POSS_LOGS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16, 20, 32]


def _pack_bits(values, b):
    """Pack len(values) b-bit fields into u32 words (little-endian bits)."""
    n = len(values)
    if b == 0:
        return np.zeros(0, dtype="<u4")
    total_bits = n * b
    words = np.zeros((total_bits + 31) // 32, dtype=np.uint64)
    offs = np.arange(n, dtype=np.uint64) * np.uint64(b)
    widx = (offs >> np.uint64(5)).astype(np.int64)
    shift = offs & np.uint64(31)
    v = values.astype(np.uint64) & np.uint64((1 << b) - 1)
    np.bitwise_or.at(words, widx, (v << shift) & np.uint64(0xFFFFFFFF))
    hi = shift.astype(np.int64) + b > 32
    if np.any(hi):
        np.bitwise_or.at(words, widx[hi] + 1, v[hi] >> (np.uint64(32) - shift[hi]))
    return words.astype("<u4")


def _unpack_bits(words, n, b):
    if b == 0:
        return np.zeros(n, dtype=np.uint32)
    w = words.astype(np.uint64)
    w = np.concatenate([w, np.zeros(1, dtype=np.uint64)])
    offs = np.arange(n, dtype=np.uint64) * np.uint64(b)
    widx = (offs >> np.uint64(5)).astype(np.int64)
    shift = offs & np.uint64(31)
    lo = w[widx] >> shift
    hi = np.where(shift > 0, w[widx + 1] << (np.uint64(32) - shift), np.uint64(0))
    return ((lo | hi) & np.uint64((1 << b) - 1)).astype(np.uint32)


def _block_cost_words(values, b):
    """Encoded u32 words for width b (excluding the 2-byte header)."""
    n = len(values)
    slot_words = (n * b + 31) // 32
    if b >= 32:
        return slot_words, 0
    ex = np.nonzero(values >= (1 << b))[0]
    if len(ex) > 255:
        return None, None
    if len(ex) == 0:
        return slot_words, 0
    highs = (values[ex] >> b).astype(np.int64)
    if np.any(highs - 1 >= (1 << 28)):
        return None, None
    gaps = np.diff(ex)
    stream = [int(ex[0])] + [int(g - 1) for g in gaps] + [int(h - 1) for h in highs]
    if any(s >= (1 << 28) for s in stream):
        return None, None
    ex_words = len(simple16_encode(stream))
    return slot_words, ex_words


class OptPForBlock:
    block_size = 128
    overflow = 0

    @staticmethod
    def find_best_b(values):
        best_b, best_words = 32, None
        for b in POSS_LOGS:
            sw, ew = _block_cost_words(values, b)
            if sw is None:
                continue
            total = sw + ew
            if best_words is None or total <= best_words:
                best_b, best_words = b, total
        return best_b

    @staticmethod
    def encode(values, sum_of_values, n, out_list, force_b=None):
        if n < OptPForBlock.block_size:
            InterpolativeBlock.encode(values, sum_of_values, n, out_list)
            return
        v = np.asarray(values[:n], dtype=np.uint32)
        b = force_b if force_b is not None else OptPForBlock.find_best_b(v)
        slot = _pack_bits(v, min(b, 32))
        if b >= 32:
            ex_stream = np.zeros(0, dtype="<u4")
            n_ex = 0
        else:
            ex = np.nonzero(v >= (1 << b))[0]
            n_ex = len(ex)
            if n_ex:
                highs = (v[ex] >> b).astype(np.int64)
                gaps = np.diff(ex)
                stream = [int(ex[0])] + [int(g - 1) for g in gaps] + [int(h - 1) for h in highs]
                ex_stream = simple16_encode(stream)
            else:
                ex_stream = np.zeros(0, dtype="<u4")
        header = np.array([b, n_ex], dtype=np.uint8)
        out_list.append(header)
        out_list.append(slot.view(np.uint8))
        out_list.append(ex_stream.view(np.uint8))

    @staticmethod
    def decode(buf, pos, sum_of_values, n):
        if n < OptPForBlock.block_size:
            return InterpolativeBlock.decode(buf, pos, sum_of_values, n)
        b = int(buf[pos])
        n_ex = int(buf[pos + 1])
        pos += 2
        slot_words = (n * min(b, 32) + 31) // 32
        words = np.frombuffer(bytes(buf[pos : pos + 4 * slot_words]), dtype="<u4")
        pos += 4 * slot_words
        out = _unpack_bits(words, n, min(b, 32)).astype(np.uint32)
        if n_ex:
            # worst case simple16 words: one value per word
            avail = (len(buf) - pos) // 4
            ex_words = np.frombuffer(
                bytes(buf[pos : pos + 4 * min(2 * n_ex, avail)]), dtype="<u4"
            )
            stream, used = simple16_decode(ex_words, 2 * n_ex)
            pos += 4 * used
            positions = np.empty(n_ex, dtype=np.int64)
            positions[0] = stream[0]
            if n_ex > 1:
                positions[1:] = stream[1:n_ex] + 1
                positions = np.cumsum(positions)
            highs = stream[n_ex:].astype(np.uint32) + 1
            out[positions] |= highs << b
        return out, pos
