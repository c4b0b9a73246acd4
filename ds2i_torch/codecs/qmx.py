"""QMX 128-integer block codec — reference byte format.

Implements the exact byte format of the reference's vendored QMX
(qmx_codec.hpp, Trotman's "improved" QMX as modified for ds2i):

  - 15 width classes; a 128-bit payload word packs a fixed count of
    values per class (qmx_codec.hpp:66-101): 256x0b, 128x1b, 64x2b,
    40x3b, 32x4b, 24x5b, 20x6b, 16x8b, 12x10b, 8x16b, 4x32b in one
    word, and 36x7b, 28x9b, 20x12b, 12x21b striped across two words.
  - Values are striped over the four 32-bit lanes of each word: value v
    goes to lane v&3 at bit (v//4)*w (qmx_codec.hpp write_out); the
    two-word classes split straddling values across the word boundary.
  - 0-bit words encode runs of the value ONE (bits_needed_for(1)==0,
    qmx_codec.hpp:128-131); decode materializes 256 ones per instance.
  - A selector byte holds (type << 4) | (~(batch-1) & 0xF) where batch
    (1..16) is the number of consecutive payload instances of that type
    (qmx_codec.hpp:199-201); selectors are appended REVERSED after the
    payload, so reading the stream's last byte first yields them in
    forward order (qmx_codec.hpp:648-656 "Copy the lengths to the end,
    backwards").
  - The ds2i wrapper prepends vbyte(enc_len) and falls back to
    interpolative for partial (<128) blocks (block_codecs.hpp:317-350).

Encode replicates the reference encoder decision chain exactly —
group-of-4 width max, end-of-block 8/16/32 forcing, width-promotion
cascade to whole payload instances, run merge, and the truncated tail
write for 8/16/32-bit runs — so output is byte-identical (golden-tested
against a harness compiled from the in-tree reference header in
tests/test_qmx_golden.py).

The single source of truth for bit positions is LANE_TABLE: for every
(type, lane) it gives (bitoff_a, width_a, bitoff_b, width_b) within the
instance payload; value = bits_a | bits_b << width_a. Both this oracle
and the device kernel (ops/qmx_device.py) read it.
"""

import numpy as np

from .interpolative import InterpolativeBlock
from .vbyte import TightVariableByte

# width class table (qmx_codec.hpp:66-101): bits -> (type, ints/instance)
QMX_BITS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 21, 32]
TYPE_OF_BITS = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8,
                9: 9, 10: 10, 12: 11, 16: 12, 21: 13, 32: 14}
INTS_OF_BITS = {0: 256, 1: 128, 2: 64, 3: 40, 4: 32, 5: 24, 6: 20, 7: 36,
                8: 16, 9: 28, 10: 12, 12: 20, 16: 8, 21: 12, 32: 4}
# per TYPE (0..14)
BITS_OF_TYPE = QMX_BITS
INTS_OF_TYPE = [INTS_OF_BITS[w] for w in QMX_BITS]
DOUBLE_WORD_BITS = (7, 9, 12, 21)
# payload bytes the DECODER advances per instance (qmx_codec.hpp decode:
# 0 for type 0; 32 for the two-word classes; 16 otherwise — including
# the plain 8/16/32-bit classes whose encoder may truncate the tail)
ADV_OF_TYPE = [0] + [32 if w in DOUBLE_WORD_BITS else 16 for w in QMX_BITS[1:]]


def bits_needed_for(value):
    """qmx_codec.hpp:128-160 — note value 1 needs 0 bits, value 0 needs 1."""
    v = int(value)
    if v == 1:
        return 0
    for b, lim in ((1, 0x01), (2, 0x03), (3, 0x07), (4, 0x0F), (5, 0x1F),
                   (6, 0x3F), (7, 0x7F), (8, 0xFF), (9, 0x1FF), (10, 0x3FF),
                   (12, 0xFFF), (16, 0xFFFF), (21, 0x1FFFFF)):
        if v <= lim:
            return b
    return 32


def _build_lane_table():
    """(type, lane) -> (bitoff_a, width_a, bitoff_b, width_b) within the
    instance payload (128 or 256 bits). Derived from write_out's striping
    (qmx_codec.hpp:175-358): lane j of a w-bit single-word class sits in
    32-bit lane j&3 at bit (j//4)*w; two-word classes straddle."""
    tab = np.zeros((15, 256, 4), dtype=np.int32)
    for t in range(1, 15):
        w = BITS_OF_TYPE[t]
        ints = INTS_OF_TYPE[t]
        for j in range(ints):
            if w == 8:
                tab[t, j] = (j * 8, 8, 0, 0)
            elif w == 16:
                tab[t, j] = (j * 16, 16, 0, 0)
            elif w == 32:
                tab[t, j] = (j * 32, 32, 0, 0)
            elif w not in DOUBLE_WORD_BITS:
                tab[t, j] = ((j & 3) * 32 + (j >> 2) * w, w, 0, 0)
            else:
                # two-word classes: n0 whole values in word0, 4 straddlers
                # (low bits at word0's top, high bits at word1 bit 0), rest
                # in word1 restarting at a PER-WIDTH offset hardcoded in the
                # reference (qmx_codec.hpp write_out cases 7/9/12/21: +3,
                # +4, +8, +11 — 12/21-bit waste bits after the straddle)
                n0, off1 = {7: (16, 3), 9: (12, 4), 12: (8, 8), 21: (4, 11)}[w]
                lo = 32 - (n0 >> 2) * w  # low bits of a straddler in word0
                if j < n0:
                    tab[t, j] = ((j & 3) * 32 + (j >> 2) * w, w, 0, 0)
                elif j < n0 + 4:
                    tab[t, j] = ((j & 3) * 32 + (n0 >> 2) * w, lo,
                                 128 + (j & 3) * 32, w - lo)
                else:
                    tab[t, j] = (128 + (j & 3) * 32
                                 + ((j - n0 - 4) >> 2) * w + off1, w, 0, 0)
    return tab


LANE_TABLE = _build_lane_table()


def _assign_widths(values):
    """The reference encoder's width-assignment chain (qmx_codec.hpp
    encode steps 1-3): per-value bit lengths, group-of-4 max, end-of-block
    forcing, promotion cascade to whole instances. Returns len_buf[:128]
    (the per-value assigned widths)."""
    bs = len(values)
    len_buf = [bits_needed_for(v) for v in values] + [0] * 512

    for p in range(0, bs + 4, 4):  # cl < len_buf + block_size + 4
        m = max(len_buf[p:p + 4])
        len_buf[p:p + 4] = [m] * 4

    p = 0
    while p < bs:
        rem = bs - p
        if rem < 4:
            largest = max(len_buf[p:p + 8])
            if largest <= 8:
                len_buf[p:p + 8] = [8] * 8
            elif largest <= 16:
                len_buf[p:p + 8] = [16] * 8
            elif largest <= 32:
                len_buf[p:p + 8] = [32] * 8
        elif rem < 8:
            largest = max(len_buf[p:p + 8])
            if largest <= 8:
                len_buf[p:p + 8] = [8] * 8
            # (reference repeats the <=8 test where <=16 was meant —
            # replicated as-is for byte identity, qmx_codec.hpp:436-441)
        elif rem < 16:
            largest = max(len_buf[p:p + 16])
            if largest <= 8:
                len_buf[p:p + 16] = [8] * 16

        w = len_buf[p]
        ints = INTS_OF_BITS.get(w)
        if ints is None:  # non-class width can only come from promotion bugs
            raise AssertionError(f"non-class width {w}")
        nxt = {0: 1, 1: 2, 2: 3, 3: 4, 4: 5, 5: 6, 6: 7, 7: 8, 8: 9, 9: 10,
               10: 12, 12: 16, 16: 21, 21: 32, 32: 64}[w]
        promoted = False
        for blk in range(0, ints, 4):
            if len_buf[p + blk] > w:
                len_buf[p:p + 4] = [nxt] * 4
                promoted = True
                # reference keeps scanning but only rewrites the first 4
        if not promoted and len_buf[p] == w:
            len_buf[p:p + ints] = [w] * ints
            p += ints
        # else: re-examine the same position at the promoted width

    return len_buf[:bs]


def _pack_instance(vals, t):
    """Pack len(vals) == INTS_OF_TYPE[t] values into the instance payload
    (16 or 32 bytes) via LANE_TABLE. vals must be pre-padded with zeros."""
    w = BITS_OF_TYPE[t]
    nbytes = 32 if w in DOUBLE_WORD_BITS else 16
    acc = 0
    for j, v in enumerate(vals):
        ba, wa, bb, wb = LANE_TABLE[t, j]
        acc |= (int(v) & ((1 << int(wa)) - 1)) << int(ba)
        if wb:
            acc |= (int(v) >> int(wa)) << int(bb)
    return acc.to_bytes(nbytes, "little")


def _write_out(dest, vals, raw_count, bits, keys):
    """qmx_codec.hpp write_out: emit selector(s) + payload for one run of
    raw_count values all assigned `bits`. vals is the raw (unpadded) run."""
    t = TYPE_OF_BITS[bits]
    ints = INTS_OF_BITS[bits]
    count = (raw_count + ints - 1) // ints
    padded = list(vals) + [0] * (count * ints - raw_count)
    vi = 0
    while count > 0:
        batch = 16 if count > 16 else count
        keys.append((t << 4) | (~(batch - 1) & 0x0F))
        count -= batch
        for _ in range(batch):
            if bits == 0:
                vi += 256
            elif bits in (8, 16, 32):
                # plain byte/short/word stores stop at the run's end
                # (qmx_codec.hpp:280-283,337-341,353-357): tail instances
                # of the block's last run are truncated
                step = ints
                size = bits // 8
                take = min(step, max(0, raw_count - vi))
                for v in padded[vi:vi + take]:
                    dest += int(v).to_bytes(size, "little")
                vi += step
            else:
                dest += _pack_instance(padded[vi:vi + ints], t)
                vi += ints


def qmx_encode_block(values):
    """Encode exactly len(values) (the reference encodes block_size=128)
    integers; returns the QMX body bytes (payload + reversed selectors),
    without the ds2i vbyte length prefix."""
    v = [int(x) for x in values]
    bs = len(v)
    assert bs % 8 == 0
    len_buf = _assign_widths(v)

    dest = bytearray()
    keys = bytearray()
    rlen = 1
    bits = len_buf[0]
    for i in range(1, bs):
        if len_buf[i] == bits:
            rlen += 1
        else:
            _write_out(dest, v[i - rlen:i], rlen, bits, keys)
            bits = len_buf[i]
            rlen = 1
    _write_out(dest, v[bs - rlen:bs], rlen, bits, keys)

    dest += bytes(reversed(keys))
    return bytes(dest)


def qmx_decode_block(buf, pos, enc_len, n):
    """Decode a QMX body at buf[pos:pos+enc_len] (qmx_codec.hpp decode):
    walk selector bytes from the end (forward order), payload forward,
    while in <= keys. Returns n uint32 values."""
    out = np.zeros(n + QMXBlock.overflow, dtype=np.uint32)
    got = 0
    in_off = pos
    keys_off = pos + enc_len - 1
    blen = len(buf)
    while in_off <= keys_off:
        sel = int(buf[keys_off])
        keys_off -= 1
        t = sel >> 4
        batch = 16 - (sel & 0x0F)
        ints = INTS_OF_TYPE[t]
        adv = ADV_OF_TYPE[t]
        for _ in range(batch):
            if t == 0:
                out[got:got + 256] = 1
                got += 256
            else:
                nbytes = adv
                chunk = bytes(buf[in_off:min(in_off + nbytes, blen)])
                word = int.from_bytes(chunk.ljust(nbytes, b"\0"), "little")
                lim = min(ints, len(out) - got)
                for j in range(lim):
                    ba, wa, bb, wb = LANE_TABLE[t, j]
                    x = (word >> int(ba)) & ((1 << int(wa)) - 1)
                    if wb:
                        x |= ((word >> int(bb)) & ((1 << int(wb)) - 1)) << int(wa)
                    out[got + j] = x
                got += ints
                in_off += adv
    return out[:n]


class QMXBlock:
    block_size = 128
    overflow = 512  # decode overshoots: type-0 emits 256, tails read past

    @staticmethod
    def encode(values, sum_of_values, n, out_list):
        if n < QMXBlock.block_size:
            InterpolativeBlock.encode(values, sum_of_values, n, out_list)
            return
        body = qmx_encode_block(values[:n])
        out_list.append(TightVariableByte.encode([len(body)]))
        out_list.append(np.frombuffer(body, dtype=np.uint8))

    @staticmethod
    def decode(buf, pos, sum_of_values, n):
        if n < QMXBlock.block_size:
            return InterpolativeBlock.decode(buf, pos, sum_of_values, n)
        vals, q = TightVariableByte.decode(buf, pos, 1)
        enc_len = int(vals[0])
        out = qmx_decode_block(buf, q, enc_len, n)
        return out.copy(), q + enc_len
