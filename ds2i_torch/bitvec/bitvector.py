"""Bit substrate: growable bit-vector builder + frozen bit vector.

TPU-native replacement for the `succinct` submodule surface used by the
reference (SURVEY.md §2.9: bit_vector_builder::set/set_bits/append_bits/
zero_extend/append, bit_vector::get_bits/get_word56, enumerators).

Design departure from the reference: the reference sets bits one element at
a time inside per-list encode loops (e.g. compact_elias_fano.hpp:105-132).
Here the substrate exposes *vectorized* bulk primitives —
``set_ones(positions)``, ``set_fields(offsets, values, width)``,
``get_fields(offsets, width)``, ``select_ones(begin, end)`` — so encoders
compute the whole layout with numpy and blit it in O(words) array ops.
The frozen word array uploads directly to TPU HBM (viewed as uint32) where
Pallas/jnp kernels do the batched decode.

Bit order: LSB-first within a 64-bit little-endian word, i.e. bit ``i`` of
the stream is ``(words[i >> 6] >> (i & 63)) & 1``. Viewing the word array
as uint32 (little-endian) preserves stream order, which is what the device
kernels rely on.
"""

import numpy as np

WORD_BITS = 64
_U64 = np.uint64
_ONE = _U64(1)


def _mask(width):
    """Low `width` bits set; width may be 0..64 (python int math)."""
    return _U64((1 << int(width)) - 1) if width < 64 else _U64(0xFFFFFFFFFFFFFFFF)


def _shl(x, s):
    """Elementwise x << s with s in [0, 128); shifts >= 64 yield 0."""
    s = s.astype(_U64) if isinstance(s, np.ndarray) else _U64(s)
    safe = x << (s & _U64(63))
    return np.where(s >= _U64(64), _U64(0), safe)


def _shr(x, s):
    s = s.astype(_U64) if isinstance(s, np.ndarray) else _U64(s)
    safe = x >> (s & _U64(63))
    return np.where(s >= _U64(64), _U64(0), safe)


def ceil_div(a, b):
    return -(-a // b)


def ceil_log2(x):
    """Smallest k with 2^k >= x (matches util.hpp ceil_log2: x>1 ? msb(x-1)+1 : 0)."""
    x = int(x)
    return (x - 1).bit_length() if x > 1 else 0


def msb(x):
    """Index of most significant set bit (floor(log2 x)); x > 0."""
    x = int(x)
    assert x > 0
    return x.bit_length() - 1


class BitVectorBuilder:
    """Growable bit buffer over a uint64 numpy array."""

    __slots__ = ("_words", "_size")

    def __init__(self, nbits=0):
        self._words = np.zeros(max(ceil_div(int(nbits), WORD_BITS), 4), dtype=_U64)
        self._size = int(nbits)

    # -- capacity -----------------------------------------------------------

    def __len__(self):
        return self._size

    @property
    def size(self):
        return self._size

    def _ensure_words(self, nwords):
        if nwords > len(self._words):
            new_cap = max(nwords, 2 * len(self._words))
            grown = np.zeros(new_cap, dtype=_U64)
            grown[: len(self._words)] = self._words
            self._words = grown

    def reserve(self, nbits):
        self._ensure_words(ceil_div(int(nbits), WORD_BITS))

    def zero_extend(self, n):
        """Append n zero bits."""
        self._size += int(n)
        self._ensure_words(ceil_div(self._size, WORD_BITS))

    # -- scalar ops ---------------------------------------------------------

    def push_back(self, bit):
        self.zero_extend(1)
        if bit:
            self.set(self._size - 1, 1)

    def set(self, pos, bit):
        pos = int(pos)
        w, s = pos >> 6, pos & 63
        if bit:
            self._words[w] |= _ONE << _U64(s)
        else:
            self._words[w] &= ~(_ONE << _U64(s))

    def get(self, pos):
        pos = int(pos)
        return int(self._words[pos >> 6] >> _U64(pos & 63)) & 1

    def set_bits(self, pos, value, width):
        """Overwrite `width` bits at `pos` with `value` (assumed zeroed region)."""
        pos, value, width = int(pos), int(value) & ((1 << int(width)) - 1), int(width)
        if width == 0:
            return
        w, s = pos >> 6, pos & 63
        self._words[w] |= _U64((value << s) & 0xFFFFFFFFFFFFFFFF)
        if s + width > 64:
            self._words[w + 1] |= _U64(value >> (64 - s))

    def append_bits(self, value, width):
        pos = self._size
        self.zero_extend(width)
        self.set_bits(pos, value, width)

    # -- vectorized bulk ops --------------------------------------------------

    def set_ones(self, positions):
        """Set bit 1 at every position in `positions` (int array)."""
        positions = np.asarray(positions, dtype=np.uint64)
        if positions.size == 0:
            return
        np.bitwise_or.at(
            self._words, (positions >> _U64(6)).astype(np.int64), _shl(_ONE, positions & _U64(63))
        )

    def set_fields(self, offsets, values, width):
        """Write values[i] (width bits each) at bit offsets[i]. Regions assumed zero.

        width is a scalar python int in [0, 64].
        """
        width = int(width)
        if width == 0:
            return
        offsets = np.asarray(offsets, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64) & _mask(width)
        if offsets.size == 0:
            return
        widx = (offsets >> _U64(6)).astype(np.int64)
        s = offsets & _U64(63)
        lo = _shl(values, s)
        np.bitwise_or.at(self._words, widx, lo)
        hi_needed = s.astype(np.int64) + width > 64
        if np.any(hi_needed):
            hs = np.where(hi_needed)[0]
            hi = _shr(values[hs], _U64(64) - s[hs])
            np.bitwise_or.at(self._words, widx[hs] + 1, hi)

    def append_fields(self, values, width):
        """Append len(values) fixed-width fields; returns starting bit offset."""
        values = np.asarray(values, dtype=np.uint64)
        base = self._size
        self.zero_extend(int(width) * len(values))
        offs = base + np.arange(len(values), dtype=np.uint64) * np.uint64(width)
        self.set_fields(offs, values, width)
        return base

    def append_builder(self, other):
        """Append another builder's bits at the current (arbitrary) bit offset."""
        n = other._size
        if n == 0:
            return
        base = self._size
        self.zero_extend(n)
        src = other._words[: ceil_div(n, WORD_BITS)]
        # mask stray bits beyond `other`'s size in its last word
        tail_bits = n & 63
        if tail_bits:
            src = src.copy()
            src[-1] &= _mask(tail_bits)
        w0, s = base >> 6, base & 63
        nw = len(src)
        self._ensure_words(w0 + 1 + nw)
        if s == 0:
            np.bitwise_or.at(self._words, np.arange(w0, w0 + nw), src)
        else:
            s64 = _U64(s)
            lo = src << s64
            hi = src >> (_U64(64) - s64)
            self._words[w0 : w0 + nw] |= lo
            self._words[w0 + 1 : w0 + 1 + nw] |= hi

    def build(self):
        nwords = ceil_div(self._size, WORD_BITS)
        words = self._words[:nwords].copy()
        tail = self._size & 63
        if nwords and tail:
            words[-1] &= _mask(tail)
        return BitVector(words, self._size)


class BitVector:
    """Frozen bit vector: uint64 word array + bit count."""

    __slots__ = ("words", "nbits", "_bits_cache")

    def __init__(self, words, nbits):
        self.words = np.ascontiguousarray(words, dtype=_U64)
        self.nbits = int(nbits)
        self._bits_cache = None

    def __len__(self):
        return self.nbits

    def __getitem__(self, pos):
        pos = int(pos)
        return int(self.words[pos >> 6] >> _U64(pos & 63)) & 1

    def get_bits(self, pos, width):
        """Read `width` (0..64) bits at bit offset `pos` (scalar)."""
        pos, width = int(pos), int(width)
        if width == 0:
            return 0
        w, s = pos >> 6, pos & 63
        lo = int(self.words[w]) >> s
        if s + width > 64 and w + 1 < len(self.words):
            lo |= int(self.words[w + 1]) << (64 - s)
        return lo & ((1 << width) - 1)

    # get_word56 equivalent: get_bits with width<=56 always safe w.r.t. two words

    def get_fields(self, offsets, width):
        """Vectorized fixed-width field gather. width: scalar int in [0,64]."""
        width = int(width)
        offsets = np.asarray(offsets, dtype=np.uint64)
        if width == 0:
            return np.zeros(offsets.shape, dtype=_U64)
        padded = self._padded_words()
        widx = (offsets >> _U64(6)).astype(np.int64)
        s = offsets & _U64(63)
        w0 = padded[widx]
        w1 = padded[widx + 1]
        out = _shr(w0, s) | _shl(w1, _U64(64) - s)
        return out & _mask(width)

    def _padded_words(self):
        # one trailing zero word so widx+1 is always valid
        return np.concatenate([self.words, np.zeros(1, dtype=_U64)])

    # -- bulk bit expansion / select ---------------------------------------

    def bits(self):
        """Full bit array (uint8, one entry per bit, stream order). Cached."""
        if self._bits_cache is None:
            byts = self.words.view(np.uint8)
            b = np.unpackbits(byts, bitorder="little")
            self._bits_cache = b[: self.nbits]
        return self._bits_cache

    def bits_range(self, begin, end):
        """Bits [begin, end) as uint8 array (no cache)."""
        begin, end = int(begin), int(end)
        wb, we = begin >> 6, ceil_div(end, WORD_BITS)
        byts = self.words[wb:we].view(np.uint8)
        b = np.unpackbits(byts, bitorder="little")
        off = begin - (wb << 6)
        return b[off : off + (end - begin)]

    def select_ones(self, begin, end):
        """Positions (absolute) of every 1-bit in [begin, end), ascending."""
        b = self.bits_range(begin, end)
        return np.nonzero(b)[0] + int(begin)

    def rank1(self, pos):
        """Number of ones in [0, pos)."""
        return int(self.bits_range(0, pos).sum())

    def predecessor1(self, pos):
        """Position of the last 1-bit at or before `pos`."""
        pos = int(pos)
        # scan backward word by word
        w = pos >> 6
        cur = int(self.words[w]) & ((1 << ((pos & 63) + 1)) - 1)
        while cur == 0:
            w -= 1
            assert w >= 0, "no predecessor"
            cur = int(self.words[w])
        return (w << 6) + cur.bit_length() - 1

    # -- persistence --------------------------------------------------------

    def tree(self):
        return {"nbits": self.nbits, "words": self.words}

    @classmethod
    def from_tree(cls, t):
        return cls(np.asarray(t["words"], dtype=_U64), int(t["nbits"]))


class BitReader:
    """Sequential bit reader (succinct::bit_vector::enumerator equivalent).

    Used for decoding per-list gamma/delta headers (integer_codes) and
    partitioned-sequence metadata; the hot decode paths never use this —
    they use vectorized get_fields/select_ones or device kernels.
    """

    __slots__ = ("bv", "pos")

    def __init__(self, bv, pos=0):
        self.bv = bv
        self.pos = int(pos)

    def position(self):
        return self.pos

    def take(self, width):
        val = self.bv.get_bits(self.pos, width)
        self.pos += int(width)
        return val

    def skip(self, n):
        self.pos += int(n)

    def skip_zeros(self):
        """Skip up to the next 1 bit (consuming it); returns number of zeros skipped."""
        zeros = 0
        while True:
            chunk = self.bv.get_bits(self.pos, 56)
            if chunk == 0:
                zeros += 56
                self.pos += 56
                continue
            tz = (chunk & -chunk).bit_length() - 1
            zeros += tz
            self.pos += tz + 1
            return zeros
