"""Simple16 word-aligned packing (the exception coder inside OptPFor,
block_codecs.hpp:152): 4-bit selector + 28 data bits per 32-bit word.
Standard 16-mode table (runs of (count, bits))."""

import numpy as np

S16_MODES = [
    [(28, 1)],
    [(7, 2), (14, 1)],
    [(14, 1), (7, 2)],
    [(14, 2)],
    [(4, 3), (8, 2)],
    [(8, 2), (4, 3)],
    [(7, 4)],
    [(4, 5), (2, 4)],
    [(2, 4), (4, 5)],
    [(3, 6), (2, 5)],
    [(2, 5), (3, 6)],
    [(4, 7)],
    [(2, 9), (1, 10)],
    [(1, 10), (2, 9)],
    [(2, 14)],
    [(1, 28)],
]

_MODE_WIDTHS = [
    [b for cnt, b in mode for _ in range(cnt)] for mode in S16_MODES
]
_MODE_COUNTS = [len(w) for w in _MODE_WIDTHS]


def simple16_encode(values):
    """Pack values (< 2^28 each) into uint32 words."""
    vals = [int(v) for v in values]
    assert all(v < (1 << 28) for v in vals), "simple16 requires values < 2^28"
    words = []
    i = 0
    n = len(vals)
    while i < n:
        for sel in range(16):
            widths = _MODE_WIDTHS[sel]
            cnt = min(len(widths), n - i)
            if cnt < len(widths) and sel != 15:
                # a mode only applies if it is completely fillable, except
                # the last (1x28) which always fits a single value
                fits = all(vals[i + j] < (1 << widths[j]) for j in range(cnt))
                if not fits:
                    continue
                # can't partially fill non-final modes unless we pad zeros
                w = 0
                shift = 0
                ok = True
                for j, width in enumerate(widths):
                    v = vals[i + j] if j < cnt else 0
                    if v >= (1 << width):
                        ok = False
                        break
                    w |= v << shift
                    shift += width
                if not ok:
                    continue
                words.append((sel << 28) | w)
                i += cnt
                break
            else:
                if all(vals[i + j] < (1 << widths[j]) for j in range(min(cnt, len(widths)))):
                    w = 0
                    shift = 0
                    for j, width in enumerate(widths):
                        v = vals[i + j] if j < cnt else 0
                        w |= v << shift
                        shift += width
                    words.append((sel << 28) | w)
                    i += min(cnt, len(widths))
                    break
        else:
            raise ValueError(f"value {vals[i]} cannot be simple16-coded")
    return np.asarray(words, dtype="<u4")


def simple16_decode(words, n):
    """Unpack n values; returns (values uint32[n], words consumed)."""
    out = np.empty(n, dtype=np.uint32)
    i = 0
    wi = 0
    while i < n:
        w = int(words[wi])
        wi += 1
        sel = w >> 28
        payload = w & ((1 << 28) - 1)
        for width in _MODE_WIDTHS[sel]:
            if i >= n:
                break
            out[i] = payload & ((1 << width) - 1)
            payload >>= width
            i += 1
    return out, wi
