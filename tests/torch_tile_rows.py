"""Seeded edge rows for the one-stream tile-group decode
(ds2i_torch/ops/pair_decode.py decode_group, K6g), shared by the CPU tests
(tests/test_torch_segment_decode.py) and the card tests
(tests/test_torch_cuda.py).

`tile_rows(seed)` returns (words uint32, groups), each group (case,
fields int32 (R, N_FIELDS), W, WL, T), over random words. Every group
mixes real rows with pad rows (kind -1, n_vals 0). The cases:

  w64_wl64    W = 64 and WL = 64: windows over two 32-word steps, low
              words past three a lane, EF and strict EF rows of up to 128
              values
  widths      l of 0, 31 and 32; with n_vals 128 the low bits of l 31 and
              32 run past the WL + 1 words (those words read 0)
  kinds       EF, strict EF, ranked bitvector, all-ones, kind -1 and an
              unknown kind, with negative and large adj and base (uint32
              wrapping)
  stream_end  windows and low words past the stream's last word (clamped
              reads)
  n_vals      n_vals 0, 1, 128, above T and negative; a few-ones window
              with more n_vals than ones (the select then lands in word
              W-1, as the plain version's does)
  narrow      T = 32 with n_vals up to 128
  wide        W = 256, WL = 100: eight window steps, four low-word copies
              a lane
  typical     the (4, 4) shape of most `opt` rows, short windows and lists
"""

import numpy as np

from ds2i_torch.engine.tiles import (
    F_BASE, F_KIND, F_LB_BITOFF, F_LB_WORD0, F_LOWER_BITS, F_NVALS, F_PREV_CUM, F_SEL_ADJ,
    F_WIN_BITOFF, F_WIN_LEN, F_WIN_WORD0, N_FIELDS,
)
from ds2i_torch.ops.segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB

CASES = ("w64_wl64", "widths", "kinds", "stream_end", "n_vals", "narrow", "wide", "typical")
NW = 8000


def _row(kind, word0, bitoff, wlen, adj, l, lb_word0, lb_bitoff, base, nvals):
    f = np.zeros(N_FIELDS, dtype=np.int64)
    f[[F_KIND, F_WIN_WORD0, F_WIN_BITOFF, F_WIN_LEN, F_SEL_ADJ, F_LOWER_BITS, F_LB_WORD0,
       F_LB_BITOFF, F_BASE, F_NVALS, F_PREV_CUM]] = (
        kind, word0, bitoff, wlen, adj, l, lb_word0, lb_bitoff, base, nvals, 0)
    return f


def _pad():
    return _row(-1, 0, 0, 0, 0, 0, 0, 0, 0, 0)


def tile_rows(seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, size=NW, dtype=np.uint64).astype(np.uint32)
    words[1000:1200] &= np.uint32(0x00100001)  # a sparse stretch for few-ones windows
    groups = []

    def word(lo=0, hi=NW - 300):
        return int(rng.randint(lo, hi))

    def ef_row(W, WL, n, l=None, kind=SEG_EF, wfrac=1.0):
        l = int(rng.randint(0, 17)) if l is None else l
        bitoff = int(rng.randint(0, 32))
        wlen = max(1, int(32 * W * wfrac) - bitoff - int(rng.randint(0, 8)))
        return _row(kind, word(), bitoff, wlen, int(rng.randint(-4, 3)), l, word(),
                    int(rng.randint(0, 32)), int(rng.randint(-(1 << 31), 1 << 31)), n)

    def group(case, rows, W, WL, T=128):
        rows = list(rows) + [_pad() for _ in range(int(rng.randint(1, 4)))]
        order = rng.permutation(len(rows))
        groups.append((case, np.stack([rows[i] for i in order]).astype(np.int32), W, WL, T))

    W, WL = 64, 64
    group("w64_wl64", [ef_row(W, WL, int(rng.randint(1, 129)), l=int(rng.randint(0, 17)),
                              kind=(SEG_EF, SEG_EF_STRICT)[i % 2], wfrac=rng.uniform(0.2, 1.0))
                       for i in range(40)] + [ef_row(W, WL, 128, l=16)], W, WL)
    W, WL = 16, 64
    group("widths", [ef_row(W, WL, n, l=l, kind=k) for l in (0, 31, 32) for n in (1, 50, 128)
                     for k in (SEG_EF, SEG_EF_STRICT)], W, WL)
    W, WL = 16, 16
    group("kinds", [ef_row(W, WL, int(rng.randint(1, 129)), kind=SEG_EF) for _ in range(6)]
          + [ef_row(W, WL, int(rng.randint(1, 129)), kind=SEG_EF_STRICT) for _ in range(6)]
          + [_row(SEG_RB, word(), int(rng.randint(0, 32)), int(rng.randint(1, 32 * W)),
                  int(rng.randint(-3000, 3000)), 0, 0, 0, int(rng.randint(0, 1 << 20)),
                  int(rng.randint(1, 129))) for _ in range(6)]
          + [_row(SEG_AO, 0, 0, 0, 0, 0, 0, 0, int(rng.randint(0, 1 << 20)),
                  int(rng.randint(1, 129))) for _ in range(4)]
          + [_row(k, word(), 3, 100, 1, 5, word(), 7, 77, 60) for k in (-1, 7)]
          + [ef_row(W, WL, 128, l=8) for _ in range(2)]
          + [_row(SEG_EF, word(), 5, 400, -(1 << 30), 3, word(), 1, (1 << 31) - 1, 90)],
          W, WL)
    W, WL = 16, 16
    group("stream_end", [_row(SEG_EF, NW - 5, 9, 32 * W - 20, 0, 6, NW - 3, 17, 5, 100),
                         _row(SEG_EF_STRICT, NW - 1, 0, 32 * W, -1, 4, NW + 40, 3, 0, 128),
                         _row(SEG_RB, NW - 2, 30, 32 * W - 40, 11, 0, 0, 0, 9, 128),
                         ef_row(W, WL, 70)], W, WL)
    W, WL = 8, 8
    group("n_vals", [ef_row(W, WL, n) for n in (0, 1, 128, 200, -3)]
          + [_row(SEG_EF, 1000 + int(rng.randint(0, 190)), int(rng.randint(0, 32)), 32 * W - 40,
                  -1, 2, word(), 0, 0, n) for n in (5, 40, 128)]
          + [_row(SEG_RB, 1000 + int(rng.randint(0, 190)), 0, 32 * W, 0, 0, 0, 0, 0, 100),
             _row(SEG_EF, word(), 4, 0, 0, 3, word(), 0, 0, 20)], W, WL)
    W, WL = 16, 16
    group("narrow", [ef_row(W, WL, n) for n in (1, 20, 32, 33, 128)], W, WL, T=32)
    W, WL = 256, 100
    group("wide", [ef_row(W, WL, int(rng.randint(1, 129)), l=int(rng.randint(0, 25)),
                          wfrac=rng.uniform(0.3, 1.0)) for _ in range(12)]
          + [_row(SEG_RB, word(), 0, 32 * W, 0, 0, 0, 0, 0, 128)], W, WL)
    W, WL = 4, 4
    group("typical", [ef_row(W, WL, int(rng.randint(1, 18)), l=int(rng.randint(0, 7)),
                             wfrac=rng.uniform(0.2, 1.0)) for _ in range(60)], W, WL)
    return words, groups
