"""Seeded edge rows for the batched segment decode (ds2i_torch/ops/decode.py
decode_rows, K9), shared by the CPU tests (tests/test_torch_segment_decode.py)
and the card tests (tests/test_torch_cuda.py).

`segment_rows(seed)` returns (words uint32, fields {name: int32[R]}, list_n
int32[rows], statics {W, Lseg, rows, L_out, sentinel}) over random words.
Each case below writes output rows of its own (so no two segments write
one slot, which the op leaves unordered):

  long        EF segments of thousands of values (a plain `ef` list is one
              segment), one of them past Lseg
  past_lseg   more ones in the window than Lseg, and n_vals above Lseg
  few_ones    a sparse window: fewer ones than slots (those read sel = 0)
  past_w      a window longer than the call's W words (the ones past them
              are not seen)
  l0, l31, l32  low-bit widths 0, 31 and 32 (the mask all ones, the shift 0)
  kinds       SEG_EF_STRICT, SEG_RB, SEG_AO and an unknown kind (value 0)
  partitions  several segments filling one row at their out_begin
  masked      list_n below the row's values; out_begin past L_out
  negative    a negative out_begin and list_row (counted from the end)
  offgrid     list_row past the rows (every write dropped)
  stream_end  a window and low bits past the last word (clamped reads)
  dense       ranked-bitvector and EF segments over all-ones words: 32-word
              steps of 1,024 ones (32 rounds of 32 ranks) up to Lseg
  pad         kind -1, n_vals 0, list_row the spare last row
"""

import numpy as np

from ds2i_torch.ops.decode import FIELDS
from ds2i_torch.ops.segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB

CASES = ("long", "past_lseg", "few_ones", "past_w", "l0", "l31", "l32", "kinds", "partitions",
         "masked", "negative", "offgrid", "stream_end", "dense", "pad")


def segment_rows(seed):
    rng = np.random.RandomState(seed)
    nw = 6000
    words = rng.randint(0, 1 << 32, size=nw, dtype=np.uint64).astype(np.uint32)
    words[1000:1100] &= rng.randint(0, 1 << 32, size=100, dtype=np.uint64).astype(np.uint32) & \
        np.uint32(0x01010101)  # a sparse stretch for few_ones
    W, Lseg, L_out = 256, 2048, 4096
    rows = []  # (case, field dict, list_n of its output row or None)

    def seg(kind, sel_start, sel_len, lb_start, l, n, base=0, out_begin=0, row=None):
        return dict(kind=kind, sel_start=sel_start, sel_len=sel_len, lb_start=lb_start,
                    lower_bits=l, n_vals=n, base=base, out_begin=out_begin, list_row=row)

    def bit(lo, hi):
        return int(rng.randint(lo, hi))

    rows.append(("long", seg(SEG_EF, bit(0, 32 * 50), 5000, bit(32 * 3000, 32 * 3100), 3, 1900,
                             base=bit(0, 1000))))
    rows.append(("long", seg(SEG_EF, bit(32 * 200, 32 * 250), 7000, bit(32 * 3200, 32 * 3300), 2,
                             2500)))
    rows.append(("past_lseg", seg(SEG_EF, bit(32 * 400, 32 * 450), 6000, 32 * 3500 + 7, 1, 2100)))
    rows.append(("few_ones", seg(SEG_EF, 32 * 1000 + 5, 32 * 90, 32 * 3600, 4, 300)))
    rows.append(("few_ones", seg(SEG_RB, 32 * 1010, 32 * 60, 0, 0, 200, base=17)))
    rows.append(("past_w", seg(SEG_EF, 32 * 1200 + 13, 32 * W + 500, 32 * 3700, 2, 2000)))
    rows.append(("l0", seg(SEG_EF, bit(32 * 1500, 32 * 1510), 900, 32 * 3800, 0, 400, base=5)))
    rows.append(("l31", seg(SEG_EF, bit(32 * 1520, 32 * 1530), 300, 32 * 3900 + 3, 31, 100)))
    rows.append(("l32", seg(SEG_EF, bit(32 * 1540, 32 * 1550), 300, 32 * 4100 + 9, 32, 100)))
    rows.append(("l32", seg(SEG_EF_STRICT, bit(32 * 1560, 32 * 1570), 300, 32 * 4300, 32, 90,
                            base=-3)))
    rows.append(("kinds", seg(SEG_EF_STRICT, bit(32 * 1600, 32 * 1610), 800, 32 * 4500 + 1, 5,
                              350, base=11)))
    rows.append(("kinds", seg(SEG_RB, bit(32 * 1700, 32 * 1710), 1000, 0, 0, 450, base=3)))
    rows.append(("kinds", seg(SEG_AO, 0, 0, 0, 0, 600, base=1234)))
    rows.append(("kinds", seg(7, bit(32 * 1800, 32 * 1810), 500, 32 * 4600, 3, 120, base=9)))
    # one output row of four partitions, each its own segment
    at, parts = 0, []
    for p in range(4):
        n = bit(40, 200)
        parts.append(("partitions", seg((SEG_EF, SEG_EF_STRICT, SEG_RB, SEG_AO)[p],
                                        bit(32 * 1900 + 200 * p, 32 * 1900 + 200 * p + 64), 3 * n,
                                        bit(32 * 4700, 32 * 4800), bit(1, 9), n,
                                        base=bit(0, 100000), out_begin=at)))
        at += n
    rows += parts
    rows.append(("masked", seg(SEG_EF, bit(32 * 2100, 32 * 2110), 2000, 32 * 4900, 3, 700,
                               out_begin=L_out - 300)))
    rows.append(("masked", seg(SEG_EF, bit(32 * 2200, 32 * 2210), 2000, 32 * 4950, 3, 700)))
    rows.append(("negative", seg(SEG_EF, bit(32 * 2300, 32 * 2310), 400, 32 * 5000, 2, 150,
                                 out_begin=-5, row=-2)))
    rows.append(("offgrid", seg(SEG_EF, bit(32 * 2400, 32 * 2410), 400, 32 * 5100, 2, 150,
                                row=10_000)))
    rows.append(("stream_end", seg(SEG_EF, 32 * (nw - 3) + 17, 400, 32 * (nw - 2) + 29, 7, 60)))
    words[5300:5560] = 0xFFFFFFFF  # the dense stretch
    rows.append(("dense", seg(SEG_RB, 32 * 5300 + 9, 32 * 32 * 5 + 300, 0, 0, 2000, base=2)))
    rows.append(("dense", seg(SEG_EF, 32 * 5330, 32 * 32 * 7, 32 * 5800 + 3, 1, 2048)))
    rows.append(("pad", seg(-1, 0, 0, 0, 0, 0, row=-1)))

    n_rows = len(rows) + 3  # a free row for each of the negative and pad rows
    fields = {k: np.zeros(len(rows), dtype=np.int32) for k in FIELDS}
    list_n = np.zeros(n_rows, dtype=np.int32)
    next_row = 0
    part_row = None
    for r, (case, f, ) in enumerate(rows):
        row = f["list_row"]
        if row is None:
            if case == "partitions":
                if part_row is None:
                    part_row, next_row = next_row, next_row + 1
                row = part_row
            else:
                row, next_row = next_row, next_row + 1
        for k in FIELDS:
            fields[k][r] = row if k == "list_row" else f[k]
        if 0 <= row < n_rows:
            end = f["out_begin"] + f["n_vals"]
            list_n[row] = max(list_n[row], min(end, L_out))
    # masked: the second row's list_n stops short of its values
    masked = [r for r, (case, _) in enumerate(rows) if case == "masked"]
    list_n[fields["list_row"][masked[1]]] = 333
    list_n[n_rows - 2] = L_out  # the negative row's (-2)
    statics = dict(W=W, Lseg=Lseg, rows=n_rows, L_out=L_out, sentinel=(0, -1, 9999)[seed % 3])
    return words, fields, list_n, statics
