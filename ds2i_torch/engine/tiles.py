"""The port's copy of ds2i_tpu/engine/tiles.py (numpy only).

The port imports nothing of the JAX package, so this copy is permanent;
tests/test_torch_tiles.py pins it to the original.

Host-side tile tables: 128-value tiles over every posting list.

The scatter-free device decode (tile_executor) needs fixed-size work
units. At index-load time every list is cut into tiles of <= 128 values on
the COMMON REFINEMENT of its docs-segment and freqs-segment boundaries, so
each tile lies inside exactly one segment of each stream and both streams
of a tile decode into the same flat 128-slot range (value-aligned).

Per tile and per stream we precompute the exact select window (bit range
covering the tile's ones), the EF reconstruction constants, and the
low-bits window — all derived from the compressed bits + the skip
structure, once, on the host. The device then needs only contiguous
window gathers: no scatter anywhere.

Tile fields (per stream):
  kind        SEG_* or -1
  win_word0   first uint32 word of the select window
  win_bitoff  bit offset of the window start within that word
  win_len     window length in bits
  sel_adj     EF: ones_rel[c0]-c0-1; RB: ones_rel[c0]
  lower_bits  EF low-bits width
  lb_word0 / lb_bitoff   low-bits window position for the tile
  base        value base (segment base + c0 for strict/AO kinds)
  n_vals      values in the tile (<= 128)
"""

from dataclasses import dataclass

import numpy as np

from ..ops.segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB, SegmentTable, sequence_segments

TILE = 128
N_FIELDS = 11
(F_KIND, F_WIN_WORD0, F_WIN_BITOFF, F_WIN_LEN, F_SEL_ADJ, F_LOWER_BITS,
 F_LB_WORD0, F_LB_BITOFF, F_BASE, F_NVALS, F_PREV_CUM) = range(N_FIELDS)


@dataclass
class TileTables:
    docs: np.ndarray  # (num_tiles, N_FIELDS) int32
    freqs: np.ndarray  # (num_tiles, N_FIELDS) int32
    tile_list: np.ndarray  # (num_tiles,) list id
    list_tile_start: np.ndarray  # (num_lists + 1,) tile ranges per list
    win_words: np.ndarray  # (num_tiles,) max select-window words (both streams)
    lb_words: np.ndarray  # (num_tiles,) max low-bits window words


def _segment_boundaries(segs, lo, hi):
    """Value-index boundaries of a SegmentTable slice."""
    out = set()
    for s in range(lo, hi):
        out.add(int(segs.out_begin[s]))
        out.add(int(segs.out_begin[s]) + int(segs.n_vals[s]))
    return out


def _locate_segment(segs, lo, hi, a):
    """Segment index in [lo,hi) whose [out_begin, out_begin+n) contains a."""
    for s in range(lo, hi):
        ob = int(segs.out_begin[s])
        if ob <= a < ob + int(segs.n_vals[s]):
            return s
    raise AssertionError("tile start not covered by any segment")


def _tile_fields(bv, segs, s, a, b, out_row, ones_cache):
    """Fill one stream's tile fields for values [a, b) of the list, which
    lie inside segment s. Returns (win_words, lb_words)."""
    kind = int(segs.kind[s])
    base = int(segs.base[s])
    c0 = a - int(segs.out_begin[s])
    cnt = b - a
    out_row[F_KIND] = kind
    out_row[F_NVALS] = cnt

    if kind == SEG_AO:
        out_row[F_BASE] = base + c0
        return 1, 1

    sel_start = int(segs.sel_start[s])
    rel = ones_cache.get(s)
    if rel is None:
        ones = bv.select_ones(sel_start, sel_start + int(segs.sel_len[s]))
        rel = ones.astype(np.int64) - sel_start
        ones_cache[s] = rel
    first = int(rel[c0])
    last = int(rel[c0 + cnt - 1])
    win_start = sel_start + first
    win_len = last - first + 1
    out_row[F_WIN_WORD0] = win_start >> 5
    out_row[F_WIN_BITOFF] = win_start & 31
    out_row[F_WIN_LEN] = win_len
    win_words = ((win_start & 31) + win_len + 31) // 32

    if kind == SEG_RB:
        out_row[F_SEL_ADJ] = first
        out_row[F_BASE] = base
        return win_words, 1

    # EF / EF_STRICT
    l = int(segs.lower_bits[s])
    out_row[F_SEL_ADJ] = first - c0 - 1
    out_row[F_LOWER_BITS] = l
    lb_start = int(segs.lb_start[s]) + c0 * l
    out_row[F_LB_WORD0] = lb_start >> 5
    out_row[F_LB_BITOFF] = lb_start & 31
    out_row[F_BASE] = base + (c0 if kind == SEG_EF_STRICT else 0)
    lb_words = (((lb_start & 31) + cnt * l) + 31) // 32 if l else 1
    return win_words, max(lb_words, 1)


def _tile_last_value(bv, segs, s, b, ones_cache):
    """Absolute decoded value of element b-1 of the stream, which lies in
    segment s. Used to seed the next tile's F_PREV_CUM so that freq
    reconstruction (cum diff) is fully tile-local on device."""
    kind = int(segs.kind[s])
    base = int(segs.base[s])
    c = b - 1 - int(segs.out_begin[s])
    if kind == SEG_AO:
        return base + c
    rel = ones_cache[s]  # populated by _tile_fields for this tile
    if kind == SEG_RB:
        return base + int(rel[c])
    l = int(segs.lower_bits[s])
    low = int(bv.get_bits(int(segs.lb_start[s]) + c * l, l)) if l else 0
    v = ((int(rel[c]) - c - 1) << l) | low
    if kind == SEG_EF_STRICT:
        v += c
    return base + v


def build_tile_tables(index, cache_selects=True):
    """Cut every list into value-aligned tiles; precompute decode windows.

    Plain-`ef` indexes (one EF segment per stream) take a fully
    vectorized fast path (tiles_fast.build_tile_tables_ef, identical
    output); other compositions use the generic per-list walk below."""
    try:
        from ..index.types import is_plain_ef_index
        if is_plain_ef_index(index):
            from .tiles_fast import build_tile_tables_ef
            return build_tile_tables_ef(index)
    except ImportError:
        pass
    params = index.params
    num_docs = index.num_docs()
    docs_bv = index.docs_sequences.bits()
    freqs_bv = index.freqs_sequences.bits()
    freq_offsets = index.freqs_sequences.endpoints()

    if cache_selects:
        docs_bv.bits()
        freqs_bv.bits()

    d_rows, f_rows, tile_list = [], [], []
    win_words, lb_words = [], []
    list_tile_start = [0]

    dt = SegmentTable()
    ft = SegmentTable()
    for i in range(index.size()):
        occurrences, n, docs_offset = index._header(i)
        d0 = len(dt)
        sequence_segments(index.docs_sequence_type, docs_bv, docs_offset, num_docs, n, params, dt, list_id=i)
        f0 = len(ft)
        sequence_segments(
            index.freqs_sequence_type, freqs_bv, int(freq_offsets[i]), occurrences + 1, n, params, ft, list_id=i
        )
        d1, f1 = len(dt), len(ft)

        # common refinement of stream boundaries, cut to <=128 steps
        bset = _segment_boundaries(dt, d0, d1) | _segment_boundaries(ft, f0, f1)
        bounds = sorted(bset)
        tiles = []
        for a, b in zip(bounds, bounds[1:]):
            while b - a > TILE:
                tiles.append((a, a + TILE))
                a += TILE
            if b > a:
                tiles.append((a, b))

        d_ones, f_ones = {}, {}
        d_last, f_last = 0, 0
        for a, b in tiles:
            drow = np.zeros(N_FIELDS, dtype=np.int32)
            frow = np.zeros(N_FIELDS, dtype=np.int32)
            ds = _locate_segment(dt, d0, d1, a)
            fs = _locate_segment(ft, f0, f1, a)
            dw, dl = _tile_fields(docs_bv, dt, ds, a, b, drow, d_ones)
            fw, fl = _tile_fields(freqs_bv, ft, fs, a, b, frow, f_ones)
            drow[F_PREV_CUM] = d_last
            frow[F_PREV_CUM] = f_last
            d_last = _tile_last_value(docs_bv, dt, ds, b, d_ones)
            f_last = _tile_last_value(freqs_bv, ft, fs, b, f_ones)
            d_rows.append(drow)
            f_rows.append(frow)
            tile_list.append(i)
            win_words.append(max(dw, fw))
            lb_words.append(max(dl, fl))
        list_tile_start.append(len(tile_list))

    return TileTables(
        docs=np.array(d_rows, dtype=np.int32).reshape(-1, N_FIELDS),
        freqs=np.array(f_rows, dtype=np.int32).reshape(-1, N_FIELDS),
        tile_list=np.array(tile_list, dtype=np.int64),
        list_tile_start=np.array(list_tile_start, dtype=np.int64),
        win_words=np.array(win_words, dtype=np.int32),
        lb_words=np.array(lb_words, dtype=np.int32),
    )
