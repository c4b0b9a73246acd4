"""The port's copy of ds2i_tpu/engine/tiles_fast.py (numpy only), carried
for the same reason as engine/tiles.py.

Vectorized tile-table construction for the plain `ef` index type.

The generic build_tile_tables walks every list in Python (segment parse,
per-tile field fill) — fine for tests, too slow for engine init at
scale. For freq_index<compact_elias_fano, positive_sequence<strict_
elias_fano>> every list is exactly one EF segment per stream, so the
whole table is closed-form: headers are gamma-parsed vectorized, EF
layouts come from the same formulas as the encoder, and per-tile select
windows come from one global flatnonzero over each bitvector plus
searchsorted. Output is identical to the generic path (tested).
"""

import numpy as np

from ..ops.segments import SEG_EF, SEG_EF_STRICT
from .tiles import (
    F_BASE, F_KIND, F_LB_BITOFF, F_LB_WORD0, F_LOWER_BITS, F_NVALS,
    F_PREV_CUM, F_SEL_ADJ, F_WIN_BITOFF, F_WIN_LEN, F_WIN_WORD0,
    N_FIELDS, TILE, TileTables,
)

_U64 = np.uint64
_I64 = np.int64


def _msb_vec(x):
    x = x.astype(np.uint64)
    r = np.zeros(x.shape, _I64)
    for s in (32, 16, 8, 4, 2, 1):
        m = (x >> _U64(s)) > 0
        r += np.where(m, s, 0)
        x = np.where(m, x >> _U64(s), x)
    return r


def _ceil_log2_vec(x):
    return np.where(x > 1, _msb_vec(np.maximum(x, 2) - 1) + 1, 0)


def _extract64(words, pos):
    """64 bits starting at bit `pos` (LSB-first), vectorized."""
    pos = pos.astype(_I64)
    w = pos >> 6
    s = (pos & 63).astype(_U64)
    padded = np.concatenate([words, np.zeros(2, dtype=_U64)])
    w0 = padded[w]
    w1 = padded[w + 1]
    hi = np.where(s > 0, w1 << (_U64(64) - s), _U64(0))
    return (w0 >> s) | hi


class _EFLayout:
    """Vectorized EFOffsets over per-list (offset, universe, n)."""

    def __init__(self, offset, universe, n, params):
        universe = universe.astype(_I64)
        n = n.astype(_I64)
        self.l = np.where(universe > n, _msb_vec(np.maximum(universe // np.maximum(n, 1), 1)), 0)
        hb_len = n + (universe >> self.l) + 2
        psize = _ceil_log2_vec(hb_len)
        p0 = (hb_len - n) >> params.ef_log_sampling0
        p1 = n >> params.ef_log_sampling1
        self.hb_off = offset + (p0 + p1) * psize
        self.hb_len = hb_len
        self.lb_off = self.hb_off + hb_len
        self.end = self.lb_off + n * self.l


def _stream_fields(bv_words, ones, lay, tl, c0, cnt, strict):
    """Per-tile fields for one EF stream. tl = list id per tile;
    arrays indexed per tile."""
    nt = len(tl)
    out = np.zeros((nt, N_FIELDS), dtype=np.int32)

    hb_off = lay.hb_off[tl]
    start_idx = lay.start_idx[tl]  # index of the list's first one in `ones`
    l = lay.l[tl]

    first = ones[start_idx + c0] - hb_off
    last = ones[start_idx + c0 + cnt - 1] - hb_off
    win_start = hb_off + first
    out[:, F_KIND] = SEG_EF_STRICT if strict else SEG_EF
    out[:, F_WIN_WORD0] = win_start >> 5
    out[:, F_WIN_BITOFF] = win_start & 31
    out[:, F_WIN_LEN] = last - first + 1
    out[:, F_SEL_ADJ] = first - c0 - 1
    out[:, F_LOWER_BITS] = l
    lb_start = lay.lb_off[tl] + c0 * l
    out[:, F_LB_WORD0] = lb_start >> 5
    out[:, F_LB_BITOFF] = lb_start & 31
    out[:, F_BASE] = c0 if strict else 0
    out[:, F_NVALS] = cnt

    # prev value (element c0-1) for tile-local freq reconstruction
    has_prev = c0 > 0
    c = np.maximum(c0 - 1, 0)
    relp = ones[start_idx + c] - hb_off
    low_off = lay.lb_off[tl] + c * l
    low = _extract64(bv_words, low_off) & ((_U64(1) << l.astype(_U64)) - _U64(1))
    prev = ((relp - c - 1) << l) | low.astype(_I64)
    if strict:
        prev = prev + c
    out[:, F_PREV_CUM] = np.where(has_prev, prev, 0)

    win_words = ((win_start & 31) + (last - first + 1) + 31) // 32
    lb_words = np.where(l > 0, ((lb_start & 31) + cnt * l + 31) // 32, 1)
    return out, win_words.astype(np.int32), np.maximum(lb_words, 1).astype(np.int32)


def build_tile_tables_ef(index):
    """Fast path for the `ef` type; returns TileTables identical to the
    generic build_tile_tables."""
    params = index.params
    num_docs = index.num_docs()
    d_bv = index.docs_sequences.bits()
    f_bv = index.freqs_sequences.bits()
    d_words = d_bv.words
    f_words = f_bv.words
    d_off = index.docs_sequences.endpoints().astype(_I64)
    f_off = index.freqs_sequences.endpoints().astype(_I64)
    nl = index.size()
    if nl == 0:
        z = np.zeros((0, N_FIELDS), np.int32)
        return TileTables(z, z, np.zeros(0, _I64), np.zeros(1, _I64),
                          np.zeros(0, np.int32), np.zeros(0, np.int32))

    # vectorized header parse: gamma_nonzero(occ) [+ n field]
    w64 = _extract64(d_words, d_off)
    lowbit = w64 & (~w64 + _U64(1))
    lz = np.bitwise_count(lowbit - _U64(1)).astype(_I64)  # trailing zeros
    nn = ((w64 >> (lz + 1).astype(_U64)) & ((_U64(1) << lz.astype(_U64)) - _U64(1))) | (
        _U64(1) << lz.astype(_U64)
    )
    occ = nn.astype(_I64)
    pos2 = d_off + 2 * lz + 1
    nb = np.where(occ > 1, _ceil_log2_vec(occ + 1), 0)
    nf = _extract64(d_words, pos2) & ((_U64(1) << nb.astype(_U64)) - _U64(1))
    n = np.where(occ > 1, nf.astype(_I64), 1)
    docs_offset = pos2 + nb

    d_lay = _EFLayout(docs_offset, np.full(nl, num_docs, _I64), n, params)
    f_lay = _EFLayout(f_off, occ - n + 2, n, params)

    d_ones = np.flatnonzero(d_bv.bits()).astype(_I64)
    f_ones = np.flatnonzero(f_bv.bits()).astype(_I64)
    d_lay.start_idx = np.searchsorted(d_ones, d_lay.hb_off)
    f_lay.start_idx = np.searchsorted(f_ones, f_lay.hb_off)

    # tiles: plain 128-value cuts (single segment per stream)
    ntiles = (n + TILE - 1) // TILE
    list_tile_start = np.zeros(nl + 1, dtype=_I64)
    np.cumsum(ntiles, out=list_tile_start[1:])
    nt = int(list_tile_start[-1])
    tl = np.repeat(np.arange(nl, dtype=_I64), ntiles)
    tidx_in_list = np.arange(nt, dtype=_I64) - np.repeat(list_tile_start[:-1], ntiles)
    c0 = tidx_in_list * TILE
    cnt = np.minimum(TILE, n[tl] - c0)

    d_rows, dw, dl = _stream_fields(d_words, d_ones, d_lay, tl, c0, cnt, strict=False)
    f_rows, fw, fl = _stream_fields(f_words, f_ones, f_lay, tl, c0, cnt, strict=True)

    return TileTables(
        docs=d_rows,
        freqs=f_rows,
        tile_list=tl,
        list_tile_start=list_tile_start,
        win_words=np.maximum(dw, fw),
        lb_words=np.maximum(dl, fl),
    )
