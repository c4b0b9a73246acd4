"""Scatter-free tiled query engine: the port of
ds2i_tpu/engine/tile_executor.py (TileQueryEngine, the third of the JAX
package's engine generations, the successor of flat_executor with every
scatter gone). A query batch runs as one pass of device work (split only
past `max_postings` padded postings, or where the composite sort key
would outgrow int32):

  1. per (W, WL) group of 128-value tiles (engine/tiles.py), each stream
     decoded by one launch of ops.pair_decode.decode_group (K6g,
     csrc/tile_decode.cu, on the card): the select of each slot's one in
     the tile's high-bits window, its low bits, the value by kind
  2. tile values -> flat postings stream by a row gather with a host
     tile permutation; freq cums padded with -(2**31)+1, then cummax
     along the tile, so pads inherit the running cum
  3. per-posting BM25; query row, qw and AND target ride along per tile
  4. ONE stable sort by composite key (row*D' + doc); duplicate runs
     summed by tmax-1 shifted adds, in the JAX engine's order
  5. AND/OR counts from row-boundary prefix diffs
  6. top-k: the lexicographic (row, -score) sort as a stable sort by
     -score, then a stable sort by row, and a (B, k) slice gather.

The gathers, sorts, cummax and prefix sums are plain PyTorch calls
(`torch.sort(stable=True)`, `cummax`, `cumsum`), as they were XLA
library ops outside any Pallas kernel in the JAX engine. Counts are
exact; the run sums add in the JAX engine's order over a stable sort, so
scores agree with the oracle within the reference's rtol 1e-3
(test_ranked_queries.cpp:52), and with this engine's run on another
device bit for bit. WAND and MaxScore return exactly the exhaustive
top-k, so they alias ranked_or.
"""

import numpy as np
import torch

from ..ops import pair_decode  # its names are read at call time: it imports engine.tiles
from ..queries.bm25 import BM25
from .device_index import _pow_at_least
from .executor import _device_index, _norm_lens, bm25_contrib, collect, shift, topk_list
from .flat_executor import prep_terms
from .tiles import F_KIND, F_NVALS, N_FIELDS, TILE, build_tile_tables

_F32 = np.float32
_I32 = np.int32
NEG_INF = float("-inf")


def _tile_step(docs_words, freqs_words, gfields, perm, tile_row, tile_qw, tile_tgt, tile_first,
               row_start, row_lenq, norm_lens, groups, P, B, Dp, k, ops, tmax=8):
    """gfields int32 (Rtotal, 2*N_FIELDS): docs fields | freqs fields,
    group-major; perm int32 (P/TILE,): flat tile t <- group-major row
    perm[t]; tile_row, tile_qw, tile_tgt, tile_first per flat tile;
    row_start int32 (B+1,), row_lenq int32 (B,); groups ((offset, R, W,
    WL), ...); ops: a subset of ("counts", "or", "and"); tmax bounds the
    run lengths (terms a query)."""
    num_docs = Dp - 1
    T = P // TILE
    dev = gfields.device

    dvals, fvals, dmask = [], [], []
    for off, R, W, WL in groups:
        df = gfields[off : off + R, :N_FIELDS].contiguous()
        ff = gfields[off : off + R, N_FIELDS:].contiguous()
        dvals.append(pair_decode.decode_group(docs_words, df, W, WL))
        fvals.append(pair_decode.decode_group(freqs_words, ff, W, WL))
        nv = df[:, F_NVALS][:, None]
        dmask.append(torch.arange(TILE, dtype=torch.int32, device=dev)[None, :] < nv)

    dall = torch.cat(dvals, dim=0)
    fall = torch.cat(fvals, dim=0)
    mall = torch.cat(dmask, dim=0)

    # flat assembly: contiguous row gather by tile permutation
    perm = perm.long()
    doc_t = torch.where(mall, dall, num_docs)[perm]  # (T, TILE)
    cum_t = torch.where(mall, fall, -(2**31) + 1)[perm]
    # pads inherit the running cum (values nondecreasing within a tile)
    cum_t = torch.cummax(cum_t, dim=1).values

    doc = doc_t.reshape(P)
    cum = cum_t.reshape(P)
    jj = torch.arange(TILE, dtype=torch.int32, device=dev)[None, :]
    first = (tile_first[:, None] & (jj == 0)).reshape(P)
    rowv = tile_row[:, None].expand(T, TILE).reshape(P)
    qwv = tile_qw[:, None].expand(T, TILE).reshape(P)
    tgtv = tile_tgt[:, None].expand(T, TILE).reshape(P)

    real = doc < num_docs
    freq = torch.where(first, cum, cum - shift(cum, 1, 0))

    if ("or" in ops) or ("and" in ops):
        contrib = bm25_contrib(qwv, freq, doc, real, norm_lens, num_docs)
    else:
        contrib = torch.zeros(P, dtype=torch.float32, device=dev)

    key = rowv * Dp + doc  # pads: row*Dp + num_docs -> end of their row
    one = real.to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    scontrib, sone, stgt = contrib[order], one[order], tgtv[order]

    nxt = torch.cat([skey[1:], torch.full((1,), -1, dtype=skey.dtype, device=dev)])
    last = skey != nxt
    # runs of equal (row, doc) keys are at most `tmax` long (one posting per
    # term); accumulate run sums with tmax-1 shifted adds — no scans needed
    run_score = scontrib
    run_cnt = sone
    match = torch.ones(P, dtype=torch.bool, device=dev)
    for m in range(1, tmax):
        match = match & (skey == shift(skey, m, -2))
        run_score = run_score + torch.where(match, shift(scontrib, m, 0.0), 0.0)
        run_cnt = run_cnt + torch.where(match, shift(sone, m, 0), 0)

    srow = torch.div(skey, Dp, rounding_mode="floor")
    sdoc = skey - srow * Dp
    run_last = last & (srow < B) & (sdoc < num_docs)
    and_run = run_last & (run_cnt == stgt) & (stgt > 0)

    c_or = torch.cumsum(run_last.to(torch.int32), dim=0)
    c_and = torch.cumsum(and_run.to(torch.int32), dim=0)
    lo = row_start[:B].long()
    hi = lo + row_lenq.long()

    def prefix_at(c, i):
        return torch.where(i > 0, c[(i - 1).clamp(0, P - 1)], 0)

    or_counts = (prefix_at(c_or, hi) - prefix_at(c_or, lo)).to(torch.int32)
    and_counts = (prefix_at(c_and, hi) - prefix_at(c_and, lo)).to(torch.int32)

    out = [and_counts, or_counts]
    kk = torch.arange(k, device=dev)[None, :]
    for op in ("or", "and"):
        if op not in ops:
            out.append(torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev))
            continue
        flag = run_last if op == "or" else and_run
        negs = torch.where(flag, -run_score, torch.inf)
        # lexicographic (srow, negs): a stable sort by negs, then by srow
        by_score = torch.sort(negs, stable=True).indices
        by_row = torch.sort(srow[by_score], stable=True).indices
        s2 = negs[by_score][by_row]
        idx = (lo[:, None] + kk).clamp(0, P - 1)
        topk = -s2[idx]
        topk = torch.where(kk < row_lenq[:, None], topk, NEG_INF)
        out.append(topk)
    # out: and_counts, or_counts, topk_or, topk_and
    return out[0], out[1], out[2], out[3]


class TileQueryEngine:
    """Scatter-free tiled engine; one pass of device work per query batch."""

    def __init__(self, index, wdata=None, scorer=BM25, max_postings=1 << 23, device=None):
        """index: an index built by this package, or a DeviceIndex (whose
        device the engine takes). device: None for the CUDA card, "cpu"
        for the plain PyTorch path."""
        self.dindex = _device_index(index, device)
        self.device = self.dindex.device
        index = self.dindex.index
        self.num_docs = self.dindex.num_docs
        self.Dp = self.num_docs + 1
        self.scorer = scorer
        self.norm_lens = _norm_lens(wdata, self.num_docs, self.device)
        self.tiles = build_tile_tables(index)
        self.max_postings = max_postings
        # per-list padded tile counts
        self.list_tiles = np.diff(self.tiles.list_tile_start)

    # -- host batch layout ----------------------------------------------------

    def _build_batch(self, terms, qw, counts):
        t = self.tiles
        B = len(counts)
        assert (B + 1) * self.Dp < 2**31, "composite sort key must fit int32"

        # tiles of each requested list, flat (query-major, list-major) order
        tstarts = t.list_tile_start[terms]
        tcounts = self.list_tiles[terms]
        total_tiles = int(tcounts.sum())
        if total_tiles:
            excl = np.cumsum(tcounts) - tcounts
            tidx = np.repeat(tstarts - excl, tcounts) + np.arange(total_tiles, dtype=np.int64)
            span_of_tile = np.repeat(np.arange(len(terms), dtype=np.int64), tcounts)
        else:
            tidx = np.zeros(0, dtype=np.int64)
            span_of_tile = np.zeros(0, dtype=np.int64)

        qend = np.cumsum(counts)
        qstart = qend - counts
        span_row = np.repeat(np.arange(B, dtype=_I32), counts)

        Tn = _pow_at_least(max(total_tiles, 1), lo=2)
        P = Tn * TILE

        # group tiles by pow4 window buckets (few groups -> big fused ops;
        # up to 4x padded decode work is cheaper than fragmented dispatch)
        ww = np.maximum(t.win_words[tidx], 1)
        wl = np.maximum(t.lb_words[tidx], 1)
        wb = 1 << (2 * np.ceil(np.log2(np.maximum(ww, 4)) / 2).astype(np.int64))
        lb = 1 << (2 * np.ceil(np.log2(np.maximum(wl, 4)) / 2).astype(np.int64))
        bkey = wb * 1024 + lb
        order = np.argsort(bkey, kind="stable")

        groups = []
        gfields = np.zeros((_pow_at_least(max(total_tiles, 1), lo=8), 2 * N_FIELDS), dtype=_I32)
        gfields[:, F_KIND] = -1
        gfields[:, N_FIELDS + F_KIND] = -1
        sk = bkey[order] if total_tiles else np.zeros(0, dtype=np.int64)
        boundaries = np.nonzero(np.diff(sk))[0] + 1 if total_tiles else np.zeros(0, np.int64)
        gstarts = np.concatenate([[0], boundaries, [total_tiles]]).astype(np.int64)
        off = 0
        perm_inv = np.zeros(Tn, dtype=_I32)
        for gi in range(len(gstarts) - 1):
            lo_i, hi_i = int(gstarts[gi]), int(gstarts[gi + 1])
            if hi_i <= lo_i:
                continue
            sel = order[lo_i:hi_i]
            W = int(wb[sel[0]])
            WL = int(lb[sel[0]])
            R = _pow_at_least(hi_i - lo_i + 1, lo=64)  # always >=1 padding row
            if off + R > len(gfields):
                grown = np.zeros((_pow_at_least(off + R, lo=8), 2 * N_FIELDS), dtype=_I32)
                grown[:, F_KIND] = -1
                grown[:, N_FIELDS + F_KIND] = -1
                grown[: len(gfields)] = gfields
                gfields = grown
            gfields[off : off + (hi_i - lo_i), :N_FIELDS] = t.docs[tidx[sel]]
            gfields[off : off + (hi_i - lo_i), N_FIELDS:] = t.freqs[tidx[sel]]
            perm_inv[sel] = off + np.arange(hi_i - lo_i, dtype=_I32)
            groups.append((off, R, W, WL))
            off += R
        gfields = gfields[:off] if off else np.zeros((8, 2 * N_FIELDS), dtype=_I32)
        if off == 0:
            groups = [(0, 8, 1, 4)]
            gfields = np.zeros((8, 2 * N_FIELDS), dtype=_I32)
            gfields[:, F_KIND] = -1
            gfields[:, N_FIELDS + F_KIND] = -1
            off = 8

        # flat-order per-tile tables
        perm = np.full(Tn, off - 1, dtype=_I32)
        perm[:total_tiles] = perm_inv[:total_tiles]
        tile_row = np.full(Tn, B, dtype=_I32)
        tile_qw = np.zeros(Tn, dtype=_F32)
        tile_tgt = np.zeros(Tn, dtype=_I32)
        tile_first = np.zeros(Tn, dtype=bool)
        if total_tiles:
            tile_row[:total_tiles] = span_row[span_of_tile]
            tile_qw[:total_tiles] = qw[span_of_tile]
            tile_tgt[:total_tiles] = counts[span_row[span_of_tile]]
            firsts = np.zeros(total_tiles, dtype=bool)
            span_first = np.cumsum(tcounts) - tcounts
            firsts[span_first[tcounts > 0]] = True
            tile_first[:total_tiles] = firsts

        # per-row flat spans
        row_tiles = np.zeros(B, dtype=np.int64)
        np.add.at(row_tiles, span_row, tcounts)
        row_start = np.zeros(B + 1, dtype=_I32)
        row_start[1:] = np.cumsum(row_tiles) * TILE
        row_lenq = (row_tiles * TILE).astype(_I32)

        return groups, gfields, perm, tile_row, tile_qw, tile_tgt, tile_first, row_start, row_lenq, P, B

    def run(self, queries, k=10, ops=("or", "and"), ranked=True):
        terms_all, qw_all, counts_all = prep_terms(self.dindex, queries, ranked)
        qend = np.cumsum(counts_all)
        qstart = qend - counts_all

        # postings budget split (padded tiles)
        if len(terms_all):
            tposts = self.list_tiles[terms_all] * TILE
            safe = np.minimum(qstart, len(terms_all) - 1)
            qpost = np.add.reduceat(tposts, safe)
            qpost = np.where(counts_all > 0, qpost, 0)
        else:
            qpost = np.zeros(len(counts_all), dtype=np.int64)

        max_B = (2**31) // self.Dp - 2  # composite sort key must fit int32
        parts, cur, cur_p = [], [], 0
        for qi in range(len(queries)):
            pl = int(qpost[qi])
            if cur and (cur_p + pl > self.max_postings or len(cur) >= max_B):
                parts.append(cur)
                cur, cur_p = [], 0
            cur.append(qi)
            cur_p += pl
        if cur:
            parts.append(cur)

        pending = []
        for part in parts:
            sel = (
                np.concatenate([np.arange(qstart[j], qend[j]) for j in part]).astype(np.int64)
                if part
                else np.zeros(0, np.int64)
            )
            (groups, gfields, perm, tile_row, tile_qw, tile_tgt, tile_first,
             row_start, row_lenq, P, B) = self._build_batch(
                terms_all[sel], qw_all[sel], counts_all[part]
            )
            up = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            out = _tile_step(
                self.dindex.docs_words,
                self.dindex.freqs_words,
                up(gfields),
                up(perm),
                up(tile_row),
                up(tile_qw),
                up(tile_tgt),
                up(tile_first),
                up(row_start),
                up(row_lenq),
                self.norm_lens,
                groups=tuple(groups),
                P=P,
                B=B,
                Dp=self.Dp,
                k=k,
                ops=tuple(ops),
                tmax=_pow_at_least(int(counts_all[part].max()) if len(part) else 1, lo=4),
            )
            pending.append((part, out))
        return collect(pending, len(queries))

    # -- public ops -----------------------------------------------------------

    def and_counts(self, queries):
        return np.array([r[0] for r in self.run(queries, ops=("counts",), ranked=False)])

    def or_counts(self, queries):
        return np.array([r[1] for r in self.run(queries, ops=("counts",), ranked=False)])

    def ranked_or(self, queries, k=10):
        return [topk_list(r[2]) for r in self.run(queries, k=k, ops=("or",))]

    def ranked_and(self, queries, k=10):
        return [topk_list(r[3]) for r in self.run(queries, k=k, ops=("and",))]

    wand = ranked_or
    maxscore = ranked_or
