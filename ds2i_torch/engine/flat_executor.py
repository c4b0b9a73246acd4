"""Single-pass flat-postings query engine: the port of
ds2i_tpu/engine/flat_executor.py (FlatQueryEngine, the second of the JAX
package's engine generations).

A query batch runs as one pass of dense tensor work (split only past
`max_postings`):

  1. segment decode, grouped by select-window size (pow4-bucketed, as
     in the JAX engine), each group one launch of ops.decode.decode_rows
     (K9 on the card), scattered into a flat postings stream: doc[P],
     row[P], qw[P], cum[P] (the JAX engine's mode="drop" scatters become
     writes into a P+1 buffer whose spare slot takes every pad, sliced)
  2. freqs from prefix-sum diffs within list spans
  3. per-posting BM25 contribution
  4. ONE stable sort by composite key row*D' + doc, the contributions
     and ones gathered after it (the JAX engine's multi-operand
     lax.sort)
  5. duplicate-run aggregation by prefix sums and cummax over the run
     starts (from -inf for the scores, -1 for the counts)
  6. boolean AND/OR counts from run and row boundary arithmetic
  7. per-row windowed gather + top-k, grouped by union size.

The scatters, the sort, the prefix sums, cummax and top-k are plain
PyTorch calls (`index_put_`, `torch.sort(stable=True)`, `cumsum`,
`cummax`, `topk`), as they were XLA library ops outside any Pallas kernel
in the JAX engine. One change of arithmetic: the run sums take their
prefix sum of the contributions in float64, then round each run's sum to
float32. The JAX engine's float32 prefix sum over a part of up to 2^23
postings grows to ~10^7, where a float32 step is ~1, so a run's
difference of two prefixes loses its digits; in float64 each run's sum
is its exact sum rounded once. Counts are exact; scores agree with the
oracle within the reference's rtol 1e-3 (test_ranked_queries.cpp:52).
WAND and MaxScore return exactly the exhaustive top-k, so they alias
ranked_or.
"""

import numpy as np
import torch

from ..ops.decode import FIELDS, check_bit_offsets, decode_rows
from ..queries.bm25 import BM25
from ..queries.parsing import query_freqs
from .device_index import _pow_at_least
from .executor import _device_index, _norm_lens, bm25_contrib, collect, shift, topk_list

_F32 = np.float32
_I32 = np.int32

NEG_INF = float("-inf")


def _flat_step(docs_words, freqs_words, segs, seg_qw, seg_row, rows_tab, tg_rows, norm_lens,
               dgroups, tgroups, P, B, Dp, k, with_scores):
    """segs int32 (Rtotal, 9) fields, seg_qw f32 and seg_row int32 (Rtotal,),
    rows_tab int32 (B+1, 3): row_start, row_len, target; tg_rows int32 the
    top-k groups' rows; dgroups ((offset, R, W, Lseg, is_freqs), ...),
    tgroups ((offset, Bh, X), ...)."""
    num_docs = Dp - 1
    dev = segs.device

    doc = torch.full((P + 1,), num_docs, dtype=torch.int32, device=dev)
    row = torch.full((P + 1,), B, dtype=torch.int32, device=dev)
    qwf = torch.zeros(P + 1, dtype=torch.float32, device=dev)
    cum = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    first = torch.zeros(P + 1, dtype=torch.bool, device=dev)

    for off, R, W, Lseg, is_freqs in dgroups:
        pack = segs[off : off + R]
        f = {name: pack[:, i] for i, name in enumerate(FIELDS)}
        j = torch.arange(Lseg, dtype=torch.int32, device=dev)
        vals = decode_rows(
            freqs_words if is_freqs else docs_words,
            f["kind"], f["sel_start"], f["sel_len"], f["lb_start"],
            f["lower_bits"], f["n_vals"], f["base"],
            torch.zeros_like(f["out_begin"]),
            torch.arange(R, dtype=torch.int32, device=dev),
            f["n_vals"],
            W=W, Lseg=Lseg, rows=R, L_out=Lseg, sentinel=-1,
        )
        valid = j[None, :] < f["n_vals"][:, None]
        fidx = torch.where(valid, f["list_row"][:, None] + f["out_begin"][:, None] + j[None, :],
                           P).long()
        if is_freqs:
            cum[fidx] = vals
        else:
            doc[fidx] = torch.where(valid, vals, num_docs)
            row[fidx] = seg_row[off : off + R][:, None].expand(fidx.shape)
            qwf[fidx] = seg_qw[off : off + R][:, None].expand(fidx.shape)
            first[fidx] = valid & (j[None, :] == 0) & (f["out_begin"][:, None] == 0)

    doc, row, qwf, cum, first = doc[:P], row[:P], qwf[:P], cum[:P], first[:P]
    row_start = rows_tab[:, 0].long()
    row_len = rows_tab[:B, 1].long()
    target = rows_tab[:B, 2]

    real = row < B
    freq = torch.where(first, cum, cum - shift(cum, 1, 0))

    if with_scores:
        contrib = bm25_contrib(qwf, freq, doc, real, norm_lens, num_docs)
    else:
        contrib = torch.zeros(P, dtype=torch.float32, device=dev)

    key = row * Dp + torch.where(real, doc, 0)  # padding key = B*Dp, sorts last
    one = real.to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    scontrib, sone = contrib[order], one[order]

    csum = torch.cumsum(scontrib.double(), dim=0)
    ccnt = torch.cumsum(sone, dim=0)
    nxt = torch.cat([skey[1:], torch.full((1,), -1, dtype=skey.dtype, device=dev)])
    last = skey != nxt
    first_run = skey != shift(skey, 1, -1)
    # exclusive prefix at each run's start, carried across the run (cummax
    # works because contribs are nonnegative, so the prefixes never fall)
    base_s = torch.cummax(torch.where(first_run, csum - scontrib.double(), NEG_INF), 0).values
    base_c = torch.cummax(torch.where(first_run, ccnt - sone, -1), 0).values
    run_score = (csum - base_s).to(torch.float32)
    run_cnt = ccnt - base_c

    srow = torch.div(skey, Dp, rounding_mode="floor")
    sreal = srow < B
    run_last = last & sreal
    tgt = target[srow.clamp(0, B - 1).long()]
    and_run = run_last & (run_cnt == tgt) & (tgt > 0)

    # per-row counts: cumsum of flags diffed at row boundaries (postings were
    # laid out row-major, so sorted row spans coincide with row_start/.._len)
    c_or = torch.cumsum(run_last.to(torch.int32), dim=0)
    c_and = torch.cumsum(and_run.to(torch.int32), dim=0)
    bnd_lo = row_start[:B]
    bnd_hi = row_start[:B] + row_len

    def prefix_at(c, i):
        return torch.where(i > 0, c[(i - 1).clamp(0, P - 1)], 0)

    or_counts = (prefix_at(c_or, bnd_hi) - prefix_at(c_or, bnd_lo)).to(torch.int32)
    and_counts = (prefix_at(c_and, bnd_hi) - prefix_at(c_and, bnd_lo)).to(torch.int32)

    if not with_scores:
        z = torch.zeros((B, k), dtype=torch.float32, device=dev)
        return and_counts, or_counts, z, z

    score_or = torch.where(run_last, run_score, NEG_INF)
    score_and = torch.where(and_run, run_score, NEG_INF)

    topk_or = torch.full((B + 1, k), NEG_INF, dtype=torch.float32, device=dev)
    topk_and = torch.full((B + 1, k), NEG_INF, dtype=torch.float32, device=dev)
    for off, Bh, X in tgroups:
        rh = tg_rows[off : off + Bh].long()
        start = row_start[rh.clamp(0, B)]
        jj = torch.arange(X, device=dev)[None, :]
        idx = (start[:, None] + jj).clamp(0, P - 1)
        win_valid = (jj < row_len[rh.clamp(0, B - 1)][:, None]) & (rh < B)[:, None]
        w_or = torch.where(win_valid, score_or[idx], NEG_INF)
        w_and = torch.where(win_valid, score_and[idx], NEG_INF)
        topk_or[rh] = torch.topk(w_or, k, dim=1).values
        topk_and[rh] = torch.topk(w_and, k, dim=1).values

    return and_counts, or_counts, topk_or[:B], topk_and[:B]


def prep_terms(dindex, queries, ranked):
    """Vectorized query prep: (flat term ids, flat BM25 query weights, 1.0
    each unless ranked, and terms a query) over the whole batch."""
    tf = [query_freqs(t) for t in queries]
    counts = np.array([len(x) for x in tf], dtype=np.int64)
    terms = np.array([t for q in tf for t, _ in q], dtype=np.int64)
    qmult = np.array([m for q in tf for _, m in q], dtype=np.int64)
    if ranked and len(terms):
        dfs = dindex.list_n[terms].astype(_F32)
        N = _F32(dindex.num_docs)
        idf = np.log((N - dfs + _F32(0.5)) / (dfs + _F32(0.5))).astype(_F32)
        qw = qmult.astype(_F32) * np.maximum(_F32(1e-6), idf) * (_F32(1.0) + BM25.k1)
    else:
        qw = np.ones(len(terms), dtype=_F32)
    return terms, qw, counts


class FlatQueryEngine:
    """One pass of device work per query batch against a DeviceIndex."""

    def __init__(self, index, wdata=None, scorer=BM25, max_postings=1 << 23, device=None):
        """index: an index built by this package, or a DeviceIndex (whose
        device the engine takes). device: None for the CUDA card, "cpu"
        for the plain PyTorch path."""
        self.dindex = _device_index(index, device)
        self.device = self.dindex.device
        self.num_docs = self.dindex.num_docs
        self.Dp = self.num_docs + 1
        self.wdata = wdata
        self.scorer = scorer
        self.norm_lens = _norm_lens(wdata, self.num_docs, self.device)
        self.max_postings = max_postings

    def _build_batch(self, terms, qw, counts):
        d = self.dindex
        B = len(counts)
        assert (B + 1) * self.Dp < 2**31, "composite sort key must fit int32"

        span_n = d.list_n[terms].astype(np.int64)
        span_end = np.cumsum(span_n)
        span_start = (span_end - span_n).astype(_I32)
        qend = np.cumsum(counts)
        qstart = qend - counts
        span_row = np.repeat(np.arange(B, dtype=_I32), counts)

        rows_tab = np.zeros((B + 1, 3), dtype=_I32)
        if len(terms):
            rows_tab[:B, 0] = span_start[np.minimum(qstart, len(terms) - 1)]
            rows_tab[:B, 0] = np.where(counts > 0, rows_tab[:B, 0], 0)
        total = int(span_end[-1]) if len(terms) else 0
        rows_tab[B, 0] = total
        rows_tab[:B, 1] = (
            (np.where(counts > 0, span_end[np.maximum(qend - 1, 0)], 0) - rows_tab[:B, 0])
            if len(terms)
            else 0
        )
        rows_tab[:B, 2] = counts
        P = _pow_at_least(max(total, 1), lo=256)

        gd = d._gather_segments(d.docs_segs, d.d_ranges, terms)
        gf = d._gather_segments(d.freqs_segs, d.f_ranges, terms)
        for g in (gd, gf):
            check_bit_offsets(g["sel_start"], g["sel_len"], g["lb_start"], g["lower_bits"],
                              g["n_vals"])

        # bucket segments of both streams jointly by pow4 window words
        groups = []  # (desc, seg_matrix, qw, row)
        for g, is_freqs in ((gd, 0), (gf, 1)):
            span_idx = g["list_row"]
            wwords = ((g["sel_start"] & 31) + g["sel_len"] + 31) // 32
            buck = np.ceil(np.log2(np.maximum(wwords, 1)) / 2).astype(np.int64)  # pow4 exp
            order = np.argsort(buck, kind="stable")
            sb = buck[order]
            edges = np.searchsorted(sb, np.arange(sb[-1] + 2 if len(sb) else 1))
            for e in range(len(edges) - 1):
                lo, hi = int(edges[e]), int(edges[e + 1])
                if hi <= lo:
                    continue
                idx = order[lo:hi]
                W = 4**e
                Lseg = _pow_at_least(int(g["n_vals"][idx].max()), lo=8, base=4)
                R = _pow_at_least(len(idx), lo=8)
                mat = np.zeros((R, len(FIELDS)), dtype=_I32)
                mat[:, 0] = -1
                mat[:, 8] = P
                for i, name in enumerate(FIELDS):
                    if name == "list_row":
                        mat[: len(idx), i] = span_start[span_idx[idx]]
                    else:
                        mat[: len(idx), i] = g[name][idx]
                rowv = np.full(R, B, dtype=_I32)
                rowv[: len(idx)] = span_row[span_idx[idx]]
                qwv = np.zeros(R, dtype=_F32)
                qwv[: len(idx)] = qw[span_idx[idx]]
                groups.append(((W, Lseg, is_freqs), mat, qwv, rowv))

        dgroups = []
        off = 0
        mats, qws, rows_ = [], [], []
        for (W, Lseg, is_freqs), mat, qwv, rowv in groups:
            R = len(mat)
            dgroups.append((off, R, W, Lseg, is_freqs))
            mats.append(mat)
            qws.append(qwv)
            rows_.append(rowv)
            off += R
        seg_mat = np.concatenate(mats) if mats else np.zeros((0, len(FIELDS)), _I32)
        seg_qw = np.concatenate(qws) if qws else np.zeros(0, _F32)
        seg_row = np.concatenate(rows_) if rows_ else np.zeros(0, _I32)

        # top-k groups by pow4 union width
        row_len = rows_tab[:B, 1]
        tbuck = np.ceil(np.log2(np.maximum(row_len, 1)) / 2).astype(np.int64)
        torder = np.argsort(tbuck, kind="stable")
        tsb = tbuck[torder]
        tedges = np.searchsorted(tsb, np.arange((tsb[-1] + 2) if B else 1))
        tgroups, trows = [], []
        toff = 0
        for e in range(len(tedges) - 1):
            lo, hi = int(tedges[e]), int(tedges[e + 1])
            if hi <= lo:
                continue
            idx = torder[lo:hi]
            X = max(4**e, 16)
            Bh = _pow_at_least(len(idx), lo=8)
            arr = np.full(Bh, B, dtype=_I32)
            arr[: len(idx)] = idx
            tgroups.append((toff, Bh, X))
            trows.append(arr)
            toff += Bh
        tg_rows = np.concatenate(trows) if trows else np.zeros(0, _I32)

        return (
            tuple(dgroups),
            tuple(tgroups),
            seg_mat,
            seg_qw,
            seg_row,
            rows_tab,
            tg_rows,
            P,
            B,
        )

    def run(self, queries, k=10, with_scores=True, ranked=True):
        terms_all, qw_all, counts_all = prep_terms(self.dindex, queries, ranked)
        # split into sub-batches only if the postings budget is exceeded
        span_n = self.dindex.list_n[terms_all].astype(np.int64) if len(terms_all) else np.zeros(0)
        qend = np.cumsum(counts_all)
        qstart = qend - counts_all
        if len(terms_all):
            safe_qstart = np.minimum(qstart, len(terms_all) - 1)
            qpost = np.add.reduceat(span_n, safe_qstart)
            qpost = np.where(counts_all > 0, qpost, 0)
        else:
            qpost = np.zeros(len(counts_all), dtype=np.int64)

        parts = []
        cur, cur_p = [], 0
        for qi in range(len(queries)):
            pl = int(qpost[qi])
            if cur and cur_p + pl > self.max_postings:
                parts.append(cur)
                cur, cur_p = [], 0
            cur.append(qi)
            cur_p += pl
        if cur:
            parts.append(cur)

        pending = []
        for part in parts:
            sel = np.concatenate([np.arange(qstart[j], qend[j]) for j in part]) if part else np.zeros(0, np.int64)
            sel = sel.astype(np.int64)
            terms = terms_all[sel]
            qw = qw_all[sel]
            counts = counts_all[part]
            dgroups, tgroups, seg_mat, seg_qw, seg_row, rows_tab, tg_rows, P, B = self._build_batch(
                terms, qw, counts
            )
            up = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            out = _flat_step(
                self.dindex.docs_words,
                self.dindex.freqs_words,
                up(seg_mat),
                up(seg_qw),
                up(seg_row),
                up(rows_tab),
                up(tg_rows),
                self.norm_lens,
                dgroups=dgroups,
                tgroups=tgroups,
                P=P,
                B=B,
                Dp=self.Dp,
                k=k,
                with_scores=with_scores,
            )
            pending.append((part, out))
        return collect(pending, len(queries))

    # -- public ops -----------------------------------------------------------

    def and_counts(self, queries):
        return np.array([r[0] for r in self.run(queries, with_scores=False, ranked=False)])

    def or_counts(self, queries):
        return np.array([r[1] for r in self.run(queries, with_scores=False, ranked=False)])

    def ranked_or(self, queries, k=10):
        return [topk_list(r[2]) for r in self.run(queries, k=k)]

    def ranked_and(self, queries, k=10):
        return [topk_list(r[3]) for r in self.run(queries, k=k)]

    wand = ranked_or
    maxscore = ranked_or
