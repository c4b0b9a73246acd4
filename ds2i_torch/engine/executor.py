"""Batched plane query engine: the port of ds2i_tpu/engine/executor.py
(QueryEngine, the first of the JAX package's engine generations).

Every query batch runs as dense tensor work, a chunk at a time:

  segment decode (ops.decode.decode_rows: K9 on the card, from the
  compressed words on the device)
  -> per-posting BM25 contributions
  -> scatter-accumulate into a (B, num_docs + 1) score and count plane
  -> top-k.

Boolean AND/OR are count comparisons on the same plane. Queries are
sorted by their longest posting list and chunked, so each chunk's decode
window W, segment capacity Lseg and tile width L fit its own lists; all
dims are pow2-snapped as in the JAX engine. The chunk rule is the JAX
engine's: at most min(chunk, max_plane_elems / num_docs / 8) queries.

The plane's scatter-add, the top-k and the elementwise scoring are plain
PyTorch calls (`index_put_(accumulate=True)`, `topk`), as they were XLA
library ops outside any Pallas kernel in the JAX engine. Counts are
exact; the float scatter-add sums in another order than XLA's (on the
card in the order its atomics land), so scores agree with the JAX engine
and the oracle within the reference's rtol 1e-3 (test_ranked_queries.cpp:52).
WAND and MaxScore return exactly the exhaustive top-k, so they alias
ranked_or.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops.decode import FIELDS, check_bit_offsets, decode_rows
from ..queries.bm25 import BM25
from ..queries.parsing import query_freqs
from .device_index import DeviceIndex, _pow_at_least

_F32 = np.float32
_I32 = np.int32


def _decode_packed(words, packed, list_n, W, Lseg, rows, L_out, sentinel):
    return decode_rows(words, *(packed[:, i] for i in range(len(FIELDS))), list_n,
                       W=W, Lseg=Lseg, rows=rows, L_out=L_out, sentinel=sentinel)


def bm25_contrib(qw, freqs, docs, valid, norm_lens, num_docs):
    """qw * f / (f + k1 * (1 - b + b * norm_len)), f32 in the JAX engine's
    order, 0 where not valid."""
    nl = norm_lens[docs.clamp(0, num_docs - 1).long()]
    f = freqs.to(torch.float32)
    k1 = float(BM25.k1)
    b = float(BM25.b)
    contrib = qw * (f / (f + k1 * (1.0 - b + b * nl)))
    return torch.where(valid, contrib, 0.0)


def plane_counts_scores(docs, freqs, qw, norm_lens, num_docs, with_scores=True):
    """The (B, num_docs) count plane of docs (B, T, L) (pads >= num_docs)
    and, with_scores, the BM25 score plane of their freqs (B, T, L) and
    qw (B, T): index_put_ accumulates into one spare column for the pads."""
    B = docs.shape[0]
    dev = docs.device
    valid = docs < num_docs
    didx = torch.where(valid, docs, num_docs).long()
    bi = torch.arange(B, device=dev)[:, None, None].expand(docs.shape)
    counts = torch.zeros((B, num_docs + 1), dtype=torch.int32, device=dev)
    counts.index_put_((bi, didx), valid.to(torch.int32), accumulate=True)
    if not with_scores:
        return counts[:, :num_docs], None
    contrib = bm25_contrib(qw[:, :, None], freqs, docs, valid, norm_lens, num_docs)
    scores = torch.zeros((B, num_docs + 1), dtype=torch.float32, device=dev)
    scores.index_put_((bi, didx), contrib, accumulate=True)
    return counts[:, :num_docs], scores[:, :num_docs]


def _chunk_step(docs_words, freqs_words, dsegs, fsegs, list_n, qw, norm_lens, W, Lseg, B, T, L,
                num_docs, k, with_scores):
    rows = B * T + 1
    term_valid = qw > 0
    docs = _decode_packed(docs_words, dsegs, list_n, W, Lseg, rows, L, num_docs)[
        : B * T
    ].reshape(B, T, L)
    docs = torch.where(term_valid[:, :, None], docs, num_docs)
    target = term_valid.sum(dim=1, dtype=torch.int32)

    if not with_scores:
        counts, _ = plane_counts_scores(docs, None, qw, norm_lens, num_docs, with_scores=False)
    else:
        cums = _decode_packed(freqs_words, fsegs, list_n, W, Lseg, rows, L, 0)[
            : B * T
        ].reshape(B, T, L)
        freqs = torch.diff(cums, dim=2, prepend=torch.zeros((B, T, 1), dtype=torch.int32,
                                                             device=cums.device))
        counts, scores = plane_counts_scores(docs, freqs, qw, norm_lens, num_docs)
    and_counts = (counts == target[:, None]).sum(dim=1, dtype=torch.int32)
    or_counts = (counts > 0).sum(dim=1, dtype=torch.int32)

    if not with_scores:
        z = torch.zeros((B, k), dtype=torch.float32, device=docs.device)
        return and_counts, or_counts, z, z
    topk_or = torch.topk(torch.where(counts > 0, scores, -torch.inf), k, dim=1).values
    topk_and = torch.topk(torch.where(counts == target[:, None], scores, -torch.inf), k,
                          dim=1).values
    return and_counts, or_counts, topk_or, topk_and


def shift(x, m, fill):
    """x[:-m] behind m copies of `fill`: each slot's m-th predecessor."""
    return torch.cat([torch.full((m,), fill, dtype=x.dtype, device=x.device), x[:-m]])


class QueryEngine:
    """Executes query batches on the device against a DeviceIndex."""

    def __init__(self, index, wdata=None, scorer=BM25, chunk=512, max_plane_elems=128 << 20,
                 device=None):
        """index: an index built by this package, or a DeviceIndex (whose
        device the engine takes). device: None for the CUDA card, "cpu"
        for the plain PyTorch path."""
        self.dindex = _device_index(index, device)
        self.device = self.dindex.device
        self.num_docs = self.dindex.num_docs
        self.wdata = wdata
        self.scorer = scorer
        self.norm_lens = _norm_lens(wdata, self.num_docs, self.device)
        self.chunk = min(chunk, max(8, int(max_plane_elems // max(self.num_docs, 1) // 8)))

    # -- query prep -----------------------------------------------------------

    def _prep(self, queries, ranked):
        out = []
        for terms in queries:
            tf = query_freqs(terms)
            if ranked:
                qws = [
                    float(
                        self.scorer.query_term_weight(
                            qf, int(self.dindex.list_n[t]), self.num_docs
                        )
                    )
                    for t, qf in tf
                ]
            else:
                qws = [1.0] * len(tf)
            out.append(([t for t, _ in tf], qws))
        return out

    def _pack_segs(self, g, Rpad, off_row):
        check_bit_offsets(g["sel_start"], g["sel_len"], g["lb_start"], g["lower_bits"],
                          g["n_vals"])
        a = np.zeros((Rpad, len(FIELDS)), dtype=_I32)
        a[:, 0] = -1  # kind: padding matches no decode formula
        a[:, 8] = off_row  # list_row: padding scatters into the spare row
        R = len(g["kind"])
        for i, name in enumerate(FIELDS):
            a[:R, i] = g[name]
        return a

    def _run_chunk(self, prepped, B, T, L, k, with_scores):
        """Enqueues one chunk's device work; returns its output tensors."""
        d = self.dindex
        flat_terms = np.full(B * T, -1, dtype=np.int64)  # -1: empty slot
        qw = np.zeros((B, T), dtype=_F32)
        for bi, (terms, qws) in enumerate(prepped):
            for ti in range(min(T, len(terms))):
                flat_terms[bi * T + ti] = terms[ti]
                qw[bi, ti] = qws[ti]

        gd = d._gather_segments(d.docs_segs, d.d_ranges, flat_terms)
        gf = d._gather_segments(d.freqs_segs, d.f_ranges, flat_terms)
        Lseg = L  # segments never exceed their list's padded length
        slack_d = (gd["sel_start"] & 31) + gd["sel_len"]
        slack_f = (gf["sel_start"] & 31) + gf["sel_len"]
        wmax = max(
            int(slack_d.max()) if len(slack_d) else 1,
            int(slack_f.max()) if len(slack_f) else 1,
        )
        W = _pow_at_least((wmax + 31) // 32, lo=4)
        Rpad = _pow_at_least(max(len(gd["kind"]), len(gf["kind"]), 1), lo=8)

        list_n = np.zeros(B * T + 1, dtype=_I32)
        tv = flat_terms >= 0
        list_n[: B * T][tv] = d.list_n[flat_terms[tv]]

        up = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return _chunk_step(
            d.docs_words,
            d.freqs_words,
            up(self._pack_segs(gd, Rpad, B * T)),
            up(self._pack_segs(gf, Rpad, B * T)),
            up(list_n),
            up(qw),
            self.norm_lens,
            W=W,
            Lseg=Lseg,
            B=B,
            T=T,
            L=L,
            num_docs=self.num_docs,
            k=k,
            with_scores=with_scores,
        )

    def _run(self, queries, k=10, with_scores=True, ranked=True):
        """Bucket queries by longest-list length; enqueue every chunk, then
        read the results back."""
        prepped = self._prep(queries, ranked)
        T = _pow_at_least(max(1, max(len(t) for t, _ in prepped)), lo=1)

        buckets = {}
        for qi, (terms, _) in enumerate(prepped):
            ml = max((int(self.dindex.list_n[t]) for t in terms), default=0)
            Lb = _pow_at_least(max(1, ml), lo=16)
            buckets.setdefault(Lb, []).append(qi)

        pending = []
        for Lb in sorted(buckets):
            idxs = buckets[Lb]
            for i in range(0, len(idxs), self.chunk):
                part = idxs[i : i + self.chunk]
                B = _pow_at_least(len(part), lo=8)
                chunk = [prepped[j] for j in part] + [([], [])] * (B - len(part))
                out = self._run_chunk(chunk, B, T, Lb, k, with_scores)
                pending.append((part, out))

        return collect(pending, len(prepped))

    # -- public ops -----------------------------------------------------------

    def and_counts(self, queries):
        return np.array([r[0] for r in self._run(queries, with_scores=False, ranked=False)])

    def or_counts(self, queries):
        return np.array([r[1] for r in self._run(queries, with_scores=False, ranked=False)])

    def ranked_or(self, queries, k=10):
        return [topk_list(r[2]) for r in self._run(queries, k=k)]

    def ranked_and(self, queries, k=10):
        return [topk_list(r[3]) for r in self._run(queries, k=k)]

    # WAND / MaxScore return exactly the exhaustive top-k (lossless pruning)
    wand = ranked_or
    maxscore = ranked_or


def collect(pending, n):
    """Read back each part's output tensors ((query ids, outputs) pairs,
    enqueued first): per query, the tuple of its rows."""
    results = [None] * n
    for part, out in pending:
        res = [r.cpu().numpy() for r in out]
        for local, j in enumerate(part):
            results[j] = tuple(r[local] for r in res)
    return results


def topk_list(row):
    """A top-k row's finite scores."""
    return [float(s) for s in row[np.isfinite(row)]]


def _device_index(index, device):
    """`index` itself when it is a DeviceIndex (a `device` given must be
    its own), else a DeviceIndex of it on `device`."""
    if isinstance(index, DeviceIndex):
        if device is not None and resolve_device(device) != index.device:
            raise ValueError(f"the DeviceIndex lives on {index.device}, not on {device}")
        return index
    return DeviceIndex(index, device=device)


def _norm_lens(wdata, num_docs, device):
    """The documents' normalized lengths as f32 on `device` (1.0 without
    wand data)."""
    if wdata is None:
        return torch.ones(num_docs, dtype=torch.float32, device=device)
    return torch.from_numpy(np.asarray(wdata.norm_lens, dtype=np.float32).copy()).to(device)
