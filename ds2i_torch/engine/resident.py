"""Resident-table batched query engine on PyTorch: decode-unique +
block-gather + row-sort join.

Port of ds2i_tpu/engine/resident.py, exhaustive ops only, for
EF-family indexes (ef, single, uniform, opt) in pair mode and for the
block indexes block_optpfor and block_interpolative in split mode.
Everything static lives on the device from engine init: the compressed
words, the per-tile decode fields and, once ranked ops run, the norm
cache. A query batch uploads only its layout and downloads only results.

Per part (one host plan each), on the device:

  1. decode each UNIQUE tile once, by hand-written CUDA kernels on the
     card, from CTA tables built with the plan (ops.block_decode.
     PartLayout), each row reading its tile's fields from the resident
     tables: pair mode, one launch over every (W, WL, T) group of the
     part, both streams (ops.pair_decode.pair_decode_part); split mode,
     each stream in its own group-major order, one launch per kernel
     (OptPFor, interpolative) and stream (ops.block_decode.
     split_decode_part): freqs first, then docs, whose launches also
     realign the freqs to the docs order (blkperm). Either way the docs
     launch writes the doc-term weights f/(f+den) from the init-time
     norm cache (or presence flags) beside the docids
  2. each query row gathers its terms' 32-slot blocks by block index
  3. per length bucket: one stable row sort by docid joins the postings,
     bounded-run aggregation by shifted adds, AND/OR counts by row
     reductions, top-k per row
  4. pack the real rows (scaled f16 when the plan allows) and download

The host planner (prepare/_part_plan/_order_groups) is numpy, copied
from the JAX engine as it stands; its plan arrays equal the JAX
engine's (tests/test_torch_resident.py). Semantics match the oracle
layer: same doc sets and counts, f32 scores accumulated in query term
order.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..codecs.interpolative import InterpolativeBlock
from ..codecs.optpfor import OptPForBlock
from ..queries.bm25 import BM25
from ..queries.parsing import query_freqs

from ..ops import block_decode, pair_decode
from .block_tiles import BF_EX_BASE, build_block_tables, build_exception_patches
from .state import resident_state_from_arrays
from .tiles import F_NVALS, N_FIELDS, TILE, build_tile_tables

_F32 = np.float32
_I32 = np.int32
_PACKAGE = __name__.split(".")[0]
BLOCK = 32
NEG_INF = float("-inf")


def _pow2_at_least(x, lo=1):
    v = lo
    while v < int(x):
        v *= 2
    return v


# -- device functions (plain functions on tensors) ---------------------------


def _norm_cache_step(docs_words, tiles_docs, norm_den, gtile_ids, layout, num_docs):
    """One-time decode of EVERY tile's docids -> per-slot BM25
    denominators, (total_blocks, 32) f32 in the canonical group-major
    block order (docs stream only, one docs-mode launch of the part's
    kernels). layout: the PartLayout of the docs groups."""
    if layout.pair:
        d, _ = pair_decode.pair_decode_part(
            docs_words, None, tiles_docs, None, gtile_ids, layout, num_docs, None)
    else:
        d, _ = block_decode.split_decode_part(
            docs_words, tiles_docs, None, gtile_ids, None, None, layout, num_docs, None)
    return norm_den[d.long().clamp(0, num_docs - 1)]


def _decode_part(state, gtile_ids, gtile_f, blkperm, layout, num_docs, ranked):
    """Decode stage of one part, written by its kernels straight into slot
    tables padded to a power-of-two row count (pad rows: docid num_docs,
    weight 0), as in the JAX engine: (docs32 int32, w32 f32), doc-term
    weights (ranked) or 1.0 presence flags. layout: the part's PartLayout
    (pair mode: one pair_decode launch for both streams; split mode:
    gtile_f and blkperm are the freqs-order rows and realign)."""
    weights = "bm25" if ranked else "presence"
    rows = _pow2_at_least(layout.nb_d)
    if layout.pair:
        return pair_decode.pair_decode_part(
            state.docs_words, state.freqs_words, state.tiles_docs, state.tiles_freqs, gtile_ids,
            layout, num_docs, weights, state.den_blocks, state.tile_gblk0, out_rows=rows)
    return block_decode.split_decode_part(
        state.docs_words, state.tiles_docs, state.tiles_freqs, gtile_ids, gtile_f, blkperm,
        layout, num_docs, weights, state.den_blocks, state.tile_gblk0, out_rows=rows)


def _join_bucket(docs32, w32, bdir, qwtab, tgtv, num_docs, k, ops, tmax):
    """Join/score/top-k for one query bucket (all Bb rows, including the
    sentinel-padded tail — dropped later by _pack_rows' gather)."""
    Bb, nb_row = bdir.shape
    L = nb_row * BLOCK
    dev = docs32.device
    blkidx = (bdir >> 5).long()
    slot = (bdir & 31).long()
    qw = qwtab.gather(1, slot)  # (Bb, L/32)
    d = docs32[blkidx].reshape(Bb, L)
    c = (w32[blkidx] * qw[:, :, None]).reshape(Bb, L)
    sd, order = torch.sort(d, dim=1, stable=True)
    sc = c.gather(1, order)

    real = sd < num_docs
    nxt = torch.cat([sd[:, 1:], torch.full((Bb, 1), -1, dtype=sd.dtype, device=dev)], dim=1)
    last = sd != nxt
    run_score = sc
    run_cnt = real.int()
    match = torch.ones((Bb, L), dtype=torch.bool, device=dev)
    # runs are at most tmax long: shifted adds in the JAX engine's order,
    # so the f32 sums round the same way
    for m in range(1, tmax):
        keym = torch.cat([torch.full((Bb, m), -2, dtype=sd.dtype, device=dev), sd[:, :-m]], dim=1)
        match = match & (sd == keym)
        cm = torch.cat([torch.zeros((Bb, m), dtype=sc.dtype, device=dev), sc[:, :-m]], dim=1)
        om = torch.cat([torch.zeros((Bb, m), dtype=torch.int32, device=dev), real[:, :-m].int()], dim=1)
        run_score = run_score + torch.where(match, cm, 0.0)
        run_cnt = run_cnt + torch.where(match, om, 0)

    last_real = last & real
    tgt = tgtv[:, None]
    and_flag = last_real & (run_cnt == tgt) & (tgt > 0)

    # one f32 row per query: [counts?, topk_or?, topk_and?] (counts are
    # exact in f32 up to 2^24), so each part downloads ONE array
    res = []
    if "counts" in ops:
        res.append(and_flag.sum(dim=1).float()[:, None])
        res.append(last_real.sum(dim=1).float()[:, None])
    for op, flag in (("or", last_real), ("and", and_flag)):
        if op in ops:
            res.append(torch.topk(torch.where(flag, run_score, NEG_INF), k, dim=1).values)
    return torch.cat(res, dim=1)


def _pack_rows(rows, pack_idx, fscale, fetch16):
    """Concatenate the buckets' outputs, gather the real query rows, and
    cast for download: scores pre-scaled by the host-chosen power of two
    fscale ride f16 (see ResidentEngine._part_plan); else f32."""
    full = torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]
    out = full[pack_idx]
    return (out * fscale).half() if fetch16 else out


def _resident_step(state, gtile_ids, gtile_f, blkperm, bucket_dir, bucket_qwtab,
                   bucket_tgt, pack_idx, layout, num_docs, k, ops, tmax, fetch16, fscale):
    """One part: decode -> per-bucket join -> pack. gtile_f and blkperm
    are the split-mode freqs layout (placeholders in pair mode)."""
    ranked = ("or" in ops) or ("and" in ops)
    docs32, w32 = _decode_part(state, gtile_ids, gtile_f, blkperm, layout, num_docs, ranked)
    rows = tuple(
        _join_bucket(docs32, w32, d, q, t, num_docs=num_docs, k=k, ops=ops, tmax=tmax)
        for d, q, t in zip(bucket_dir, bucket_qwtab, bucket_tgt)
    )
    return _pack_rows(rows, pack_idx, fscale, fetch16)


# -- engine ------------------------------------------------------------------


class TilesPart(NamedTuple):
    """ResidentEngine.all_tiles_part: every tile as one part. gtile_ids
    maps the part's docs-order rows to tiles, tblk gives each tile's first
    docs-order block. Split mode: gtile_f, blkperm and tblk_f are the
    freqs-order rows, the docs->freqs block realign and each tile's first
    freqs-order block. Pair mode, where both streams share the docs-order
    rows: gtile_f and blkperm are the plan's one-entry placeholders, and
    tblk_f is tblk."""

    gtile_ids: torch.Tensor
    gtile_f: torch.Tensor
    blkperm: torch.Tensor
    layout: "block_decode.PartLayout"  # a string: ops.block_decode imports this module
    tblk: np.ndarray
    tblk_f: np.ndarray


class ResidentEngine:
    """Resident-table engine over an EF-family index (pair mode) or a
    block_optpfor / block_interpolative index (split mode); minimal
    per-batch transfer, one decode group set per part, decode shared
    across queries."""

    MIN_L = 64

    def __init__(self, index, wdata=None, max_part_slots=1 << 21,
                 max_part_queries=16384, device=None):
        docs_words, freqs_words = self._init_host(index, max_part_slots, max_part_queries)
        t = self.tiles
        norm_lens = (
            np.asarray(wdata.norm_lens, dtype=np.float32)
            if wdata is not None else np.ones(self.num_docs, np.float32)
        )
        self._attach(resident_state_from_arrays(
            docs_words, freqs_words, self._with_pad(t.docs), self._with_pad(t.freqs),
            BM25.norm_denominator(norm_lens), device=device,
        ))

    @classmethod
    def from_state(cls, index, state, max_part_slots=1 << 21, max_part_queries=16384):
        """An engine serving over an existing ResidentState (for example
        resident_state_from_arrays of a JAX engine's arrays). The host
        planner tables come from `index`; the state's tile tables must
        be this index's."""
        eng = cls.__new__(cls)
        eng._init_host(index, max_part_slots, max_part_queries)
        for name, rows in (("tiles_docs", eng.tiles.docs), ("tiles_freqs", eng.tiles.freqs)):
            got = getattr(state, name).cpu().numpy()
            if not np.array_equal(got, eng._with_pad(rows)):
                raise ValueError(f"state.{name} does not belong to this index")
        eng._attach(state)
        return eng

    def _init_host(self, index, max_part_slots, max_part_queries):
        """Host tables and plan state; returns the (docs, freqs) word
        arrays to upload (one array for both in split mode)."""
        if type(index).__module__.split(".")[0] != _PACKAGE:
            raise TypeError(
                f"ResidentEngine serves indexes built by {_PACKAGE}; got a "
                f"{type(index).__module__}.{type(index).__qualname__}"
            )
        self.index = index
        self.num_docs = index.num_docs()
        self.max_part_slots = max_part_slots
        self.max_part_queries = max_part_queries
        num_lists = index.size()
        if hasattr(index, "docs_sequences"):
            t, words = self._init_ef(index)
        else:
            t, words = self._init_block(index)
        self.tiles = t
        nt = len(t.tile_list)
        self.pad_tile = nt
        # host-side layout tables
        self.list_tile_start = t.list_tile_start
        self.list_tiles = np.diff(t.list_tile_start)
        nvals = t.docs[:, F_NVALS].astype(np.int64)
        self.tile_blocks = (nvals + BLOCK - 1) // BLOCK  # 32-slot blocks per tile
        self.list_n = np.zeros(num_lists, dtype=np.int64)
        np.add.at(self.list_n, t.tile_list, nvals)
        self.list_blocks = np.zeros(num_lists, dtype=np.int64)
        np.add.at(self.list_blocks, t.tile_list, self.tile_blocks)
        return words

    def _with_pad(self, a):
        """Resident field table: the tile rows plus one trailing pad row
        (kind=-1, n_vals=0)."""
        out = np.zeros((self.pad_tile + 1, N_FIELDS), dtype=_I32)
        out[: self.pad_tile] = a
        out[self.pad_tile, 0] = -1
        return out

    def _attach(self, state):
        self.state = state
        self.device = state.device
        norm_den = state.norm_den.cpu().numpy()
        if norm_den.shape != (self.num_docs,):
            raise ValueError(f"norm_den has shape {norm_den.shape}, index has {self.num_docs} docs")
        # provable lower bound on any bm25 doc-term weight (f>=1, den<=max),
        # with 1-ULP slack for the divide: plans the f16 download scaling
        den_max = float(np.max(norm_den)) if self.num_docs else 1.0
        self._wmin = (1.0 / (1.0 + den_max)) * (1.0 - 1e-6)

    def _init_ef(self, index):
        # EF-family tiles: group statics are ("ef", W, WL, T)
        t = build_tile_tables(index)
        nvals = t.docs[:, F_NVALS].astype(np.int64)
        ww = np.maximum(t.win_words, 1)
        wl = np.maximum(t.lb_words, 1)
        wb = 1 << (2 * np.ceil(np.log2(np.maximum(ww, 4)) / 2).astype(np.int64))
        lb = 1 << (2 * np.ceil(np.log2(np.maximum(wl, 4)) / 2).astype(np.int64))
        tT = np.clip(2 ** np.ceil(np.log2(np.maximum(nvals, 1))).astype(np.int64), BLOCK, TILE)
        key = tT * (1 << 22) + wb * 1024 + lb
        uniq, inv = np.unique(key, return_inverse=True)
        self.group_statics = [
            ("ef", int((int(kv) >> 10) & 1023), int(int(kv) & 1023), int(int(kv) >> 22))
            for kv in uniq
        ]
        self.tile_gid = inv.astype(np.int64)
        self._empty_statics = ("ef", 4, 4, TILE)
        self.split = False
        for coll_bv in (index.docs_sequences.bits_bv, index.freqs_sequences.bits_bv):
            if coll_bv.nbits >= 2**36:
                raise ValueError(
                    "device engine limit: 8GB per resident stream (i32 WORD "
                    "cursors in the tile tables)"
                )
        return t, (index.docs_sequences.bits_bv.words, index.freqs_sequences.bits_bv.words)

    def _init_block(self, index):
        """block_freq_index tiles (resident.py:_init_block): one tile per
        128-int block, per-stream group statics ("opt", b, E, 128) or
        ("interp", W, T), and ONE word stream for docs and freqs: the
        index bytes, then the resident OptPFor exception patch pairs."""
        if index.codec not in (OptPForBlock, InterpolativeBlock):
            raise NotImplementedError(
                f"ds2i_torch's ResidentEngine serves block_optpfor and "
                f"block_interpolative; {index.codec.__name__} blocks wait for "
                f"{block_decode.ITEM8}"
            )
        self.split = True
        t, slist_d, gid_d, slist_f, gid_f = build_block_tables(index)
        self._empty_statics = ("interp", 4, BLOCK)
        data = np.asarray(index.lists, dtype=np.uint8)
        pad = (-len(data)) % 4
        words = np.concatenate([data, np.zeros(pad + 8, np.uint8)]).view("<u4")
        # resident exception patch tables (the JAX engine's default): the
        # Simple16 exception streams decode ONCE here into (position,
        # high<<b) pairs appended to the stream; BF_EX_BASE holds each
        # row's first pair word and those groups become "optp"
        if any(s[0] == "opt" and s[2] > 0 for s in slist_d + slist_f):
            patch, (base_d, base_f) = build_exception_patches(words, [t.docs, t.freqs])
            nw0 = np.int64(len(words))
            if nw0 + len(patch) >= 2**31:
                # the JAX engine drops back to the in-pass Simple16 decode
                # here, which the port does not carry
                raise ValueError(
                    "device engine limit: 8GB of resident words (index bytes plus "
                    "exception patch pairs) for i32 word cursors; larger indexes "
                    "wait for int64 cursors (ROADMAP queue 1 item 10)"
                )
            t.docs[:, BF_EX_BASE] = np.where(base_d >= 0, nw0 + 2 * base_d, 0).astype(np.int32)
            t.freqs[:, BF_EX_BASE] = np.where(base_f >= 0, nw0 + 2 * base_f, 0).astype(np.int32)
            words = np.concatenate([words, patch.astype(np.uint32)])
            remap = lambda s: ("optp",) + s[1:] if s[0] == "opt" and s[2] > 0 else s  # noqa: E731
            slist_d = [remap(s) for s in slist_d]
            slist_f = [remap(s) for s in slist_f]
        elif len(words) >= 2**31:
            raise ValueError(
                "device engine limit: 8GB per resident stream (i32 word cursors); "
                "larger indexes wait for int64 cursors (ROADMAP queue 1 item 10)"
            )
        self.group_statics_d = slist_d
        self.tile_gid_d = gid_d
        self.group_statics_f = slist_f
        self.tile_gid_f = gid_f
        return t, (words, words)

    def _ensure_norm_cache(self):
        """Materialize the per-slot BM25-denominator cache (one decode of
        every tile's docs stream). Lazy: only ranked execution pays it."""
        s = self.state
        if s.den_blocks is not None:
            return
        nt = self.pad_tile
        utidx = np.arange(nt, dtype=np.int64)
        groups, gtile_ids, tblk, sent_blk, _ = self._order_groups(
            utidx, *self._docs_grouping())
        g0 = np.full(nt + 1, sent_blk, dtype=np.int64)
        if nt:
            g0[:nt] = tblk
        s.tile_gblk0 = torch.from_numpy(g0).to(self.device)
        s.den_blocks = _norm_cache_step(
            s.docs_words, s.tiles_docs, s.norm_den,
            torch.from_numpy(gtile_ids.astype(np.int64)).to(self.device),
            block_decode.PartLayout(groups), self.num_docs,
        )

    def _docs_grouping(self):
        """(tile gids, statics) of the docs-order decode groups."""
        if self.split:
            return self.tile_gid_d, self.group_statics_d
        return self.tile_gid, self.group_statics

    # -- host batch layout ----------------------------------------------------

    def _prep_terms(self, queries, ranked):
        tf = [query_freqs(t) for t in queries]
        counts = np.array([len(x) for x in tf], dtype=np.int64)
        terms = np.array([t for q in tf for t, _ in q], dtype=np.int64)
        qmult = np.array([m for q in tf for _, m in q], dtype=np.int64)
        if ranked and len(terms):
            dfs = self.list_n[terms].astype(_F32)
            N = _F32(self.num_docs)
            idf = np.log((N - dfs + _F32(0.5)) / (dfs + _F32(0.5))).astype(_F32)
            qw = qmult.astype(_F32) * np.maximum(_F32(1e-6), idf) * (_F32(1.0) + BM25.k1)
        else:
            qw = np.ones(len(terms), dtype=_F32)
        return terms, qw, counts

    def _term_tiles(self, terms):
        """(tile_start, tile_count) per term; -1 terms own none."""
        t = np.clip(terms, 0, None)
        missing = terms < 0
        return (
            np.where(missing, 0, self.list_tile_start[t]),
            np.where(missing, 0, self.list_tiles[t]),
        )

    def _term_blocks(self, terms):
        return np.where(terms < 0, 0, self.list_blocks[np.clip(terms, 0, None)])

    def _order_groups(self, utidx, tile_gid, statics_list):
        """Group-major ordering of the part's tiles for one decode pass.
        Returns (groups, gtile_ids, tblk, sent_blk, total_blocks)."""
        ntiles = len(utidx)
        bkey = tile_gid[utidx] if ntiles else np.zeros(0, np.int64)
        order = np.argsort(bkey, kind="stable")
        sk = bkey[order]
        bnd = (np.nonzero(np.diff(sk))[0] + 1) if ntiles else np.zeros(0, np.int64)
        gstarts = np.concatenate([[0], bnd, [ntiles]]).astype(np.int64)

        groups = []
        tblk = np.zeros(ntiles, dtype=np.int64)  # first block of each utile
        gids_parts = []
        off = 0
        gblk = 0
        ngroups = len(gstarts) - 1
        sent_blk = 0
        for gi in range(ngroups):
            lo_i, hi_i = int(gstarts[gi]), int(gstarts[gi + 1])
            if hi_i <= lo_i:
                continue
            sel = order[lo_i:hi_i]
            cnt = hi_i - lo_i
            st = statics_list[int(bkey[sel[0]])]
            T = st[-1]
            bpt = max(T // BLOCK, 1)
            # last group gets one guaranteed pad row (the sentinel block)
            need = cnt + (1 if gi == ngroups - 1 else 0)
            R = _pow2_at_least(need, lo=8)
            if R > 8:
                # quarter-pow2 ladder: row padding <= 1.25x (the JAX
                # engine's default, DS2I_R_FINE=1)
                for c in (R // 2 * 5 // 4, R // 2 * 6 // 4, R // 2 * 7 // 4):
                    if need <= c:
                        R = c
                        break
            ids = np.full(R, self.pad_tile, dtype=_I32)
            ids[:cnt] = utidx[sel]
            tblk[sel] = gblk + np.arange(cnt) * bpt
            groups.append((off, R, st))
            gids_parts.append(ids)
            sent_blk = gblk + cnt * bpt  # first pad row's block (last group)
            off += R
            gblk += R * bpt
        if not groups:
            groups = [(0, 8, self._empty_statics)]
            gids_parts = [np.full(8, self.pad_tile, dtype=_I32)]
            gblk = 8 * max(self._empty_statics[-1] // BLOCK, 1)
            sent_blk = 0
        gtile_ids = np.concatenate(gids_parts)
        return tuple(groups), gtile_ids, tblk, sent_blk, gblk

    def _split_layout(self, utidx, tblk, nb_d):
        """Freqs-order groups + docs->freqs block permutation for split
        (block-index) parts; trivial placeholders for pair mode."""
        if not self.split:
            return (), np.zeros(1, dtype=_I32), np.zeros(1, dtype=_I32)
        groups_f, gtile_f, tblk_f, sent_f, _ = self._order_groups(
            utidx, self.tile_gid_f, self.group_statics_f)
        blkperm = np.full(nb_d, sent_f, dtype=_I32)
        if len(utidx):
            bpt = self.tile_blocks[utidx]
            tot_b = int(bpt.sum())
            bex = np.cumsum(bpt) - bpt
            blkperm[np.repeat(tblk - bex, bpt) + np.arange(tot_b, dtype=np.int64)] = (
                np.repeat(tblk_f - bex, bpt) + np.arange(tot_b, dtype=np.int64)
            )
        return groups_f, gtile_f, blkperm

    def all_tiles_part(self):
        """Every tile as one part, laid out as a plan's part is (a
        TilesPart): (gtile_ids, gtile_f, blkperm) int64 on the engine's
        device, the part's PartLayout, and each tile's first docs-order
        and freqs-order block (host arrays)."""
        utidx = np.arange(self.pad_tile)
        groups, gtile, tblk, _, nb_d = self._order_groups(utidx, *self._docs_grouping())
        groups_f, gtile_f, blkperm = self._split_layout(utidx, tblk, nb_d)
        tblk_f = tblk
        if self.split:
            _, _, tblk_f, _, _ = self._order_groups(utidx, self.tile_gid_f, self.group_statics_f)
        put = lambda a: torch.from_numpy(a.astype(np.int64)).to(self.device)  # noqa: E731
        return TilesPart(put(gtile), put(gtile_f), put(blkperm),
                         block_decode.PartLayout(groups, groups_f), tblk, tblk_f)

    def _part_plan(self, terms, qw, counts, k, ops, tmax, qids):
        """Layout for one part: group-major unique-tile ids + per-bucket
        block directories. All numpy, no device work."""
        B = len(counts)
        span_row = np.repeat(np.arange(B), counts)
        sexcl = np.cumsum(counts) - counts
        slot_of_span = np.arange(len(terms), dtype=np.int64) - sexcl[span_row]

        uterms, uinv = (
            np.unique(terms, return_inverse=True) if len(terms) else
            (np.zeros(0, np.int64), np.zeros(0, np.int64))
        )

        # --- unique-term tile expansion (CSR)
        tstarts, tcounts = self._term_tiles(uterms)
        ntiles = int(tcounts.sum())
        if ntiles:
            excl = np.cumsum(tcounts) - tcounts
            utidx = np.repeat(tstarts - excl, tcounts) + np.arange(ntiles, dtype=np.int64)
        else:
            utidx = np.zeros(0, dtype=np.int64)

        # --- group by decode class, group-major row ids
        groups, gtile_ids, tblk, sent_blk, nb_d = self._order_groups(
            utidx, *self._docs_grouping())
        groups_f, gtile_f, blkperm = self._split_layout(utidx, tblk, nb_d)

        # --- per-unique-term block lists (group-major block ids)
        nbt = self.tile_blocks[utidx]  # blocks of each utile
        tot_blk = int(nbt.sum())
        if tot_blk:
            bexcl = np.cumsum(nbt) - nbt
            # block b of utile i -> tblk[i] + b
            ublocks = np.repeat(tblk - bexcl, nbt) + np.arange(tot_blk, dtype=np.int64)
        else:
            ublocks = np.zeros(0, dtype=np.int64)
        # CSR over unique terms (utidx is unique-major, so ublocks is too)
        unb = self._term_blocks(uterms)
        ustart = np.concatenate([[0], np.cumsum(unb)])

        # --- per-query block directory
        span_nb = unb[uinv] if len(terms) else np.zeros(0, np.int64)
        row_nb = np.zeros(B, dtype=np.int64)
        np.add.at(row_nb, span_row, span_nb)

        # expand each span's blocks, query-major
        tot = int(span_nb.sum())
        if tot:
            bexcl2 = np.cumsum(span_nb) - span_nb
            span_of_blk = np.repeat(np.arange(len(span_nb)), span_nb)
            blk_flat = ublocks[
                np.repeat(ustart[uinv] - bexcl2, span_nb) + np.arange(tot, dtype=np.int64)
            ]
            dir_flat = (blk_flat << 5) | slot_of_span[span_of_blk]
            row_of_blk = span_row[span_of_blk]
            # column of each block within its row
            rexcl = np.zeros(B + 1, dtype=np.int64)
            rexcl[1:] = np.cumsum(row_nb)
            col_of_blk = np.arange(tot, dtype=np.int64) - rexcl[row_of_blk]
        else:
            dir_flat = row_of_blk = col_of_blk = np.zeros(0, np.int64)

        min_l = max(self.MIN_L, _pow2_at_least(k))
        Lrow = np.maximum(row_nb * BLOCK, 1)
        Lb = (2 ** np.ceil(np.log2(np.maximum(Lrow, min_l)))).astype(np.int64)
        bkey = Lb << 32

        # --- bucket the queries by Lb
        plan_buckets = []
        ubl = np.unique(bkey)
        bucket_of_row = np.zeros(B, dtype=np.int64)
        row_in_bucket = np.zeros(B, dtype=np.int64)
        for bi, bk in enumerate(ubl):
            L = int(bk) >> 32
            rows = np.nonzero(bkey == bk)[0]
            bucket_of_row[rows] = bi
            row_in_bucket[rows] = np.arange(len(rows))
            Bb = _pow2_at_least(len(rows), lo=1)
            nr = len(rows)
            # full Bb rows (sentinel/zero tail), as in the JAX engine
            bdir = np.full((Bb, int(L) // BLOCK), sent_blk << 5, dtype=_I32)
            qwtab = np.zeros((Bb, tmax), dtype=_F32)
            tgt = np.zeros(Bb, dtype=_I32)
            tgt[:nr] = counts[rows].astype(_I32)
            plan_buckets.append(
                {"L": int(L), "Bb": Bb, "rows": qids[rows], "dir": bdir, "qwtab": qwtab, "tgt": tgt}
            )
        # real-row gather over the concatenation of the buckets' Bb rows
        bb_off = np.cumsum([0] + [pb["Bb"] for pb in plan_buckets])
        pack_idx = np.concatenate(
            [o + np.arange(len(pb["rows"]), dtype=np.int64)
             for o, pb in zip(bb_off[:-1], plan_buckets)]
        ).astype(_I32) if plan_buckets else np.zeros(0, dtype=_I32)
        if len(terms):
            b_of_span = bucket_of_row[span_row]
            r_of_span = row_in_bucket[span_row]
            for bi, pb in enumerate(plan_buckets):
                m = b_of_span == bi
                pb["qwtab"][r_of_span[m], slot_of_span[m]] = qw[m]
        if tot:
            b_of = bucket_of_row[row_of_blk]
            r_of = row_in_bucket[row_of_blk]
            for bi, pb in enumerate(plan_buckets):
                m = b_of == bi
                pb["dir"][r_of[m], col_of_blk[m]] = dir_flat[m]

        # f16 download scaling: find a power of two putting every possible
        # finite score in f16's normal range [~6.1e-5, 65504); None -> f32.
        fscale = 1.0
        pos = qw[qw > 0]
        if len(pos):
            min_s = float(pos.min()) * self._wmin  # >= any finite score's floor
            row_qwsum = np.zeros(B, dtype=np.float64)
            np.add.at(row_qwsum, span_row, qw.astype(np.float64))
            max_s = float(row_qwsum.max())  # >= any score (w < 1)
            lo, hi = 6.2e-5, 6.0e4  # normal-f16 window with margin
            if min_s > 0 and max_s / min_s <= hi / lo:
                kmin = math.ceil(math.log2(lo / min_s))
                if max_s * 2.0**kmin <= hi:
                    fscale = 2.0**kmin
                else:
                    fscale = None
            else:
                fscale = None

        return {
            "fscale": fscale,
            "gtile_ids": gtile_ids,
            "gtile_f": gtile_f,
            "blkperm": blkperm,
            "groups": tuple(groups),
            "groups_f": tuple(groups_f),
            # the CTA tables of the part's kernel launches
            "layout": block_decode.PartLayout(groups, groups_f),
            "buckets": plan_buckets,
            "pack_idx": pack_idx,
            "sent_dir": int(sent_blk << 5),
            "k": k,
            "ops": ops,
            "tmax": tmax,
        }

    def prepare(self, queries, k=10, ops=("or", "and"), ranked=True, prune=False):
        """Parse + lay out the batch (host only): the exhaustive plan."""
        bad_ops = set(ops) - {"counts", "or", "and"}
        if bad_ops:
            raise ValueError(
                f"unknown ops {sorted(bad_ops)}: ResidentEngine ops are "
                "'counts', 'or', 'and' (+ ranked=True for scored top-k)"
            )
        if prune:
            raise NotImplementedError(
                "block-max pruning (prepare(prune=...)) is not ported yet: "
                "ROADMAP queue 1 item 3 (AND pruning) and item 5 (OR pruning)"
            )
        terms, qw, counts = self._prep_terms(queries, ranked)
        qend = np.cumsum(counts)
        qstart = qend - counts
        tmax = _pow2_at_least(int(counts.max()) if len(counts) else 1, lo=2)
        if tmax > 32:
            # the block directory packs the term slot into 5 bits next to
            # the block id ((blk << 5) | slot, _join_bucket)
            bad = int(np.argmax(counts > 32))
            raise ValueError(
                f"ResidentEngine supports at most 32 unique terms per "
                f"query (query {bad} has {int(counts[bad])})"
            )

        # part splitting by bucketed (unpruned) slot budget
        qslots = np.zeros(len(queries), dtype=np.int64)
        if len(terms):
            nb = self._term_blocks(terms)
            np.add.at(qslots, np.repeat(np.arange(len(queries)), counts), nb * BLOCK)
        qslots = np.maximum(2 ** np.ceil(np.log2(np.maximum(qslots, self.MIN_L))).astype(np.int64), self.MIN_L)

        parts = []
        cur0, cur_slots = 0, 0
        for qi in range(len(queries)):
            if qi > cur0 and (
                cur_slots + qslots[qi] > self.max_part_slots
                or qi - cur0 >= self.max_part_queries
            ):
                parts.append((cur0, qi))
                cur0, cur_slots = qi, 0
            cur_slots += qslots[qi]
        parts.append((cur0, len(queries)))

        plans = []
        for q0, q1 in parts:
            if q1 <= q0:
                continue
            s0, s1 = qstart[q0], qend[q1 - 1]
            plans.append(
                self._part_plan(
                    terms[s0:s1], qw[s0:s1], counts[q0:q1], k, tuple(ops), tmax,
                    qids=np.arange(q0, q1),
                )
            )
        return {"plans": plans, "n": len(queries), "k": k, "ops": tuple(ops)}

    def execute(self, plan):
        """Upload per-part layouts, dispatch, download results. A plan's
        layout tensors stay on the device after its first execution and
        are reused by later executions of the same plan; postings are
        decoded from the compressed index every time."""
        return self.collect(plan, self.dispatch(plan))

    def dispatch(self, plan):
        """Enqueue every part's device work and its device->host copy
        without waiting for either."""
        ranked_ops = any(("or" in p["ops"]) or ("and" in p["ops"]) for p in plan["plans"])
        if ranked_ops:
            self._ensure_norm_cache()
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)  # noqa: E731
        pending = []
        for p in plan["plans"]:
            bb = p["buckets"]
            cache = p.setdefault("_dev", {})
            if dev not in cache:
                cache[dev] = (
                    put(p["gtile_ids"].astype(np.int64)),
                    put(p["gtile_f"].astype(np.int64)),
                    put(p["blkperm"].astype(np.int64)),
                    tuple(put(b["dir"]) for b in bb),
                    tuple(put(b["qwtab"]) for b in bb),
                    tuple(put(b["tgt"]) for b in bb),
                    put(p["pack_idx"].astype(np.int64)),
                )
                p["layout"].upload(dev)
            d_gt, d_gf, d_bp, d_dir, d_qw, d_tgt, d_pidx = cache[dev]
            fetch16 = "counts" not in p["ops"] and p["fscale"] is not None
            out = _resident_step(
                self.state, d_gt, d_gf, d_bp, d_dir, d_qw, d_tgt, d_pidx,
                layout=p["layout"], num_docs=self.num_docs,
                k=p["k"], ops=p["ops"], tmax=p["tmax"], fetch16=fetch16,
                fscale=p["fscale"] if fetch16 else None,
            )
            if out.is_cuda:
                # the download starts as soon as this part's compute ends,
                # overlapping later parts' compute
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                out = host
            pending.append((p, out))
        return pending

    def collect(self, plan, pending):
        """Wait for a dispatch() and unpack its results."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        results = [None] * plan["n"]
        for p, out in pending:
            packed = out.numpy()
            if packed.dtype == np.float16:
                packed = packed.astype(np.float32) / np.float32(p["fscale"])
            ops = p["ops"]
            off = 0
            c0 = 2 if "counts" in ops else 0
            c_or = c0 + (p["k"] if "or" in ops else 0)
            for b in p["buckets"]:
                rows = packed[off: off + len(b["rows"])]
                off += len(b["rows"])
                for local, qi in enumerate(b["rows"]):
                    r = rows[local]
                    results[qi] = (
                        int(r[0]) if c0 else 0,
                        int(r[1]) if c0 else 0,
                        r[c0:c_or] if "or" in ops else None,
                        r[c_or: c_or + p["k"]] if "and" in ops else None,
                    )
        return results

    def run(self, queries, k=10, ops=("or", "and"), ranked=True, prune=False):
        return self.execute(self.prepare(queries, k=k, ops=ops, ranked=ranked, prune=prune))

    # -- public ops -------------------------------------------------------------

    def and_counts(self, queries):
        return np.array([r[0] for r in self.run(queries, ops=("counts",), ranked=False)])

    def or_counts(self, queries):
        return np.array([r[1] for r in self.run(queries, ops=("counts",), ranked=False)])

    def _topk_list(self, r):
        return [float(s) for s in r[np.isfinite(r)]]

    def ranked_or(self, queries, k=10):
        return [self._topk_list(r[2]) for r in self.run(queries, k=k, ops=("or",))]

    def ranked_and(self, queries, k=10, prune=False):
        return [
            self._topk_list(r[3])
            for r in self.run(queries, k=k, ops=("and",), prune=prune)
        ]
