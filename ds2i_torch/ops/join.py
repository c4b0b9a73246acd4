"""The join and pack of a part (K3): every query row's postings joined
by docid, scored, counted, cut to its top-k and packed for download.

Port of ds2i_tpu/engine/resident.py:_join_bucket and :_pack_rows. Per
query row: the row's directory entries `dir = blk << 5 | slot` name
32-slot blocks of the part's decode (docs32 int32, w32 f32); each slot's
contribution is w32 * qwtab[row, slot] (one f32 multiply); the entries of
one docid (at most one per term slot, since query_freqs dedups) form a
run whose score is summed from the highest slot down, ((c_last + c_prev)
+ ...), the JAX engine's shifted-add order; a run with count == tgt is
in the AND. Output row: [and count, or count] (if "counts"), then the
top-k run scores of the OR (if "or"), then of the AND (if "and"), -inf
where fewer; the real rows of every bucket are packed in bucket order,
scaled by fscale into f16 when the plan downloads f16.

  join_bucket_torch  one bucket, the plain version (sort, shifted adds,
                     torch.topk), as the engine ran it before the kernel
  pack_rows_torch    the pack
  join_part_torch    the whole part in plain PyTorch: every bucket, then
                     the pack (what the kernel is held to)
  JoinLayout         the part's tables for the kernel, built by the host
                     planner with the plan and uploaded once per device
  join_part          the wrapper: CPU tensors take join_part_torch; CUDA
                     tensors launch csrc/join.cu once (counted in
                     join_part.launches) or raise

The kernel reads a row's real entries alone (no sentinel columns, no pad
rows) and drives each row from some of them: where the plan asks for the
AND top-k alone (ops ("and",)), from the entries of the row's shortest
term slot, since an AND result lies in every slot; else from all of
them. Its search of the other slots relies on the row structure every
plan gives (tests/test_torch_join.py pins it): each slot's entries are
contiguous and slots ascend along the row; within a slot, the blocks'
real docids strictly increase in entry order, each block holding its
real docids first (slot 0 always real) and its pads (num_docs) last.
"""

import numpy as np
import torch

from .. import kernels

BLOCK = 32
NEG_INF = float("-inf")
# driving entries of a row per CTA item at most (csrc/join.cu kChunk: an
# item's candidates fit its 32 * 32 slots); a row of more spans several
# items, the last of which to finish merges their top-k lists
CHUNK = 32
# a row of at most this many driving entries, and of at most WARP_STAGE
# entries, takes one warp (csrc/join.cu: 8 such rows a CTA) where k fits
# a warp's registers (k <= WARP_K); the others take CTA items. Set on the
# H100 with CHUNK: rows of 3 or more driving entries finish sooner on a
# CTA's 8 warps (PERF.md §6, the work split)
WARP_DRIVE = 2
WARP_STAGE = 256
WARP_K = 32
# a row's entries are staged in the CTA's shared memory up to this many
# (csrc/join.cu kStage; a warp row's up to WARP_STAGE); longer rows are
# searched in device memory
STAGE = 2048
# the largest k the kernel takes (the merge of a row's lists sorts 2k
# values in shared memory)
KMAX = 4096
_OP_BITS = {"counts": 1, "or": 2, "and": 4}


def join_bucket_torch(docs32, w32, bdir, qwtab, tgtv, num_docs, k, ops, tmax):
    """Join/score/top-k for one query bucket (all Bb rows, including the
    sentinel-padded tail — dropped later by pack_rows_torch's gather)."""
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


def pack_rows_torch(rows, pack_idx, fscale, fetch16):
    """Concatenate the buckets' outputs, gather the real query rows, and
    cast for download: scores pre-scaled by the host-chosen power of two
    fscale ride f16 (see ResidentEngine._part_plan); else f32."""
    full = torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]
    out = full[pack_idx]
    return (out * fscale).half() if fetch16 else out


def join_part_torch(docs32, w32, bucket_dir, bucket_qwtab, bucket_tgt, pack_idx, num_docs, k,
                    ops, tmax, fetch16, fscale):
    """The whole join of a part in plain PyTorch: join_bucket_torch over
    every bucket, then pack_rows_torch. (n real rows, width) f16 or f32."""
    rows = tuple(
        join_bucket_torch(docs32, w32, d, q, t, num_docs=num_docs, k=k, ops=ops, tmax=tmax)
        for d, q, t in zip(bucket_dir, bucket_qwtab, bucket_tgt)
    )
    return pack_rows_torch(rows, pack_idx, fscale, fetch16)


class JoinLayout:
    """One part's join, built on the host with the plan and uploaded once
    per device. Two forms of the same rows:

      plain   the plan's buckets (dir, qwtab, tgt, all Bb rows) and
              pack_idx: join_part_torch's inputs (CPU tensors)
      kernel  csrc/join.cu's tables, over the packed rows only:
                ent     int32 (n_ent,)      the part's real directory
                                            entries, row-major
                rows    int32 (n_rows, 5)   [first entry, entries, tgt,
                                            first driving entry in the
                                            row, driving entries] of
                                            each packed row
                qw      f32 (n_rows, tmax)  its query weight per slot
                items   int32 (n_items, 5)  a CTA each, first: [row,
                                            first driving entry in the
                                            row, driving entries (<=
                                            chunk), scratch slot and
                                            merged row, or -1 and -1
                                            (the CTA writes the row)]
                wrows   int32 (n_wrows,)    the rows a warp takes, 8 a
                                            CTA after the items
                merges  int32 (n_merge, 3)  the rows that span more
                                            than one item: [row, first
                                            scratch slot, slots]; the
                                            last of a row's items to
                                            finish merges its lists

    Driving entries: with ops ("and",) the entries of the row's shortest
    slot among 0 .. tgt-1 (none where one of them has no entry: the row
    has no AND result, `empty`); else all of the row's entries. A row of
    at most WARP_DRIVE driving entries and WARP_STAGE entries is a warp
    row where k <= WARP_K (or nothing is ranked); the others are split
    into items of at most chunk driving entries. Items and warp rows go
    most driving entries first.

    row_ent0, row_nent, row_tgt and row_qw are per packed row (pack_idx's
    order: the buckets' real rows, bucket by bucket)."""

    def __init__(self, ent, row_ent0, row_nent, row_tgt, row_qw, buckets, pack_idx, k, ops,
                 tmax, chunk=CHUNK):
        if not 1 <= chunk <= CHUNK:
            raise ValueError(f"chunk must be in [1, {CHUNK}], got {chunk}")
        self.k, self.ops, self.tmax = int(k), tuple(ops), int(tmax)
        self.buckets, self.pack_idx = buckets, pack_idx
        self.ent = np.ascontiguousarray(ent, dtype=np.int32)
        self.n_rows = n = len(np.asarray(row_nent))
        nent = np.asarray(row_nent, dtype=np.int64).reshape(n)
        tgt = np.asarray(row_tgt, dtype=np.int64).reshape(n)
        self.and_only = self.ops == ("and",)
        ent0 = np.asarray(row_ent0, np.int64).reshape(n)
        if self.and_only and n:
            # the packed rows' entries, row by row (rows are packed in
            # bucket order, their entries lie in query order)
            excl = np.cumsum(nent) - nent
            at = np.repeat(ent0 - excl, nent) + np.arange(int(nent.sum()), dtype=np.int64)
            row_of = np.repeat(np.arange(n, dtype=np.int64), nent)
            cnt = np.bincount(row_of * BLOCK + (self.ent[at].astype(np.int64) & 31),
                              minlength=n * BLOCK).reshape(n, BLOCK)
            in_row = np.arange(BLOCK)[None, :] < tgt[:, None]
            drive = np.argmin(np.where(in_row, cnt, np.iinfo(np.int64).max), axis=1)
            nd = np.where(tgt > 0, cnt[np.arange(n), drive], 0)
            d0 = np.where(np.arange(BLOCK)[None, :] < drive[:, None], cnt, 0).sum(axis=1)
            self.empty = (tgt > 0) & (nd == 0)
        else:
            nd, d0 = nent.copy(), np.zeros(n, np.int64)
            self.empty = np.zeros(n, bool)
        self.rows = np.ascontiguousarray(
            np.stack([ent0, nent, tgt, d0, nd], axis=1).astype(np.int32).reshape(-1, 5))
        self.qw = np.ascontiguousarray(row_qw, dtype=np.float32).reshape(n, self.tmax)
        self.n_ranked = sum(op in self.ops for op in ("or", "and"))
        self.width = (2 if "counts" in self.ops else 0) + self.k * self.n_ranked
        warp = (nd <= WARP_DRIVE) & (nent <= WARP_STAGE)
        if self.n_ranked and self.k > WARP_K:
            warp[:] = False
        wrows = np.flatnonzero(warp)
        self.wrows = np.ascontiguousarray(
            wrows[np.argsort(-nd[wrows], kind="stable")].astype(np.int32))
        crows = np.flatnonzero(~warp)
        nit = np.maximum(1, -(-nd[crows] // chunk))
        total = int(nit.sum())
        item_row = np.repeat(crows, nit)
        j = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(nit) - nit, nit)
        ne = np.minimum(chunk, nd[item_row] - j * chunk)
        multi = np.repeat(nit > 1, nit)
        scratch = np.where(multi, np.cumsum(multi) - 1, -1)
        many = nit > 1
        merge = np.where(multi, np.repeat(np.cumsum(many) - 1, nit), -1)
        items = np.stack([item_row, d0[item_row] + j * chunk, ne, scratch, merge], axis=1)
        self.items = np.ascontiguousarray(
            items[np.argsort(-ne, kind="stable")].astype(np.int32).reshape(-1, 5))
        first = np.cumsum(nit) - nit
        self.merges = np.ascontiguousarray(
            np.stack([crows[many], scratch[first[many]], nit[many]],
                     axis=1).astype(np.int32).reshape(-1, 3))
        self.n_scratch = int(multi.sum())
        self.max_blk = int(self.ent.max() >> 5) if len(self.ent) else -1
        self._dev = {}

    def structure(self):
        """The counts of the kernel's work split: rows a warp takes, rows
        a CTA takes, their items, driving entries against all entries,
        rows with an empty slot, rows whose items merge their lists."""
        return {"warp_rows": len(self.wrows), "cta_rows": self.n_rows - len(self.wrows),
                "items": len(self.items), "drive_entries": int(self.rows[:, 4].sum()),
                "entries": len(self.ent), "empty_rows": int(self.empty.sum()),
                "merged_rows": len(self.merges)}

    def upload(self, device):
        """The tables of the form `device` runs (CPU: plain, else the
        kernel's) to `device`, once. Returns the bytes this call
        copied."""
        device = torch.device(device)
        plain = device.type == "cpu"
        if ("plain" if plain else "kernel", str(device)) in self._dev:
            return 0
        tabs = self.plain(device) if plain else self.tables(device)
        return sum(t.nbytes for x in tabs for t in (x if isinstance(x, tuple) else (x,)))

    def plain(self, device):
        """(bucket_dir, bucket_qwtab, bucket_tgt, pack_idx) on `device`:
        join_part_torch's inputs."""
        key = ("plain", str(device))
        if key not in self._dev:
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
            bb = self.buckets
            self._dev[key] = (tuple(put(b["dir"]) for b in bb), tuple(put(b["qwtab"]) for b in bb),
                              tuple(put(b["tgt"]) for b in bb),
                              put(np.asarray(self.pack_idx).astype(np.int64)))
        return self._dev[key]

    def tables(self, device):
        """(ent, rows, qw, items, wrows, merges) on `device`: the
        kernel's."""
        key = ("kernel", str(device))
        if key not in self._dev:
            put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
            self._dev[key] = tuple(put(a) for a in (self.ent, self.rows, self.qw, self.items,
                                                    self.wrows, self.merges))
        return self._dev[key]


def join_part(docs32, w32, layout, num_docs, fetch16, fscale, _stage=STAGE):
    """The join and pack of a part: (layout.n_rows, layout.width) f16
    (fetch16: the values times fscale, rounded to nearest) or f32. CPU
    tensors take join_part_torch over the layout's plain form; CUDA
    tensors launch csrc/join.cu over its kernel form once (counted in
    join_part.launches), or raise. Test hook: _stage, rows of more
    entries than this are searched in device memory."""
    k, ops, tmax = layout.k, layout.ops, layout.tmax
    if docs32.device.type == "cpu":
        return join_part_torch(docs32, w32, *layout.plain(docs32.device), num_docs, k, ops, tmax,
                               fetch16, fscale)
    if docs32.device.type != "cuda":
        raise ValueError(f"join_part runs on cuda or cpu, not {docs32.device}")
    dev = docs32.device
    for name, t, dtype in (("docs32", docs32, torch.int32), ("w32", w32, torch.float32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if docs32.dim() != 2 or docs32.shape[1] != BLOCK or w32.shape != docs32.shape:
        raise ValueError(f"docs32 and w32 must be (rows, {BLOCK}) alike, got "
                         f"{tuple(docs32.shape)} and {tuple(w32.shape)}")
    if not 1 <= tmax <= 32:
        raise ValueError(f"the kernel takes tmax in [1, 32] (a slot is 5 bits), got {tmax}")
    if layout.n_ranked and not 1 <= k <= KMAX:
        raise ValueError(f"the kernel takes k in [1, {KMAX}], got {k}")
    if set(ops) - set(_OP_BITS) or not ops:
        raise ValueError(f"unknown ops {ops}")
    if layout.max_blk >= docs32.shape[0]:
        raise ValueError(f"the layout names block {layout.max_blk}, docs32 has "
                         f"{docs32.shape[0]} rows")
    if fetch16 and fscale is None:
        raise ValueError("fetch16 needs fscale")
    ent, rows, qw, items, wrows, merges = layout.tables(dev)
    out = torch.empty((layout.n_rows, layout.width),
                      dtype=torch.float16 if fetch16 else torch.float32, device=dev)
    if not layout.n_rows:
        return out
    sc_vals = torch.empty((max(layout.n_scratch, 1), max(layout.n_ranked, 1), k),
                          dtype=torch.float32, device=dev)
    sc_cnt = torch.empty((max(layout.n_scratch, 1), 2), dtype=torch.int32, device=dev)
    # the merged rows' arrival counts, this launch's own (zeroed by the
    # entry point on the launch's stream)
    mcount = torch.empty(max(len(layout.merges), 1), dtype=torch.int32, device=dev)
    opbits = sum(bit for op, bit in _OP_BITS.items() if op in ops)
    lib = kernels.lib("join")
    rc = lib.ds2i_join_part(
        docs32.data_ptr(), w32.data_ptr(), ent.data_ptr(), rows.data_ptr(), qw.data_ptr(),
        items.data_ptr(), len(layout.items), wrows.data_ptr(), len(layout.wrows),
        merges.data_ptr(), mcount.data_ptr(), len(layout.merges), int(num_docs), int(k), opbits,
        int(tmax), int(_stage), int(bool(fetch16)), float(fscale) if fetch16 else 1.0,
        out.data_ptr(), sc_vals.data_ptr(), sc_cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(lib, rc, "join launch")
    join_part.launches += 1
    return out


join_part.launches = 0
