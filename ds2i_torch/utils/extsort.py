"""External-memory sort for structured numpy arrays.

TPU-native stand-in for the reference's out-of-core lambda sort
(stxxl::sort with a 16 GiB budget, optimal_hybrid_index.cpp:54,237-240):
sorted runs are formed under a caller-supplied memory budget, spilled to
disk in .npy format, then k-way merged with bounded buffers into a single
.npy file that callers consume through np.load(mmap_mode="r") — the
greedy lambda sweep then pages it lazily instead of holding every point
in RAM.

Stability matches np.argsort(kind="stable") over the key field: ties keep
input order (runs are formed in input order and the merge breaks key ties
by run index, then by intra-run order).
"""

import heapq
import os
import tempfile

import numpy as np


class _RunWriter:
    """Accumulates structured rows; spills one sorted .npy run per budget."""

    def __init__(self, dtype, key_field, budget_bytes, tmpdir):
        self.dtype = np.dtype(dtype)
        self.key_field = key_field
        self.rows_per_run = max(int(budget_bytes) // max(self.dtype.itemsize, 1), 1024)
        self.tmpdir = tmpdir
        self.run_paths = []
        self._chunks = []
        self._pending = 0
        self.total = 0

    def append(self, chunk):
        chunk = np.asarray(chunk, dtype=self.dtype)
        if not len(chunk):
            return
        self._chunks.append(chunk)
        self._pending += len(chunk)
        self.total += len(chunk)
        while self._pending >= self.rows_per_run:
            self._spill(self.rows_per_run)

    def _spill(self, nrows):
        buf = np.concatenate(self._chunks) if len(self._chunks) > 1 else self._chunks[0]
        run, rest = buf[:nrows], buf[nrows:]
        self._chunks = [rest] if len(rest) else []
        self._pending = len(rest)
        run = run[np.argsort(run[self.key_field], kind="stable")]
        path = os.path.join(self.tmpdir, f"run{len(self.run_paths)}.npy")
        np.save(path, run)
        self.run_paths.append(path)

    def finish(self):
        if self._pending:
            self._spill(self._pending)
        return self.run_paths


def _merge_runs(run_paths, key_field, out_path, buf_rows):
    """K-way merge of sorted runs into one .npy file, bounded buffers."""
    runs = [np.load(p, mmap_mode="r") for p in run_paths]
    total = sum(len(r) for r in runs)
    dtype = runs[0].dtype

    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=dtype, shape=(total,))
    # per-run read buffer state: (buffer, offset-in-buffer, offset-in-run)
    bufs = [r[: min(buf_rows, len(r))] for r in runs]
    pos = [0] * len(runs)
    base = [0] * len(runs)
    heap = []
    for ri, b in enumerate(bufs):
        if len(b):
            heapq.heappush(heap, (b[key_field][0], ri, 0))
    wrote = 0
    out_buf = np.empty(buf_rows, dtype=dtype)
    ob = 0
    while heap:
        _, ri, _ = heapq.heappop(heap)
        out_buf[ob] = bufs[ri][pos[ri]]
        ob += 1
        if ob == buf_rows:
            out[wrote : wrote + ob] = out_buf[:ob]
            wrote += ob
            ob = 0
        pos[ri] += 1
        if pos[ri] == len(bufs[ri]):
            base[ri] += len(bufs[ri])
            nxt = runs[ri][base[ri] : base[ri] + buf_rows]
            if len(nxt):
                bufs[ri] = np.asarray(nxt)
                pos[ri] = 0
            else:
                continue
        heapq.heappush(heap, (bufs[ri][key_field][pos[ri]], ri, base[ri] + pos[ri]))
    if ob:
        out[wrote : wrote + ob] = out_buf[:ob]
        wrote += ob
    assert wrote == total
    out.flush()
    return out_path


def external_sort_to_file(chunks, dtype, key_field, out_path, budget_bytes, tmpdir=None):
    """Sort an iterable of structured-array chunks by `key_field` into a
    single .npy at `out_path`. budget_bytes bounds the SIZE OF EACH
    SORTED RUN, not peak RSS: run formation concatenates the pending
    chunks and makes a stable-sorted copy, so transient peak memory is
    roughly 3x budget_bytes (pending + concatenated + reordered) plus
    merge buffers — size DS2I_SORT_BUDGET accordingly. Returns the total
    row count."""
    dtype = np.dtype(dtype)
    own_tmp = tempfile.TemporaryDirectory(dir=tmpdir or os.path.dirname(out_path) or ".")
    try:
        w = _RunWriter(dtype, key_field, budget_bytes, own_tmp.name)
        for c in chunks:
            w.append(c)
        runs = w.finish()
        if not runs:
            with open(out_path, "wb") as f:  # np.save would append .npy
                np.save(f, np.empty(0, dtype=dtype))
            return 0
        if len(runs) == 1:
            os.replace(runs[0], out_path)
            return w.total
        buf_rows = max(w.rows_per_run // max(len(runs) + 1, 2), 1024)
        _merge_runs(runs, key_field, out_path, buf_rows)
        return w.total
    finally:
        own_tmp.cleanup()
