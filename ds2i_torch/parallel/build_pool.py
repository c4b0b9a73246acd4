"""Ordered parallel build pool — the semiasync_queue equivalent.

The reference pipelines index construction with prepare()/commit() jobs:
encode in worker threads, commit results to the output in submission order
(semiasync_queue.hpp:12-96). Here jobs are (prepare, commit) callables;
prepare runs on a thread pool in batches of >= work_per_batch expected
work, commit runs on the caller thread strictly in order — deterministic
output regardless of thread count. With 1 worker it degrades to serial
with zero thread overhead.
"""

from concurrent.futures import ThreadPoolExecutor


class OrderedBuildPool:
    def __init__(self, workers=None, work_per_batch=1 << 24):
        from ..config import Configuration

        self.workers = workers if workers is not None else Configuration.get().worker_threads
        self.work_per_batch = work_per_batch
        self._pending = []  # (future_or_result, commit)
        self._batch = []  # (prepare, commit)
        self._batch_work = 0
        self._pool = ThreadPoolExecutor(max_workers=self.workers) if self.workers > 1 else None

    def add_job(self, prepare, commit, expected_work):
        self._batch.append((prepare, commit))
        self._batch_work += expected_work
        if self._batch_work >= self.work_per_batch:
            self._flush_batch()

    def _flush_batch(self):
        if not self._batch:
            return
        batch = self._batch
        self._batch = []
        self._batch_work = 0
        if self._pool is None:
            for prepare, commit in batch:
                self._pending.append((prepare(), commit))
            self._drain()
        else:
            def run_batch(jobs):
                return [p() for p, _ in jobs]

            fut = self._pool.submit(run_batch, batch)
            self._pending.append((fut, [c for _, c in batch]))
            # bound in-flight batches like the reference's FIFO of worker_threads
            while len(self._pending) > self.workers:
                self._drain_one()

    def _drain_one(self):
        if not self._pending:
            return
        item, commit = self._pending.pop(0)
        if self._pool is None:
            commit(item)
        else:
            results = item.result()
            for c, r in zip(commit, results):
                c(r)

    def _drain(self):
        if self._pool is None:
            while self._pending:
                result, commit = self._pending.pop(0)
                commit(result)

    def complete(self):
        self._flush_batch()
        while self._pending:
            self._drain_one()
        if self._pool is not None:
            self._pool.shutdown()
