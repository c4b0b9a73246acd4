"""The query stream: an endless log of queries drawn from the run's seed.

The traffic mix gives the law: `query_len_p`, the probability of each
query length (entry i for i + 1 distinct terms), and `term_df_power`,
each term drawn in proportion to its list's length to that power (0.5,
the square root, is the port's generator's law for its query log). The
stream is cut into chunks of CHUNK queries; chunk c of part p is a
function of (seed, p, c) alone, so the same seed gives the same queries
however far a run reads. Part 0 is the measured window's, part 1 the
warm-up's, part 2 the training log of a transformed configuration
(deploy.py), drawn with its `corpus_seed`: no run's window or warm-up
reads it, whatever the run's seed.

Beside each query the stream keeps its work (the summed lengths of its
lists) and a uniform draw u_i in [0, 1) for Algorithm R's reservoir
(run.py): query i takes slot floor(u_i * (i + 1)) of R slots when that
is below R, so the reservoir ends as a uniform sample of whatever the
window answered, drawn from the seed.

`prefetch` draws chunks ahead, in a run's set-up, so that a batch in
the measured window is a slice of queries already drawn.
"""

import numpy as np

CHUNK = 1 << 15
WINDOW, WARMUP, TRAIN = 0, 1, 2
# buckets of the inverse-cdf table (a power of two, so u * BUCKETS is exact)
BUCKETS = 1 << 22


def law(traffic):
    """The stream's arguments from a traffic mix: (query_len_p,
    term_df_power)."""
    return traffic["query_len_p"], traffic["term_df_power"]


class Stream:
    def __init__(self, lens, seed, len_p, df_power=0.5, part=WINDOW):
        self.lens = np.asarray(lens, dtype=np.int64)
        p = self.lens.astype(np.float64) ** float(df_power)
        self.cdf = np.cumsum(p / p.sum())
        # first[b]: the first list whose cdf passes b / BUCKETS; a draw u in
        # bucket b lands at or after it and before first[b + 1]
        self.first = np.searchsorted(self.cdf, np.arange(BUCKETS + 1) / BUCKETS, side="right")
        len_p = np.asarray(len_p, dtype=np.float64)
        self.len_p = len_p / len_p.sum()
        self.seed = int(seed) % (1 << 64)
        self.part = part
        self.chunks = {}
        self.late = 0  # chunks drawn by batch() rather than by prefetch()

    def _chunk(self, c):
        got = self.chunks.get(c)
        if got is None:
            got = self.chunks[c] = self._draw(c)
            self.late += 1
        return got

    def prefetch(self, n):
        """Draws the chunks that hold queries [0, n)."""
        for c in range(-(-int(n) // CHUNK)):
            if c not in self.chunks:
                self.chunks[c] = self._draw(c)

    def _draw(self, c):
        """Chunk c: (queries as lists of term ids, their work, their
        reservoir draws, the flat terms, the queries' offsets in them)."""
        rng = np.random.default_rng([self.seed, self.part, c])
        n, m = CHUNK, len(self.len_p)
        qlen = 1 + rng.choice(m, size=n, p=self.len_p)
        cand = self._lists(rng.random((n, m + 2)))
        while True:
            first = np.ones(cand.shape, dtype=bool)
            for j in range(1, cand.shape[1]):
                first[:, j] = (cand[:, :j] != cand[:, j: j + 1]).all(axis=1)
            short = first.sum(axis=1) < qlen
            if not short.any():
                break
            # rows of heavy repeats draw again (rare)
            cand[short] = self._lists(rng.random((int(short.sum()), m + 2)))
        keep = first & (np.cumsum(first, axis=1) <= qlen[:, None])
        terms = cand[keep]
        offs = np.concatenate([[0], np.cumsum(qlen)])
        work = np.add.reduceat(self.lens[terms], offs[:-1])
        return _as_lists(terms, offs), work, rng.random(n), terms, offs

    def _lists(self, u):
        """np.searchsorted(cdf, u, side="right"), clipped to the last list,
        by the bucket table: a few vectorised steps in place of a binary
        search a draw."""
        idx = self.first[(u * BUCKETS).astype(np.int64)]
        last = len(self.cdf) - 1
        while True:
            step = self.cdf[np.minimum(idx, last)] <= u
            step &= idx < last
            if not step.any():
                return np.minimum(idx, last)
            idx += step

    def batch(self, start, size):
        """Queries [start, start + size) as lists of term ids, their work
        and their reservoir draws."""
        c0, c1 = start // CHUNK, (start + size - 1) // CHUNK
        qs, works, slots = [], [], []
        for c in range(c0, c1 + 1):
            lists, work, u = self._chunk(c)[:3]
            lo = max(start - c * CHUNK, 0)
            hi = min(start + size - c * CHUNK, CHUNK)
            qs.extend(lists[lo:hi])
            works.append(work[lo:hi])
            slots.append(u[lo:hi])
        return qs, np.concatenate(works), np.concatenate(slots)

    def terms(self, start, size):
        """The term ids of queries [start, start + size), flat."""
        c0, c1 = start // CHUNK, (start + size - 1) // CHUNK
        out = []
        for c in range(c0, c1 + 1):
            terms, offs = self._chunk(c)[3:]
            lo = max(start - c * CHUNK, 0)
            hi = min(start + size - c * CHUNK, CHUNK)
            out.append(terms[offs[lo]: offs[hi]])
        return np.concatenate(out)


def _as_lists(terms, offs):
    """Each query's terms as a list of ints: the queries of one length
    converted together."""
    qlen = np.diff(offs)
    out = [None] * len(qlen)
    for n in np.unique(qlen).tolist():
        idx = np.nonzero(qlen == n)[0]
        rows = terms[offs[idx][:, None] + np.arange(n)].tolist()
        for i, row in zip(idx.tolist(), rows):
            out[i] = row
    return out
