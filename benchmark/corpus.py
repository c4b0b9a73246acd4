"""The benchmark's collection generator.

A copy of the port's `io/gen_collection.py` distributions (Zipf document
frequencies scaled to a postings target, half of each term's postings
drawn near a per-term centre, geometric within-document counts), drawing
the same random numbers in the same order, so that the files are byte
for byte the port's for the same arguments. The per-term write loop is
replaced by one vectorised layout of each file. The query log is not
written: the benchmark's queries come from `stream.py`.

Files, ds2i's binary collection format (`<len u32><u32 ...>` sequences):
`<base>.docs` (a singleton holding num_docs, then each non-empty term's
sorted docids), `<base>.freqs`, `<base>.sizes`; beside them
`<base>.lens.npy`, each non-empty list's length, which lets a reader
find the lists without walking the files.
"""

import numpy as np


def postings(num_docs, num_terms, postings_target, seed, clustered=False):
    """(docs u32, freqs u32, lens i64): the non-empty lists' postings in
    term order, docids sorted within each list, and their lengths."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, num_terms + 1, dtype=np.float64)
    weights = 1.0 / ranks
    dfs = np.maximum(1, (weights / weights.sum() * postings_target)).astype(np.int64)
    dfs = np.minimum(dfs, num_docs)
    rng.shuffle(dfs)
    rep = (dfs * 1.25 + 4).astype(np.int64)
    term_rep = np.repeat(np.arange(num_terms, dtype=np.int64), rep)
    if clustered:
        offs = np.cumsum(rep) - rep
        intra = np.arange(len(term_rep), dtype=np.int64) - offs[term_rep]
        nclust = (rep + 63) // 64
        cbase = np.cumsum(nclust) - nclust
        cid = cbase[term_rep] + (intra >> 6)
        total_c = int(nclust.sum())
        centers_c = rng.randint(0, num_docs, size=total_c).astype(np.int64)
        steps_c = 1.0 + 0.3 * rng.rand(total_c)
        docs_draw = (
            centers_c[cid] + np.floor((intra & 63) * steps_c[cid]).astype(np.int64)
        ) % num_docs
    else:
        centers = rng.randint(0, num_docs, size=num_terms)
        local = rng.rand(len(term_rep)) < 0.5
        spread = np.maximum(50, num_docs // 20)
        docs_draw = np.where(
            local,
            (centers[term_rep] + rng.randint(-spread, spread, size=len(term_rep))) % num_docs,
            rng.randint(0, num_docs, size=len(term_rep)),
        )
    keys = np.unique(term_rep * np.int64(num_docs) + docs_draw)
    terms = keys // num_docs
    docs = (keys % num_docs).astype(np.uint32)
    freqs = np.minimum(rng.geometric(0.55, size=len(docs)), 1000).astype(np.uint32)
    lens = np.bincount(terms, minlength=num_terms).astype(np.int64)
    return docs, freqs, lens[lens > 0]


def _layout(flat, lens, head=()):
    """One u32 array of `head` followed by `<len><values>` per list."""
    head = np.asarray(head, dtype="<u4")
    out = np.empty(len(head) + len(lens) + len(flat), dtype="<u4")
    out[: len(head)] = head
    body = out[len(head):]
    at = np.cumsum(lens + 1) - (lens + 1)
    mask = np.ones(len(body), dtype=bool)
    mask[at] = False
    body[at] = lens
    body[mask] = flat
    return out


def write(basename, num_docs, num_terms, postings_target, seed, clustered=False):
    """Writes the collection's files; returns (num_docs, lists, postings,
    bytes written)."""
    docs, freqs, lens = postings(num_docs, num_terms, postings_target, seed, clustered)
    sizes = np.bincount(docs, weights=freqs.astype(np.float64), minlength=num_docs)
    sizes = np.maximum(sizes.astype(np.uint32), 1)
    written = 0
    for ext, arr in ((".docs", _layout(docs, lens, (1, num_docs))),
                     (".freqs", _layout(freqs, lens)),
                     (".sizes", _layout(sizes, np.array([num_docs], np.int64)))):
        arr.tofile(str(basename) + ext)
        written += arr.nbytes
    np.save(str(basename) + ".lens.npy", lens)
    return num_docs, len(lens), len(docs), written + lens.nbytes


class Collection:
    """The written files read back as flat arrays (memory maps)."""

    def __init__(self, basename):
        self.lens = np.load(str(basename) + ".lens.npy")
        docs = np.memmap(str(basename) + ".docs", dtype="<u4", mode="r")
        self.num_docs = int(docs[1])
        self.docs = docs[2:]
        self.freqs = np.memmap(str(basename) + ".freqs", dtype="<u4", mode="r")
        self.sizes = np.memmap(str(basename) + ".sizes", dtype="<u4", mode="r")[1:]
        # list i's values sit after its length word: i + 1 + sum(lens[:i])
        self.start = np.cumsum(self.lens + 1) - self.lens

    def list(self, i):
        s, n = int(self.start[i]), int(self.lens[i])
        return self.docs[s: s + n], self.freqs[s: s + n]
