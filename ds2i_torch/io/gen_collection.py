"""Deterministic synthetic test-collection generator.

The reference ships test/test_data/test_collection.{docs,freqs,sizes} (10k
docs) which is absent from this mount (SURVEY.md, repo facts). This module
regenerates a statistically compatible collection: Zipf-distributed document
frequencies over the vocabulary, clustered docids (docid locality is what
partitioned EF exploits), geometric within-document term counts, plus a
query log sampled by term frequency.
"""

import numpy as np

from .binary_collection import write_binary_collection


def generate_collection(
    basename,
    num_docs=10_000,
    num_terms=110_000,
    postings_target=2_000_000,
    num_queries=3_500,
    max_query_len=4,
    seed=1729,
    clustered=False,
):
    """Writes <basename>.{docs,freqs,sizes} and <basename>.queries.

    clustered=True generates STRONGLY clustered docids — each list's
    postings form dense bursts of near-consecutive docids (the docid
    locality of url/crawl-ordered corpora that partitioned Elias-Fano
    exploits, optimal_partition.hpp:70-121 / SIGIR'14 §6: dense runs
    become all-ones or low-bitsize partitions). The default mixes 50%
    per-term locality with 50% uniform draws, which leaves opt/uniform
    little to gain over flat EF (docs/PERF.md space table).

    Returns (num_docs, num_terms_written, total_postings).
    """
    rng = np.random.RandomState(seed)

    # Zipf-ish document frequencies per term, scaled to the postings target.
    ranks = np.arange(1, num_terms + 1, dtype=np.float64)
    weights = 1.0 / ranks
    dfs = np.maximum(1, (weights / weights.sum() * postings_target)).astype(np.int64)
    dfs = np.minimum(dfs, num_docs)
    rng.shuffle(dfs)  # term-id order is not frequency order in real collections

    # Draw (term, doc) pairs in bulk; dedupe via a combined key. np.unique
    # sorts, giving docids sorted within each term for free.
    rep = (dfs * 1.25 + 4).astype(np.int64)
    term_rep = np.repeat(np.arange(num_terms, dtype=np.int64), rep)
    if clustered:
        # dense bursts: posting p of a term belongs to cluster p//64 and
        # sits at center + floor((p%64) * step), step in [1, 1.3) per
        # cluster — runs of (near-)consecutive docids with ~25% skips
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
        # half the mass drawn from a per-term cluster center for docid
        # locality
        centers = rng.randint(0, num_docs, size=num_terms)
        local = rng.rand(len(term_rep)) < 0.5
        spread = np.maximum(50, num_docs // 20)
        docs_draw = np.where(
            local,
            (centers[term_rep] + rng.randint(-spread, spread, size=len(term_rep))) % num_docs,
            rng.randint(0, num_docs, size=len(term_rep)),
        )
    keys = np.unique(term_rep * np.int64(num_docs) + docs_draw)
    terms = (keys // num_docs).astype(np.int64)
    docs = (keys % num_docs).astype(np.uint32)
    freqs = np.minimum(rng.geometric(0.55, size=len(keys)), 1000).astype(np.uint32)

    # split per term
    starts = np.searchsorted(terms, np.arange(num_terms))
    ends = np.searchsorted(terms, np.arange(num_terms) + 1)

    def doc_seqs():
        yield np.array([num_docs], dtype=np.uint32)
        for t in range(num_terms):
            if ends[t] > starts[t]:
                yield docs[starts[t] : ends[t]]

    def freq_seqs():
        for t in range(num_terms):
            if ends[t] > starts[t]:
                yield freqs[starts[t] : ends[t]]

    write_binary_collection(str(basename) + ".docs", doc_seqs())
    write_binary_collection(str(basename) + ".freqs", freq_seqs())

    sizes = np.bincount(docs, weights=freqs.astype(np.float64), minlength=num_docs).astype(np.uint32)
    sizes = np.maximum(sizes, 1)
    write_binary_collection(str(basename) + ".sizes", [sizes])

    # query log: term ids (of non-empty lists) sampled ~ sqrt(df)
    nonempty = np.nonzero(ends > starts)[0]
    # remap: term-ids in the index are positions among non-empty lists
    df_ne = (ends - starts)[nonempty].astype(np.float64)
    p = np.sqrt(df_ne)
    cdf = np.cumsum(p / p.sum())
    nt = len(nonempty)

    def draw(k):
        # inverse-cdf sampling without replacement (np.random.choice with
        # p= revalidates the whole vector per call — O(num_terms), hours
        # at multi-million vocabularies).
        # NOTE: this is batched with-replacement draws deduplicated in
        # order — a different weighted without-replacement scheme (and RNG
        # consumption) than successive np.random.choice(replace=False),
        # so query logs generated at the same seed differ from pre-change
        # logs; regenerate any cached .queries files (DS2I_BENCH_CACHE)
        # rather than mixing old and new logs in comparisons.
        k = min(k, nt)  # can't draw more distinct terms than exist
        picks = []
        while len(picks) < k:
            cand = np.minimum(np.searchsorted(cdf, rng.rand(2 * k), side="right"), nt - 1)
            picks = list(dict.fromkeys([*picks, *cand.tolist()]))[:k]
        return picks

    with open(str(basename) + ".queries", "w") as f:
        for _ in range(num_queries):
            qlen = rng.randint(1, max_query_len + 1)
            f.write(" ".join(str(int(t)) for t in draw(qlen)) + "\n")

    return num_docs, int(len(nonempty)), int(len(keys))
