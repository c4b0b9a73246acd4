"""Exhaustive ranked retrieval: ranked AND (queries.hpp:322-401) and
ranked OR / DAAT (queries.hpp:404-476) — the gold standard the pruned
algorithms are verified against.

Float behavior: scores accumulate in float32 in enumerator order, matching
the reference's summation order (per-doc additions happen in the same term
order), so scores are bit-comparable on identical inputs.
"""

import numpy as np

from .bm25 import BM25
from .parsing import query_freqs

_F32 = np.float32


def _scored_lists(index, wdata, terms, scorer):
    """[(docs, freqs, q_weight)] in query_freqs (term-id) order."""
    num_docs = index.num_docs()
    out = []
    for term, qf in query_freqs(terms):
        docs, freqs = index.decode_list(term)
        qw = scorer.query_term_weight(qf, len(docs), num_docs)
        out.append((docs, freqs, qw))
    return out


def ranked_and_query(index, wdata, terms, k=10, scorer=BM25):
    if not terms:
        return []
    lists = _scored_lists(index, wdata, terms, scorer)
    # reference sorts enums by increasing list length before scoring
    lists.sort(key=lambda x: len(x[0]))
    inter = lists[0][0]
    for docs, _, _ in lists[1:]:
        inter = np.intersect1d(inter, docs)
    if len(inter) == 0:
        return []
    norm = wdata.norm_lens[inter.astype(np.int64)]
    score = np.zeros(len(inter), dtype=_F32)
    for docs, freqs, qw in lists:
        f = freqs[np.searchsorted(docs, inter)]
        score = score + qw * scorer.doc_term_weight(f, norm)
    top = np.sort(score)[::-1][:k]
    return [float(s) for s in top]


def ranked_or_query(index, wdata, terms, k=10, scorer=BM25):
    if not terms:
        return []
    lists = _scored_lists(index, wdata, terms, scorer)
    union = lists[0][0]
    for docs, _, _ in lists[1:]:
        union = np.union1d(union, docs)
    if len(union) == 0:
        return []
    norm = wdata.norm_lens[union.astype(np.int64)]
    score = np.zeros(len(union), dtype=_F32)
    for docs, freqs, qw in lists:
        pos = np.searchsorted(union, docs)
        score[pos] = score[pos] + qw * scorer.doc_term_weight(freqs, norm[pos])
    top = np.sort(score)[::-1][:k]
    return [float(s) for s in top]
