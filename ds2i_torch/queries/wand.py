"""WAND: document-at-a-time pruning with list-level score bounds
(queries.hpp:200-319). Genuine cursor implementation — an independent
algorithm from the exhaustive ranked_or oracle it is tested against."""

import numpy as np

from .bm25 import BM25
from .parsing import query_freqs
from .topk import TopKQueue

_F32 = np.float32


class _ScoredEnum:
    __slots__ = ("e", "q_weight", "max_weight")

    def __init__(self, e, q_weight, max_weight):
        self.e = e
        self.q_weight = q_weight
        self.max_weight = max_weight


def wand_query(index, wdata, terms, k=10, scorer=BM25):
    if not terms:
        return []
    num_docs = index.num_docs()
    topk = TopKQueue(k)

    enums = []
    for term, qf in query_freqs(terms):
        e = index[term]
        qw = scorer.query_term_weight(qf, e.size(), num_docs)
        mw = _F32(qw) * wdata.max_term_weight[term]
        enums.append(_ScoredEnum(e, _F32(qw), _F32(mw)))

    ordered = sorted(enums, key=lambda s: s.e.docid())

    while True:
        # find pivot: first prefix whose sum of max_weights would enter top-k
        upper_bound = _F32(0.0)
        pivot = None
        for i, s in enumerate(ordered):
            if s.e.docid() == num_docs:
                break
            upper_bound = upper_bound + s.max_weight
            if topk.would_enter(upper_bound):
                pivot = i
                break
        if pivot is None:
            break

        pivot_id = ordered[pivot].e.docid()
        if pivot_id == ordered[0].e.docid():
            score = _F32(0.0)
            norm_len = wdata.norm_lens[pivot_id]
            for s in ordered:
                if s.e.docid() != pivot_id:
                    break
                score = score + s.q_weight * scorer.doc_term_weight(s.e.freq(), norm_len)
                s.e.next()
            topk.insert(float(score))
            ordered.sort(key=lambda s: s.e.docid())
        else:
            # advance the farthest-behind list among those before the pivot
            next_list = pivot
            while ordered[next_list].e.docid() == pivot_id:
                next_list -= 1
            ordered[next_list].e.next_geq(pivot_id)
            # bubble it down to keep docid order
            for i in range(next_list + 1, len(ordered)):
                if ordered[i].e.docid() < ordered[i - 1].e.docid():
                    ordered[i], ordered[i - 1] = ordered[i - 1], ordered[i]
                else:
                    break

    return topk.finalize()
