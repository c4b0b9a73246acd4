"""MaxScore: essential/non-essential list split by prefix max-score sums
(queries.hpp:478-591). Genuine cursor implementation."""

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


def maxscore_query(index, wdata, terms, k=10, scorer=BM25):
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

    ordered = sorted(enums, key=lambda s: s.max_weight)
    upper_bounds = np.cumsum([s.max_weight for s in ordered], dtype=_F32)

    non_essential = 0
    cur_doc = min(s.e.docid() for s in ordered)

    while non_essential < len(ordered) and cur_doc < num_docs:
        score = _F32(0.0)
        norm_len = wdata.norm_lens[cur_doc]
        next_doc = num_docs
        for i in range(non_essential, len(ordered)):
            s = ordered[i]
            if s.e.docid() == cur_doc:
                score = score + s.q_weight * scorer.doc_term_weight(s.e.freq(), norm_len)
                s.e.next()
            if s.e.docid() < next_doc:
                next_doc = s.e.docid()

        # try to complete evaluation with non-essential lists, best bound first
        for i in range(non_essential - 1, -1, -1):
            if not topk.would_enter(float(score + upper_bounds[i])):
                break
            s = ordered[i]
            s.e.next_geq(cur_doc)
            if s.e.docid() == cur_doc:
                score = score + s.q_weight * scorer.doc_term_weight(s.e.freq(), norm_len)

        if topk.insert(float(score)):
            while non_essential < len(ordered) and not topk.would_enter(
                float(upper_bounds[non_essential])
            ):
                non_essential += 1

        cur_doc = next_doc

    return topk.finalize()
