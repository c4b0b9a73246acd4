"""Precomputed ranking metadata (wand_data.hpp:14-85): normalized document
lengths and per-term maximum term weight (list-level score bounds — the
reference has no block-max structure; SURVEY.md §2.4)."""

import numpy as np

from ..utils import logger
from .bm25 import BM25

_F32 = np.float32


class WandData:
    def __init__(self, norm_lens, max_term_weight):
        self.norm_lens = np.asarray(norm_lens, dtype=_F32)
        self.max_term_weight = np.asarray(max_term_weight, dtype=_F32)

    @classmethod
    def build(cls, sizes, collection, scorer=BM25):
        """sizes: per-document lengths; collection: iterable of (docs, freqs)."""
        lens = np.asarray(sizes, dtype=_F32)
        num_docs = len(lens)
        avg_len = _F32(float(lens.sum(dtype=np.float64)) / num_docs)
        norm_lens = lens / avg_len
        logger("Storing max weight for each list...")
        mtw = []
        for docs, freqs in collection:
            scores = scorer.doc_term_weight(np.asarray(freqs), norm_lens[np.asarray(docs)])
            mtw.append(scores.max() if len(scores) else _F32(0.0))
        return cls(norm_lens, np.array(mtw, dtype=_F32))

    def norm_len(self, docid):
        return self.norm_lens[docid]

    def tree(self):
        return {"m_norm_lens": self.norm_lens, "m_max_term_weight": self.max_term_weight}

    @classmethod
    def from_tree(cls, t):
        return cls(t["m_norm_lens"], t["m_max_term_weight"])
