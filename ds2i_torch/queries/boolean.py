"""Boolean AND/OR (queries.hpp:35-131).

The reference leapfrogs cursors; the result is exactly the intersection /
union cardinality over the term's docid sets, which the oracle computes
vectorized. (The batched device engine in ds2i_tpu.engine does the same
with padded arrays under jit.)
"""

from functools import reduce

import numpy as np

from .parsing import remove_duplicate_terms


def and_query(index, terms, with_freqs=False):
    if not terms:
        return 0
    terms = remove_duplicate_terms(terms)
    lists = [index.decode_list(t) for t in terms]
    lists.sort(key=lambda df: len(df[0]))  # by increasing length, like the reference
    inter = reduce(np.intersect1d, (d for d, _ in lists))
    if with_freqs:
        for d, f in lists:
            _ = f[np.searchsorted(d, inter)]
    return len(inter)


def or_query(index, terms, with_freqs=False):
    if not terms:
        return 0
    terms = remove_duplicate_terms(terms)
    lists = [index.decode_list(t) for t in terms]
    union = reduce(np.union1d, (d for d, _ in lists))
    return len(union)
