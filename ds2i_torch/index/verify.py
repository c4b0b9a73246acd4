"""Full index verification against the source collection
(verify_collection.hpp:10-54): every list, every posting, docid+freq equality."""

import numpy as np

from ..utils import logger


def verify_collection(collection, index):
    """Raises AssertionError on first mismatch; returns posting count."""
    if len(collection) != index.size():
        raise AssertionError(f"list count mismatch: {len(collection)} vs {index.size()}")
    total = 0
    for i, (docs, freqs) in enumerate(collection):
        d, f = index.decode_list(i)
        if not np.array_equal(d, np.asarray(docs, dtype=np.uint64)):
            raise AssertionError(f"docs mismatch in list {i}")
        if not np.array_equal(f, np.asarray(freqs, dtype=np.uint64)):
            raise AssertionError(f"freqs mismatch in list {i}")
        total += len(d)
    logger(f"verified {index.size()} lists, {total} postings")
    return total
