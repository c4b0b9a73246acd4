"""decode_roofline: the least time the decode of the window's batches
could take on the chip's memory bandwidth, over the decode kernels'
device time, in percent.

The least bytes are the work the queries need, whatever implements it:
for each term distinct within a batch, its compressed docs and freqs
read once (the configuration's list sizes, from the built index's list
boundaries) and 8 B for each of its postings written once (a docid and a
weight). This holds for exhaustive plans, which decode every posting of
every term; where pruning decides the work the count is not this simple,
and the metric is listed for exhaustive cells only."""

import numpy as np

from metrics.decode_dev_us_per_query import decode_seconds
from peaks import HBM_BYTES_PER_S


def batch_bytes(terms, list_bytes, lens):
    """The least bytes a decode of one batch's distinct `terms` needs."""
    terms = np.unique(np.asarray(terms, dtype=np.int64))
    return int(list_bytes[terms].sum() + 8 * lens[terms].sum())


def read(run):
    if run.trace is None or not run.batch_terms:
        return None
    n, s = decode_seconds(run.trace)
    if not n or s <= 0:
        return None
    nbytes = sum(batch_bytes(t, run.list_bytes, run.lens) for t in run.batch_terms)
    return 100.0 * nbytes / HBM_BYTES_PER_S / s
