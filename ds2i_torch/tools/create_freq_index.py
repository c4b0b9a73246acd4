"""CLI: build a freq index (create_freq_index.cpp:111-153 equivalent).

Usage: python -m ds2i_torch.tools.create_freq_index <type> <collection basename>
           [output] [--check]
"""

import argparse
import time

import numpy as np

from ..global_params import GlobalParameters
from ..index.types import INDEX_TYPES, make_index_type
from ..index.verify import verify_collection
from ..io import BinaryFreqCollection
from ..utils import ProgressLogger, logger, stats_line
from .common import postings_stats, save_index


def _partition_stats(type_name, index):
    """Type-specific stats for the partitioned types: number of partitions
    and average partition size over the docs sequences
    (create_freq_index.cpp:22-59 dump_stats specializations)."""
    from ..sequences.partitioned import _PartitionedBase

    seq = getattr(index, "docs_sequence_type", None)
    if not (isinstance(seq, type) and issubclass(seq, _PartitionedBase)):
        return
    partitions = 0
    docs = 0
    for i in range(index.size()):
        _, n, docs_offset = index._header(i)
        partitions += seq.num_partitions(
            index.docs_sequences.bits(), docs_offset, index.num_docs(), n, index.params
        )
        docs += n
    stats_line(type=type_name, partitions=partitions,
               docs_avg_part=docs / max(partitions, 1))


def create_collection(type_name, basename, output=None, check=False, params=None):
    cls = make_index_type(type_name)
    coll = BinaryFreqCollection(basename)
    params = params or GlobalParameters()

    t0 = time.time()
    b = cls.builder(coll.num_docs, params)
    plog = ProgressLogger("sequences")
    for docs, freqs in coll:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs, dtype=np.int64).sum()))
        plog.done_item()
    index = b.build()
    elapsed = time.time() - t0
    logger(f"{type_name} collection built in {elapsed:.3f} seconds")

    stats = postings_stats(index, coll)
    workers = b.pool.workers if hasattr(b, "pool") else 1
    stats_line(type=type_name, worker_threads=workers,
               construction_time=elapsed, **stats)
    _partition_stats(type_name, index)

    if output:
        nbytes = save_index(index, output)
        stats_line(type=type_name, size=nbytes,
                   bits_per_posting=nbytes * 8.0 / stats["postings"])
    if check:
        verify_collection(coll, index)
    return index


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("type", choices=None)
    ap.add_argument("basename")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    create_collection(args.type, args.basename, args.output, args.check)


if __name__ == "__main__":
    main()
