"""CLI: collect per-block access counts (profile_queries.cpp equivalent).

Usage: python -m ds2i_torch.tools.profile_queries <type> <op[:op...]> <index>
           [wand data] [--queries FILE] [--out FILE] [--replay]

Dumps `term\\tc0 c1 ...` TSV (docs/freqs counts interleaved per block) —
the input of the decode-time model and the hybrid-index optimizer.

The engine's cost model is whole-list decode per (query, unique term)
access (utils/block_profiler.py divergence note), which makes the
profile a CLOSED FORM of the query log: no execution needed. The default
path computes it vectorized — the batched-replay answer to the
reference's every-hardware-thread replay (profile_queries.cpp:21-40),
keeping the WSDM'15 pipeline usable at 10x-50x scale (seconds, not
hours). --replay runs the original serial cursor replay; both paths are
asserted equal in tests/test_tools_cli.py.
"""

import argparse
import sys

import numpy as np

from ..queries import QUERY_OPS, read_queries
from ..utils import logger
from ..utils.block_profiler import BlockProfiler
from .common import load_index, load_wand_data


def fast_profile(index, queries, num_ops):
    """Closed-form profile: every (query, unique term) access counts one
    whole-list decode of docs and freqs, per op."""
    prof = BlockProfiler()
    uniq = [np.unique(np.asarray(t, dtype=np.int64)) for t in queries if len(t)]
    if not uniq:
        return prof
    flat = np.concatenate(uniq)
    acc = np.bincount(flat, minlength=index.size())
    for t in np.nonzero(acc)[0]:
        n = index.list_length(int(t))
        blocks = -(-n // index.codec.block_size)
        c = prof.open_list(int(t), blocks)
        c[:] = int(acc[t]) * num_ops
    return prof


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("type")
    ap.add_argument("ops")
    ap.add_argument("index_file")
    ap.add_argument("wand_file", nargs="?")
    ap.add_argument("--queries")
    ap.add_argument("--out")
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--replay", action="store_true",
                    help="serial cursor replay instead of the closed form")
    args = ap.parse_args()

    index = load_index(args.index_file, args.type)
    if not hasattr(index, "profiler"):
        raise SystemExit("profiling requires a block index type")
    wdata = load_wand_data(args.wand_file) if args.wand_file else None
    queries = read_queries(args.queries if args.queries else sys.stdin)
    logger(f"{len(queries)} queries")

    ops = args.ops.split(":")
    if args.replay:
        index.profiler = BlockProfiler()
        for op_name in ops:
            op = QUERY_OPS[op_name](index, wdata, args.k)
            for terms in queries:
                op(terms)
        prof = index.profiler
    else:
        prof = fast_profile(index, queries, len(ops))

    out = open(args.out, "w") if args.out else sys.stdout
    prof.dump(out)
    if args.out:
        out.close()
        logger(f"block stats written to {args.out}")


if __name__ == "__main__":
    main()
