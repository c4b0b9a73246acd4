"""CLI: generate a deterministic synthetic test collection.

Usage: python -m ds2i_torch.tools.gen_collection <basename> [num_docs]
           [--terms N] [--postings N] [--queries N] [--seed N]
           [--clustered]
"""

import argparse

from ..io import generate_collection
from ..utils import logger, stats_line


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("basename")
    ap.add_argument("num_docs", type=int, nargs="?", default=10_000)
    ap.add_argument("--terms", type=int, default=110_000)
    ap.add_argument("--postings", type=int, default=2_000_000)
    ap.add_argument("--queries", type=int, default=3_500)
    ap.add_argument("--seed", type=int, default=1729)
    ap.add_argument("--clustered", action="store_true",
                    help="dense docid bursts (the locality partitioned "
                         "EF exploits; SIGIR'14 corpora analogue)")
    args = ap.parse_args()

    num_docs, num_terms, postings = generate_collection(
        args.basename,
        num_docs=args.num_docs,
        num_terms=args.terms,
        postings_target=args.postings,
        num_queries=args.queries,
        seed=args.seed,
        clustered=args.clustered,
    )
    logger(f"generated {args.basename}: {num_docs} docs, {num_terms} terms, {postings} postings")
    stats_line(type="collection", basename=args.basename, num_docs=num_docs,
               num_terms=num_terms, postings=postings, seed=args.seed,
               clustered=bool(args.clustered))


if __name__ == "__main__":
    main()
