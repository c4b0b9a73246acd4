"""CLI: build the optimal hybrid (block_mixed) index
(optimal_hybrid_index.cpp equivalent).

Usage: python -m ds2i_torch.tools.optimal_hybrid_index <type> <predictors>
           <block_stats> <input_index> <lambdas_file> <budget>
           [output_index] [--check <collection basename>]

budget 0 dumps space/time tradeoff samples to the output file instead of
building. The lambda computation is checkpointed in <lambdas_file>
(delete to recompute).
"""

import argparse

from ..codecs.time_prediction import load_predictors, read_block_stats
from ..index.hybrid import compute_lambdas, greedy_tradeoff, rebuild_mixed
from ..index.verify import verify_collection
from ..io import BinaryFreqCollection
from ..utils import logger, stats_line
from .common import postings_stats, save_index, load_index


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("type")
    ap.add_argument("predictors")
    ap.add_argument("block_stats")
    ap.add_argument("input_index")
    ap.add_argument("lambdas_file")
    ap.add_argument("budget", type=int)
    ap.add_argument("output_index", nargs="?")
    ap.add_argument("--check", metavar="BASENAME")
    args = ap.parse_args()

    index = load_index(args.input_index, args.type)
    logger(f"Processing {index.size()} posting lists")

    predictors = load_predictors(args.predictors)
    counts = {}
    with open(args.block_stats) as f:
        for list_id, block_counts in read_block_stats(f):
            counts[list_id] = block_counts

    lambdas = compute_lambdas(index, predictors, counts, args.lambdas_file)

    if args.budget == 0:
        with open(args.output_index or "tradeoffs.tsv", "w") as f:
            greedy_tradeoff(index, lambdas, 0, tradeoff_log=f)
        logger("Done")
        return

    block_types, block_params = greedy_tradeoff(index, lambdas, args.budget)
    mixed = rebuild_mixed(index, block_types, block_params, index.params)
    stats = postings_stats(mixed, None)
    stats_line(type="block_mixed", **stats)
    if args.output_index:
        nbytes = save_index(mixed, args.output_index)
        stats_line(type="block_mixed", size=nbytes,
                   bits_per_posting=nbytes * 8.0 / stats["postings"])
    if args.check:
        verify_collection(BinaryFreqCollection(args.check), mixed)


if __name__ == "__main__":
    main()
