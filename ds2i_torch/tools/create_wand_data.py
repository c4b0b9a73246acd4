"""CLI: build wand data (create_wand_data.cpp equivalent).

Usage: python -m ds2i_torch.tools.create_wand_data <collection basename> <output>
"""

import argparse

from ..io import BinaryFreqCollection, read_sizes
from ..queries import WandData
from ..utils import logger
from .common import save_wand_data


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("basename")
    ap.add_argument("output")
    args = ap.parse_args()

    coll = BinaryFreqCollection(args.basename)
    wdata = WandData.build(read_sizes(args.basename), coll)
    nbytes = save_wand_data(wdata, args.output)
    logger(f"wand data saved to {args.output} ({nbytes} bytes)")


if __name__ == "__main__":
    main()
