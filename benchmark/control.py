"""The control of the comparison that decides `correct`: the plain
reference computed in bfloat16, the precision below the float32 the
configurations state, put in the program's place (its ranked_and or
ranked_or, as the cell's traffic is judged: run.JUDGED). `--precision f16`
reads the reference computed in float16 the same way.

For a cell and each seed it draws the window's stream and sample as a
run does (`run.Sampler` over the first --queries queries of the seed's
stream, in the cell's batches), answers the sample with the bfloat16
reference, and judges those answers against the float32 reference by
the run's own comparison (`reference.judge`). A sound comparison reads
the control as not correct. The benchmark's runs do not run this; it
reads the configuration's built files, so a run of the cell comes first.

    python3 benchmark/control.py --workload <cell> --queries N --seeds S [S ...] [--precision f16]

prints one JSON line a seed.
"""

import argparse
import json
import os
import sys

import run

import corpus
import deploy
import reference
import stream as stream_mod


def reading(name, seed, n_queries, root=run.ROOT, precision="bf16"):
    """The judged numbers of the reference's answers in `precision` (a
    name in reference.PRECISIONS) on the sample a run of `name` with
    `seed` would compare after answering n_queries queries."""
    cell, _, cfg, traffic, _ = run.resolve(name, False, root)
    method = run.judged_by(cell, traffic)[1]
    coll = corpus.Collection(os.path.join(deploy.build_dir(root, cfg), "coll"))
    exact = getattr(reference.Reference(coll, cfg["bm25_k1"], cfg["bm25_b"]), method)
    low = getattr(reference.Reference(coll, cfg["bm25_k1"], cfg["bm25_b"], precision), method)
    stream = stream_mod.Stream(coll.lens, seed, *stream_mod.law(traffic))
    sampler = run.Sampler(run.RESERVOIR, run.HEAVIEST)
    k, B = cfg["k"], traffic["batch"]
    for pos in range(0, n_queries, B):
        qs, work, u = stream.batch(pos, B)
        sampler.add(pos, qs, work, u, lambda i: low(qs[i], k))
    sample = sampler.picks()
    numbers = reference.judge([g for _, g in sample], [exact(t, k) for t, _ in sample])
    return numbers, len(sample)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--queries", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", choices=("bf16", "f16"), default="bf16")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        numbers, n = reading(args.workload, seed, args.queries, precision=args.precision)
        print(json.dumps({"workload": args.workload, "seed": seed, "queries": args.queries,
                          "precision": args.precision,
                          "compared": n, "correct": reference.passes(numbers),
                          "checks": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
