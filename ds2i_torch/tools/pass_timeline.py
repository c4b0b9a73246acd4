"""A torch.profiler timeline of one ranked pass on the card, split by stage.

Builds a block index of chip_smoke.py's 1x collection (10k docs, 2M
postings, 35k queries; DS2I_BENCH_* and DS2I_BENCH_CACHE as there):
--index block_optpfor (the default), block_varint, block_qmx, or
block_mixed (rebuild_mixed over block_optpfor, as chip_smoke.py builds
it); an engine on the card with its block-max metadata from the
collection, and two plans of top-10 ranked_and over the whole log:
exhaustive and and_skip (prune=True). Per plan: 2 warmup passes and 9
timed passes (host clock around execute, median µs/query); then one more
warmup pass and one pass under torch.profiler (CPU and CUDA
activities), whose stages are the engine's own spans (utils/trace.py):
"ds2i.decode" (a part's decode launches), "ds2i.join" (K3, which packs
too) and "ds2i.unpack" (collect's per-query unpack). From the exported
chrome trace: the kernels launched in the pass, the device's busy time
(the union of its kernel and copy intervals) and idle share of the
pass's host span, per stage the host time and the device time of the
kernels and copies it launched (a copy launched outside every stage is
the download), and each kernel's device time by name. One JSON line per
plan; the traces go to --out (default build/pass_timeline).

    python3 ds2i_torch/tools/pass_timeline.py [--root DIR] [--index NAME] [--out DIR] [--tag NAME]

--root: the checkout whose ds2i_torch is profiled (default: the one
holding this script); the tree must mark its stages with the ds2i.*
spans, and an older tree is timed with its own copy of this script.
Exits 1 without a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STAGES = ("ds2i.decode", "ds2i.join", "ds2i.unpack")
PASSES = 9


def _union(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def analyse(trace_path):
    """The pass's numbers from a chrome trace: launches, device busy and
    idle share, and host and device time per stage (µs)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    passes = [e for e in ann if e["name"] == "pass"]
    if len(passes) != 1:
        raise RuntimeError(f"{len(passes)} pass spans in the trace")
    p0, p1 = passes[0]["ts"], passes[0]["ts"] + passes[0]["dur"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ann if e["name"] in STAGES]
    runtime = {e["args"]["correlation"]: e["ts"] for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and p0 <= e["ts"] <= p1 + 1e6]
    stage_dev = {name: 0.0 for name in STAGES + ("download", "other")}
    stage_n = dict.fromkeys(stage_dev, 0)
    by_kernel = {}
    for e in device:
        if e.get("cat") == "kernel":
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
        t = runtime.get(e.get("args", {}).get("correlation"))
        inside = [(x - s, name) for s, x, name in spans if t is not None and s <= t <= x]
        name = min(inside)[1] if inside else (  # the innermost span
            "download" if e.get("cat") == "gpu_memcpy" else "other")
        stage_dev[name] += e["dur"]
        stage_n[name] += e.get("cat") == "kernel"
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    host = {name: sum(x - s for s, x, n in spans if n == name) for name in STAGES}
    return {
        "pass_us": p1 - p0,
        "kernels": sum(e.get("cat") == "kernel" for e in device),
        "device_busy_us": busy,
        "device_idle_share": 1.0 - busy / (p1 - p0) if device else None,
        "host_us": host,
        "device_us": stage_dev,
        "kernels_by_stage": stage_n,
        "device_us_by_kernel": by_kernel,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--out", default=os.path.join("build", "pass_timeline"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--index", default="block_optpfor",
                    choices=("block_optpfor", "block_varint", "block_qmx", "block_mixed"))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pass_timeline: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.host import (
        BinaryFreqCollection, GlobalParameters, WandData, generate_collection, make_index_type,
        mixed_choices, read_queries, read_sizes, rebuild_mixed,
    )

    num_docs = int(os.environ.get("DS2I_BENCH_DOCS", 10_000))
    postings = int(os.environ.get("DS2I_BENCH_POSTINGS", 2_000_000))
    num_terms = int(os.environ.get("DS2I_BENCH_TERMS", 110_000))
    num_queries = int(os.environ.get("DS2I_BENCH_QUERIES", 35_000))
    cache = os.environ.get("DS2I_BENCH_CACHE", os.path.join(root, "build", "ds2i_bench"))
    os.makedirs(cache, exist_ok=True)
    base = os.path.join(cache, f"coll_{num_docs}_{postings}_{num_queries}")
    if not os.path.exists(base + ".queries"):
        generate_collection(base, num_docs=num_docs, num_terms=num_terms,
                            postings_target=postings, num_queries=num_queries)
    coll = BinaryFreqCollection(base)
    wdata = WandData.build(read_sizes(base), coll)
    queries = read_queries(base + ".queries")
    built = "block_optpfor" if args.index == "block_mixed" else args.index
    b = make_index_type(built).builder(coll.num_docs, GlobalParameters())
    for docs, freqs in coll:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs, dtype=np.int64).sum()))
    index = b.build()
    if args.index == "block_mixed":
        index = rebuild_mixed(index, *mixed_choices(index))
    eng = ResidentEngine(index, wdata, device="cuda")
    eng.build_blockmax(coll)
    plans = {"exhaustive": eng.prepare(queries, k=10, ops=("and",)),
             "and_skip": eng.prepare(queries, k=10, ops=("and",), prune=True)}
    times = {}
    for name, plan in plans.items():
        for _ in range(2):
            eng.execute(plan)
        torch.cuda.synchronize()
        times[name] = []
        for _ in range(PASSES):
            t = time.perf_counter()
            eng.execute(plan)
            times[name].append((time.perf_counter() - t) / len(queries) * 1e6)
    os.makedirs(args.out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, plan in plans.items():
        eng.execute(plan)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("pass"):
                eng.execute(plan)
            torch.cuda.synchronize()
        path = os.path.join(args.out, f"timeline_{args.tag}_{name}.json")
        prof.export_chrome_trace(path)
        out = {"tree": args.tag, "index": args.index, "plan": name, "parts": len(plan["plans"]),
               "us_per_query_median": statistics.median(times[name]),
               "us_per_query_min": min(times[name]), "us_per_query_max": max(times[name]),
               "card": smi, **analyse(path)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
