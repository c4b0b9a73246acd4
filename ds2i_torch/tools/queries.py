"""CLI: query benchmark (queries.cpp:124-153 equivalent).

Usage: python -m ds2i_torch.tools.queries <type> <op[:op...]> <index file>
           [wand data] [-k 10] [--device cpu] [--cache-dir DIR] < queries.txt

Timing protocol mirrors op_perftest (queries.cpp:25-60): 1 untimed warmup
run, 2 timed runs over all queries, per-query microseconds; reports
mean/q50/q90/q95 as a stats_line.

--engine resident runs the ops on the batched device engine (all 9
index types): one prepared plan, whole-log passes per run, mean
per-query time (per-query quantiles are not observable in a batched
dispatch and are reported equal to the mean). It runs on the CUDA card
unless --device names another (--device cpu: the plain PyTorch path);
without a card and without --device it raises. --cache-dir keeps the
engine's derived state there across runs (ResidentEngine(cache_dir=)).
"""

import argparse
import sys
import time

import numpy as np

from ..queries import QUERY_OPS, read_queries
from ..utils import logger, stats_line
from .common import load_index, load_wand_data


def op_perftest(op_fn, queries, op_name, type_name, runs=2):
    times = []
    for run in range(runs + 1):
        run_times = []
        for terms in queries:
            t0 = time.perf_counter()
            op_fn(terms)
            run_times.append((time.perf_counter() - t0) * 1e6)
        if run:  # first run is warmup
            times.extend(run_times)
    times = np.sort(np.array(times))
    mean = float(times.mean())
    logger(f"---- {type_name} {op_name}")
    logger(f"Mean: {mean}")
    logger(f"50% quantile: {np.quantile(times, 0.5)}")
    logger(f"90% quantile: {np.quantile(times, 0.9)}")
    logger(f"95% quantile: {np.quantile(times, 0.95)}")
    stats_line(
        type=type_name, query=op_name, avg=mean,
        q50=float(np.quantile(times, 0.5)),
        q90=float(np.quantile(times, 0.9)),
        q95=float(np.quantile(times, 0.95)),
    )


def perftest(index, wdata, queries, type_name, ops, k=10):
    # warm lists (queries.cpp:79-88)
    warmed = set()
    for terms in queries:
        for t in terms:
            if t not in warmed:
                index.warmup(t)
                warmed.add(t)
    for op_name in ops:
        if op_name not in QUERY_OPS:
            logger(f"unsupported query type: {op_name}")
            continue
        op_fn = QUERY_OPS[op_name](index, wdata, k)
        op_perftest(op_fn, queries, op_name, type_name)


_ENGINE_OPS = {
    "and": ("counts",), "or": ("counts",),
    "ranked_and": ("and",), "ranked_or": ("or",),
    "wand": ("or",), "maxscore": ("or",),
}


def engine_perftest(index, wdata, queries, type_name, ops, k=10, runs=2, device=None,
                    cache_dir=None):
    from ..engine import ResidentEngine

    engine = ResidentEngine(index, wdata, device=device, cache_dir=cache_dir)
    for op_name in ops:
        if op_name not in _ENGINE_OPS:
            logger(f"unsupported query type: {op_name}")
            continue
        # wand/maxscore ride the block-max pruned plan (same results as
        # exhaustive ranked_or; ResidentEngine.wand)
        plan = engine.prepare(
            queries, k=k, ops=_ENGINE_OPS[op_name],
            prune=("maxscore" if op_name == "maxscore"
                   else op_name == "wand"),
        )
        times = []
        for run in range(runs + 1):
            t0 = time.perf_counter()
            engine.execute(plan)  # collect waits for the device
            dt = (time.perf_counter() - t0) * 1e6 / max(len(queries), 1)
            if run:
                times.append(dt)
        mean = float(np.mean(times))
        logger(f"---- {type_name} {op_name} (resident engine)")
        logger(f"Mean: {mean}")
        # per-query quantiles are not observable in one batched dispatch;
        # say so instead of faking them (use --latency-sweep for a real
        # batch-size -> latency curve)
        stats_line(type=type_name, query=op_name, engine="resident",
                   avg=mean, quantiles="n/a (batched; see --latency-sweep)")


_NATIVE_OPS = {"and": 0, "or": 1, "ranked_and": 2, "ranked_or": 3}


def native_perftest(index, wdata, queries, type_name, ops, k=10, runs=2):
    """op_perftest over the NATIVE C++ cursor engine (ds2i_cpu_block_query
    — reference-style block enumerators in C++). This is the measured
    same-machine CPU baseline for BASELINE.md: per-query microseconds,
    1 warmup + `runs` timed passes, mean/q50/q90/q95 like queries.cpp."""
    from ..native import cpu_block_query_native
    from ..queries.bm25 import BM25
    from ..queries.parsing import query_freqs

    data = np.asarray(index.lists, np.uint8)
    eps = np.asarray(index.endpoints(), np.int64)
    nl = (wdata.norm_lens if wdata is not None
          else np.ones(index.num_docs(), np.float32))
    N = float(index.num_docs())
    lens = np.array([index.list_length(i) for i in range(index.size())], np.float64)

    terms, qws, offs = [], [], [0]
    for q in queries:
        for t, m in query_freqs(q):
            terms.append(t)
            idf = np.log((N - lens[t] + 0.5) / (lens[t] + 0.5))
            qws.append(m * max(1e-6, idf) * (1 + BM25.k1))
        offs.append(len(terms))

    for op_name in ops:
        if op_name not in _NATIVE_OPS:
            logger(f"unsupported native query type: {op_name}")
            continue
        all_us = []
        for run in range(runs + 1):
            out = cpu_block_query_native(
                data, eps, index.size(), nl, index.num_docs(),
                terms, qws, offs, _NATIVE_OPS[op_name], k,
            )
            if out is None:
                raise RuntimeError("the native library is unavailable (no g++, or "
                                   "DS2I_NATIVE=0); --engine native needs it")
            if run:
                all_us.append(out[2])
        us = np.sort(np.concatenate(all_us))
        mean = float(us.mean())
        logger(f"---- {type_name} {op_name} (native C++ cursors)")
        logger(f"Mean: {mean}")
        stats_line(
            type=type_name, query=op_name, engine="native", avg=mean,
            q50=float(np.quantile(us, 0.5)), q90=float(np.quantile(us, 0.9)),
            q95=float(np.quantile(us, 0.95)),
        )


def engine_latency_sweep(index, wdata, queries, type_name, ops, k=10,
                         batch_sizes=(1, 16, 64, 1024, None), max_batches=64, device=None,
                         cache_dir=None):
    """Honest request-latency measurement: for each batch size, submit the
    log in batches of that size, timing prepare+execute per batch (a cold
    plan each time — what a serving request pays). Reports per-batch
    latency quantiles and the amortized per-query time at each point, so
    throughput-vs-latency is an explicit tradeoff (the reference's
    protocol is per-query latency, queries.cpp:25-60; a batch engine must
    report the curve instead of a single number)."""
    from ..engine import ResidentEngine

    op_name = ops[0] if ops else "ranked_and"
    eops = _ENGINE_OPS.get(op_name, ("and",))
    prune = "maxscore" if op_name == "maxscore" else op_name == "wand"
    engine = ResidentEngine(index, wdata, device=device, cache_dir=cache_dir)
    _sweep_batches(engine, queries, type_name, op_name, eops, prune, k,
                   batch_sizes, max_batches)


def _sweep_batches(engine, queries, type_name, op_name, eops, prune, k,
                   batch_sizes, max_batches):
    for bs in batch_sizes:
        size = len(queries) if bs is None else bs
        if size <= 0:
            continue
        lat = []
        # pass 0 warms the engine (norm cache, block-max tables, the
        # allocator's pools); pass 1 is the timed steady state
        for timed in (False, True):
            for lo in range(0, len(queries), size):
                if (len(lat) if timed else lo // size) >= max_batches:
                    break
                batch = queries[lo:lo + size]
                t0 = time.perf_counter()
                engine.execute(engine.prepare(batch, k=k, ops=eops, prune=prune))
                if timed:
                    lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.sort(np.array(lat))
        label = "full" if bs is None else str(size)
        logger(
            f"batch={label}: q50={np.quantile(lat, 0.5):.1f}ms "
            f"q90={np.quantile(lat, 0.9):.1f}ms q95={np.quantile(lat, 0.95):.1f}ms "
            f"({np.quantile(lat, 0.5) * 1e3 / size:.1f} us/query at q50)"
        )
        stats_line(
            type=type_name, query=op_name, engine="resident", mode="latency_sweep",
            batch=label, batches=len(lat),
            lat_ms_q50=float(np.quantile(lat, 0.5)),
            lat_ms_q90=float(np.quantile(lat, 0.9)),
            lat_ms_q95=float(np.quantile(lat, 0.95)),
            us_per_query_q50=float(np.quantile(lat, 0.5) * 1e3 / size),
        )


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("type")
    ap.add_argument("ops", help="colon-separated: and:or:ranked_and:wand:maxscore")
    ap.add_argument("index_file")
    ap.add_argument("wand_file", nargs="?")
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--queries", help="read queries from file instead of stdin")
    ap.add_argument("--engine", choices=["cursor", "resident", "native"], default="cursor",
                    help="cursor: Python reference-style enumerators; resident: "
                         "batched device engine; native: C++ cursor engine "
                         "(block_optpfor — the measured CPU baseline)")
    ap.add_argument("--latency-sweep", action="store_true",
                    help="resident engine: measure per-request latency at "
                         "batch sizes 1/16/64/1024/full instead of throughput")
    ap.add_argument("--device", default=None,
                    help="resident engine: the torch device (default: the CUDA "
                         "card; cpu runs the plain PyTorch path)")
    ap.add_argument("--cache-dir", default=None,
                    help="resident engine: keep its derived state here across runs")
    args = ap.parse_args()

    index = load_index(args.index_file, args.type)
    wdata = load_wand_data(args.wand_file) if args.wand_file else None
    queries = read_queries(args.queries if args.queries else sys.stdin)
    logger(f"{len(queries)} queries")
    if args.latency_sweep:
        engine_latency_sweep(index, wdata, queries, args.type, args.ops.split(":"), k=args.k,
                             device=args.device, cache_dir=args.cache_dir)
    elif args.engine == "native":
        native_perftest(index, wdata, queries, args.type, args.ops.split(":"), k=args.k)
    elif args.engine == "resident":
        engine_perftest(index, wdata, queries, args.type, args.ops.split(":"), k=args.k,
                        device=args.device, cache_dir=args.cache_dir)
    else:
        perftest(index, wdata, queries, args.type, args.ops.split(":"), k=args.k)


if __name__ == "__main__":
    main()
