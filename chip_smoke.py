#!/usr/bin/env python3
"""Smoke run of the ds2i_torch port on one CUDA card.

Drives the port's two main paths once at bench.py's default scale:
top-10 BM25 ranked_and over the deterministic 10k-doc / 2M-posting
collection with its 35k-query log, first over a partitioned Elias-Fano
(`opt`) index in pair mode, then over a `block_optpfor` index in split
mode (bench.py's default index type).

  1. card name and power limit (nvidia-smi), torch and CUDA versions
  2. build the CUDA kernels from csrc/ (one nvcc per source, all at
     once), print the build seconds
  3. generate (or reuse) the collection and its WandData
  opt path (pair mode, kernel pair_decode):
  4. kernel phase: decode every tile of the index, both streams and the
     docs stream alone, through the CUDA kernel and through its plain
     PyTorch version on the card; bit equality, both times (CUDA events,
     median of 5), with and without the host's launch overhead; 200
     random lists against the host decoder
  5. slice phase: ResidentEngine(device="cuda"), prepare the full query
     log, 1 warmup + 9 timed passes of execute; us/query and the
     kernels' launch counts over the run (every count set to 0 just
     before it)
  6. oracle phase: the first 300 queries against the numpy oracle
     (counts exact, top-10 scores within rtol 1e-3)
  block_optpfor path (split mode, kernels optpfor_decode and
  interp_decode): the same three phases, the kernel phase per kernel
  over every group of both streams
  7. block_interpolative: a smaller oracle-only run (100 queries)
  8. the kernels' JSON line, then {"ok": true, "device": {...}} last

Exits non-zero, printing no result, without a CUDA device or when any
check fails. Scale: DS2I_BENCH_DOCS / _POSTINGS / _TERMS / _QUERIES as
in bench.py; the collection is cached under build/ds2i_bench (or
DS2I_BENCH_CACHE).

    python3 chip_smoke.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.environ.get("DS2I_BENCH_CACHE", os.path.join(HERE, "build", "ds2i_bench"))
NUM_DOCS = int(os.environ.get("DS2I_BENCH_DOCS", 10_000))
POSTINGS = int(os.environ.get("DS2I_BENCH_POSTINGS", 2_000_000))
NUM_TERMS = int(os.environ.get("DS2I_BENCH_TERMS", 110_000))
NUM_QUERIES = int(os.environ.get("DS2I_BENCH_QUERIES", 35_000))
ORACLE_QUERIES = 300
INTERP_ORACLE_QUERIES = 100
RTOL = 1e-3  # the reference's ranked-test tolerance (test_ranked_queries.cpp:52)
PASSES = 9


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=5):
    """Median over reps of fn's device time in ms (CUDA events), after
    one untimed warmup call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_only_ms(fn, reps=5):
    """Median over reps of the device time of fn's launches alone, in ms.
    A spin kernel holds the stream while the host enqueues fn's launches,
    so the events bracket back-to-back device work without the host's
    launch overhead. The spin doubles until it lasts twice the enqueue;
    None when no spin up to ~1 s does (a full launch queue blocks the
    enqueue until the spin ends)."""
    import torch

    fn()
    cycles, times = 1 << 22, []
    while len(times) < reps:
        s0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t) * 1e3
        end.record()
        end.synchronize()
        if s0.elapsed_time(start) > 2 * enqueue_ms:
            times.append(start.elapsed_time(end))
        elif cycles >= 1 << 31:
            return None
        else:
            cycles *= 2
    return statistics.median(times)


def load_collection():
    from ds2i_torch.host import (
        BinaryFreqCollection, WandData, generate_collection, read_queries, read_sizes,
    )

    os.makedirs(CACHE, exist_ok=True)
    base = os.path.join(CACHE, f"coll_{NUM_DOCS}_{POSTINGS}_{NUM_QUERIES}")
    t0 = time.perf_counter()
    if not os.path.exists(base + ".queries"):
        generate_collection(base, num_docs=NUM_DOCS, num_terms=NUM_TERMS,
                            postings_target=POSTINGS, num_queries=NUM_QUERIES)
    coll = BinaryFreqCollection(base)
    wdata = WandData.build(read_sizes(base), coll)
    queries = read_queries(base + ".queries")
    log(f"collection: {NUM_DOCS} docs, {POSTINGS} postings target, {len(queries)} queries "
        f"({time.perf_counter() - t0:.1f} s)")
    return coll, wdata, queries


def build_index(coll, name):
    from ds2i_torch.host import GlobalParameters, make_index_type

    t0 = time.perf_counter()
    b = make_index_type(name).builder(coll.num_docs, GlobalParameters())
    for docs, freqs in coll:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs, dtype=np.int64).sum()))
    index = b.build()
    log(f"{name} index: {index.size()} lists ({time.perf_counter() - t0:.1f} s)")
    return index


def start_engine(index, wdata):
    import torch

    from ds2i_torch.engine import ResidentEngine

    t0 = time.perf_counter()
    eng = ResidentEngine(index, wdata, device="cuda")
    torch.cuda.synchronize()
    log(f"engine init (host tile tables + upload): {time.perf_counter() - t0:.1f} s")
    return eng


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def kernel_phase(eng, index):
    """Every tile through the CUDA kernel and through decode_pair_torch on
    the card: bit equality, times, and 200 lists against the host
    decoder. Returns the kernel's JSON entry (launches filled later)."""
    import torch

    from ds2i_torch.ops.pair_decode import decode_pair, decode_pair_torch
    from ds2i_torch.engine.tiles import F_NVALS

    s, dev, nt = eng.state, eng.device, eng.pad_tile
    groups, gids, _, _, _ = eng._order_groups(np.arange(nt), eng.tile_gid, eng.group_statics)
    ids_all = torch.from_numpy(gids.astype(np.int64)).to(dev)
    args = [
        (s.tiles_docs[ids_all[off:off + R]], s.tiles_freqs[ids_all[off:off + R]], st)
        for off, R, st in groups
    ]

    def run(fn):
        return [fn(s.docs_words, s.freqs_words, df, ff, st[1], st[2], st[3], eng.num_docs)
                for df, ff, st in args]

    got, ref = run(decode_pair), run(decode_pair_torch)
    # the docs-only form the engine's norm cache launches
    docs_only = [decode_pair(s.docs_words, None, df, None, st[1], st[2], st[3], eng.num_docs)[0]
                 for df, _, st in args]
    torch.cuda.synchronize()
    max_err = 0
    for (gd, gf), (rd, rf), gdo in zip(got, ref, docs_only):
        for a, b in ((gd, rd), (gf, rf), (gdo, rd)):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"kernel output {a.shape} {a.dtype} != plain {b.shape} {b.dtype}")
            max_err = max(max_err, int((a.long() - b.long()).abs().max()))
    if max_err != 0:
        raise AssertionError(f"CUDA pair decode differs from decode_pair_torch: max |err| {max_err}")
    ms = cuda_ms(lambda: run(decode_pair))
    plain_ms = cuda_ms(lambda: run(decode_pair_torch))
    dev_ms = device_only_ms(lambda: run(decode_pair))
    dev_plain_ms = device_only_ms(lambda: run(decode_pair_torch))
    shapes = ", ".join(f"{st[1:]}x{R}" for _, R, st in groups)
    log(f"kernel phase: {nt} tiles in {len(groups)} groups [(W, WL, T) x rows: {shapes}]")
    log(f"kernel phase: CUDA == plain bit for bit, both streams and docs only (max |err| "
        f"{max_err}); all tiles, both streams: kernel {ms:.4f} ms, plain PyTorch "
        f"{plain_ms:.4f} ms (median of 5)")
    log(f"kernel phase: device work alone (launches queued behind a spin): kernel "
        f"{fmt_ms(dev_ms)}, plain PyTorch {fmt_ms(dev_plain_ms)} (median of 5)")

    # 200 random lists against the host decoder
    tile_group = np.zeros(nt, np.int64)
    tile_row = np.zeros(nt, np.int64)
    for g, (off, R, _) in enumerate(groups):
        ids = gids[off:off + R]
        real = ids < nt
        tile_group[ids[real]] = g
        tile_row[ids[real]] = np.flatnonzero(real)
    host = [(d.cpu().numpy(), f.cpu().numpy()) for d, f in got]
    nvals = eng.tiles.docs[:, F_NVALS]
    rng = np.random.RandomState(0)
    lists = rng.choice(np.flatnonzero(eng.list_n > 0), size=min(200, int(np.sum(eng.list_n > 0))),
                       replace=False)
    for li in lists:
        tiles = range(int(eng.list_tile_start[li]), int(eng.list_tile_start[li + 1]))
        docs = np.concatenate([host[tile_group[t]][0][tile_row[t], :nvals[t]] for t in tiles])
        freqs = np.concatenate([host[tile_group[t]][1][tile_row[t], :nvals[t]] for t in tiles])
        hd, hf = index.decode_list(int(li))
        if not (np.array_equal(docs, hd) and np.array_equal(freqs, hf)):
            raise AssertionError(f"list {li}: CUDA decode differs from index.decode_list")
    log(f"kernel phase: {len(lists)} random lists equal index.decode_list")
    return {
        "name": "pair_decode",
        "route": "cuda",
        "source": "ds2i_torch/csrc/pair_decode.cu",
        "replaces": "ds2i_tpu/ops/pallas_decode.py:151",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }


def block_kernel_phase(eng, index):
    """Every tile of the split-mode index, both streams, through each
    block kernel and through block_stream_torch on the card: bit
    equality, both times per kernel, and 200 lists against the host
    decoder. Returns the two kernels' JSON entries (launches filled
    later)."""
    import torch

    from ds2i_torch.engine.tiles import F_NVALS
    from ds2i_torch.ops.block_decode import block_stream_torch, interp_decode, optpfor_decode

    s, dev, nt = eng.state, eng.device, eng.pad_tile
    calls = {optpfor_decode: [], interp_decode: []}  # wrapper -> [(fld, st, is_docs, ids)]
    for gid, stats, table, is_docs in (
        (eng.tile_gid_d, eng.group_statics_d, s.tiles_docs, True),
        (eng.tile_gid_f, eng.group_statics_f, s.tiles_freqs, False),
    ):
        groups, gids, _, _, _ = eng._order_groups(np.arange(nt), gid, stats)
        ids_all = torch.from_numpy(gids.astype(np.int64)).to(dev)
        for off, R, st in groups:
            wrapper = interp_decode if st[0] == "interp" else optpfor_decode
            calls[wrapper].append((table[ids_all[off:off + R]], st, is_docs, gids[off:off + R]))

    def run(fn, args):
        return [fn(s.docs_words, fld, st, eng.num_docs, is_docs) for fld, st, is_docs, _ in args]

    decoded = {True: np.zeros((nt, 128), np.int64), False: np.zeros((nt, 128), np.int64)}
    entries = []
    for wrapper, args in calls.items():
        got, ref = run(wrapper, args), run(block_stream_torch, args)
        torch.cuda.synchronize()
        max_err = 0
        for a, b, (_, st, is_docs, ids) in zip(got, ref, args):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{wrapper.__name__} output {a.shape} {a.dtype} != plain "
                                     f"{b.shape} {b.dtype}")
            max_err = max(max_err, int((a.long() - b.long()).abs().max()))
            real = ids < nt
            decoded[is_docs][ids[real], :st[-1]] = a.cpu().numpy()[real]
        if max_err != 0:
            raise AssertionError(f"{wrapper.__name__} differs from block_stream_torch: "
                                 f"max |err| {max_err}")
        ms = cuda_ms(lambda: run(wrapper, args))
        plain_ms = cuda_ms(lambda: run(block_stream_torch, args))
        dev_ms = device_only_ms(lambda: run(wrapper, args))
        dev_plain_ms = device_only_ms(lambda: run(block_stream_torch, args))
        rows = sum(int((ids < nt).sum()) for _, _, _, ids in args)
        shapes = ", ".join(f"{'d' if d else 'f'}{st[1:]}x{fld.shape[0]}" for fld, st, d, _ in args)
        log(f"block kernel phase: {wrapper.__name__}: {rows} tile rows of both streams in "
            f"{len(args)} groups [stream(statics) x rows: {shapes}]")
        log(f"block kernel phase: {wrapper.__name__}: CUDA == plain bit for bit (max |err| "
            f"{max_err}); kernel {ms:.4f} ms, plain PyTorch {plain_ms:.4f} ms (median of 5); "
            f"device work alone: kernel {fmt_ms(dev_ms)}, plain PyTorch {fmt_ms(dev_plain_ms)}")
        name = wrapper.__name__
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"ds2i_torch/csrc/{name}.cu",
            "replaces": {"optpfor_decode": "ds2i_tpu/ops/optpfor_device.py:78",
                         "interp_decode": "ds2i_tpu/ops/interp_device.py:71"}[name],
            "launches": None,
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain_ms,
        })

    nvals = eng.tiles.docs[:, F_NVALS]
    rng = np.random.RandomState(0)
    lists = rng.choice(np.flatnonzero(eng.list_n > 0), size=min(200, int(np.sum(eng.list_n > 0))),
                       replace=False)
    for li in lists:
        tiles = range(int(eng.list_tile_start[li]), int(eng.list_tile_start[li + 1]))
        docs = np.concatenate([decoded[True][t, :nvals[t]] for t in tiles])
        freqs = np.concatenate([decoded[False][t, :nvals[t]] for t in tiles])
        hd, hf = index.decode_list(int(li))
        if not (np.array_equal(docs, hd) and np.array_equal(freqs, hf)):
            raise AssertionError(f"list {li}: CUDA block decode differs from index.decode_list")
    log(f"block kernel phase: {len(lists)} random lists equal index.decode_list")
    return entries


def slice_phase(eng, queries, wrappers, tag):
    """A main path: prepare the whole log, 1 warmup + PASSES timed
    passes. Every wrapper's launch count must rise in the timed passes.
    Returns the last pass's results."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = eng.prepare(queries, k=10, ops=("and",))
    t1 = time.perf_counter()
    eng.execute(plan)  # warmup: builds the norm cache, uploads the plan
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ngroups = sum(len(p["groups"]) + len(p["groups_f"]) for p in plan["plans"])
    log(f"{tag} slice phase: prepare {t1 - t0:.2f} s ({len(plan['plans'])} parts, "
        f"{ngroups} decode groups); warmup pass {t2 - t1:.2f} s")
    times = []
    launches0 = [w.launches for w in wrappers]
    for _ in range(PASSES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.execute(plan)
        times.append(time.perf_counter() - t)
    timed = {w.__name__: w.launches - n0 for w, n0 in zip(wrappers, launches0)}
    for name, n in timed.items():
        if n <= 0:
            raise AssertionError(f"the timed passes never launched the CUDA {name}")
    us = [x / len(queries) * 1e6 for x in times]
    log(f"{tag} slice phase: exhaustive ranked_and top-10, {len(queries)} queries, {PASSES} "
        f"passes: median {statistics.median(us):.4f} us/query (min {min(us):.4f}, max "
        f"{max(us):.4f}); pass seconds {[round(x, 4) for x in times]}; launches in the timed "
        f"passes: {timed}")
    log(f"{tag} slice phase: resident state {eng.state.nbytes()} bytes; "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return res


def main_path(eng, queries, path_kernels, tag):
    """Drive one main path with every kernel's launch count set to 0 just
    before it; path_kernels is [(JSON entry, wrapper)] of the kernels the
    path must launch, and each entry takes its count read just after."""
    from ds2i_torch.ops import block_decode, pair_decode

    all_wrappers = (pair_decode.decode_pair, block_decode.optpfor_decode,
                    block_decode.interp_decode)
    for w in all_wrappers:
        w.launches = 0
    res = slice_phase(eng, queries, [w for _, w in path_kernels], tag)
    log(f"{tag} slice phase: launches over the main path: "
        f"{ {w.__name__: w.launches for w in all_wrappers} }")
    for entry, w in path_kernels:
        entry["launches"] = w.launches
        if w.launches <= 0:
            raise AssertionError(f"the {tag} main path never launched the CUDA {entry['name']}")
    check_results(res, len(queries))


def check_results(res, n):
    """Every answer: at most 10 finite scores, in descending order."""
    if len(res) != n:
        raise AssertionError(f"{len(res)} results for {n} queries")
    for qi, r in enumerate(res):
        s = np.asarray(r[3])
        fin = s[np.isfinite(s)]
        if s.shape != (10,) or np.any(np.isnan(s)) or np.any(np.diff(fin) > 0):
            raise AssertionError(f"query {qi}: malformed top-10 row {s}")


def oracle_phase(eng, index, wdata, queries, n, tag):
    from ds2i_torch.host import and_query, or_query, ranked_and_query, ranked_or_query

    qs = queries[:n]
    t0 = time.perf_counter()
    got = {
        "and_counts": eng.and_counts(qs), "or_counts": eng.or_counts(qs),
        "ranked_and": eng.ranked_and(qs, k=10), "ranked_or": eng.ranked_or(qs, k=10),
    }
    for i, q in enumerate(qs):
        if got["and_counts"][i] != and_query(index, q) or got["or_counts"][i] != or_query(index, q):
            raise AssertionError(f"{tag} query {i} {q}: counts differ from the oracle")
        for op, fn in (("ranked_and", ranked_and_query), ("ranked_or", ranked_or_query)):
            exp = fn(index, wdata, q, k=10)
            g = got[op][i]
            if len(g) != len(exp) or (exp and not np.allclose(g, exp, rtol=RTOL, atol=0)):
                raise AssertionError(f"{tag} query {i} {q}: {op} {g} != oracle {exp}")
    log(f"{tag} oracle phase: {len(qs)} queries: and/or counts exact, ranked_and/ranked_or "
        f"within rtol {RTOL} ({time.perf_counter() - t0:.1f} s)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from ds2i_torch import kernels
    from ds2i_torch.ops import block_decode, pair_decode

    t0 = time.perf_counter()
    for name in kernels.ENTRY_POINTS:
        kernels.lib(name)
    log(f"kernel build ({len(kernels.ENTRY_POINTS)} sources, one nvcc each, in parallel) "
        f"and load: {time.perf_counter() - t0:.1f} s")

    coll, wdata, queries = load_collection()

    # opt path: pair mode
    index = build_index(coll, "opt")
    eng = start_engine(index, wdata)
    pair_entry = kernel_phase(eng, index)
    main_path(eng, queries, [(pair_entry, pair_decode.decode_pair)], "opt")
    oracle_phase(eng, index, wdata, queries, ORACLE_QUERIES, "opt")
    del eng

    # block_optpfor path: split mode
    index = build_index(coll, "block_optpfor")
    eng = start_engine(index, wdata)
    block_entries = block_kernel_phase(eng, index)
    main_path(eng, queries, [(e, getattr(block_decode, e["name"])) for e in block_entries],
              "block_optpfor")
    oracle_phase(eng, index, wdata, queries, ORACLE_QUERIES, "block_optpfor")
    del eng

    # block_interpolative: oracle only
    index = build_index(coll, "block_interpolative")
    eng = start_engine(index, wdata)
    n0 = block_decode.interp_decode.launches
    oracle_phase(eng, index, wdata, queries, INTERP_ORACLE_QUERIES, "block_interpolative")
    if block_decode.interp_decode.launches <= n0:
        raise AssertionError("the block_interpolative run never launched the CUDA interp_decode")
    del eng

    print(json.dumps({"kernels": [pair_entry, *block_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
