#!/usr/bin/env python3
"""Smoke run of the ds2i_torch port on one CUDA card.

Drives the port's main paths once at bench.py's default scale: top-10
BM25 ranked_and over the deterministic 10k-doc / 2M-posting collection
with its 35k-query log, first over a partitioned Elias-Fano (`opt`)
index in pair mode, then over a `block_optpfor` index in split mode
(bench.py's default index type), exhaustive and then block-max pruned
(bench.py's default op, and_skip), then over the other block codecs:
`block_varint`, `block_qmx` and `block_mixed`; block_optpfor past its
resident word limit, the exceptions decoded in the pass (K1s); then the
WSDM'15 tool chain beside the front door: the command-line tools,
doc-range shards, make_engine, replicas and cache_dir.

  1. card name and power limit (nvidia-smi), torch and CUDA versions
  2. build the CUDA kernels from csrc/ (one nvcc per source, all at
     once), print the build seconds
  3. generate (or reuse) the collection and its WandData
  opt path (pair mode, kernel pair_decode: one launch a part, both
  streams, through the wrapper ops/pair_decode.py:decode_pair):
  4. kernel phase: every tile as one part (ResidentEngine.all_tiles_part);
     the norm cache's one docs-mode launch; the launch in each mode
     (docs, presence, BM25 weights) against decode_pair_launch_torch on
     the card and the whole part against pair_decode_part_torch, bit for
     bit; 200 random lists against the host decoder; the BM25 launch
     timed (CUDA events, median of 5) through the wrapper, alone (queued
     behind a spin) and plain, beside its bound by bytes (pair_bytes: the
     fused work, each row's map entry, the fields it reads, the window
     and low-bit words it spans, the den of its valid slots, docs32 and
     w32 written)
  5. slice phase: ResidentEngine(device="cuda"), prepare the full query
     log, 1 warmup + 9 timed passes of execute; us/query and the
     kernels' launch counts over the run (every count set to 0 just
     before it; at most one pair_decode launch a part); then the decode
     stage of one pass alone, host clock
  6. part phase: every part of the slice's plan against
     pair_decode_part_torch, bit for bit; one pass's launches timed
     through the wrapper and alone, beside their bound
  7. oracle phase: the first 300 queries against the numpy oracle
     (counts exact, top-10 scores within rtol 1e-3); then
     ranked_and(prune=True) against the exhaustive ranked_and on them
     (pair mode's block-max decode pass and probe); then that engine's
     and_counts, or_counts, ranked_and and ranked_or over the whole log,
     kept for the next phase
  7b. generations phase (generations_phase; every count set to 0 just
     before it): the JAX package's earlier engine generations, each over
     a DeviceIndex on the card. K9 (`decode_rows`, csrc/segment_decode.cu)
     over every docs and every freqs segment of the 1x `opt` and `ef`
     indexes, one launch each, against decode_rows_torch bit for bit (the
     plain version a call a bucket of pow4 window words), 200 random lists
     of each through DeviceIndex against the host decoder, the `opt` docs
     call timed through the wrapper, alone and plain beside its bound by
     bytes (segment_bytes); K6g (`decode_group`, csrc/tile_decode.cu) on
     every group of the `opt` tile layout over every list, both streams,
     against _decode_stream on the n_vals slots, timed the same way
     (tile_group_bytes). Then the path, its counts set to 0 again:
     QueryEngine, FlatQueryEngine and TileQueryEngine over the whole log
     on `opt`, counts equal to the exhaustive ResidentEngine's and top-10
     within rtol 1e-3, query by query, with each op's seconds and
     us/query and the launches of K9 and K6g; the same three over `ef`
     against the oracle on 300 queries; then make_sharded_plane_step on a
     (1, 1) mesh of cuda:0 and a (2, 2) grid of cuda:0 against the port's
     CPU mesh on a seeded batch
  block_optpfor path (split mode, kernels optpfor_decode and
  interp_decode, one launch per kernel and stream of a part; block_path):
  the kernel phase over every tile (each kernel's launches in every mode
  against its plain version, the whole all-tiles part against
  split_decode_part_torch, 200 lists against the host decoder; each
  kernel timed beside its bound), the slice phase (launches a pass: at
  most 2 a part per kernel), the part phase (every part of the slice's
  plan against the plain version; each kernel's launches of one pass
  timed; for a kernel first timed on the path, the chain line: the same
  launches cut to their first CTA, timed alone) and the oracle phase
  block_optpfor and_skip path (bench.py's default: block-max pruned
  ranked_and; kernels blockmax, optpfor_decode and interp_decode):
  8. every count set to 0, then build_blockmax over the collection
     (blockmax in planes form), prepare(prune=True, ops=("and",)) with
     its probe on the card (the plan's counts), 1 warmup + 9
     timed passes; the directory entries kept against the exhaustive
     plan's; the whole query log against the exhaustive pass, query by
     query (equal lengths, rtol 1e-3, no mismatch); _ensure_blockmax on a
     second engine (every tile decoded, rows form), every pruning table
     byte-equal to build_blockmax's; wand and maxscore against ranked_or
     on 2,000 queries
  9. blockmax phase: the kernel against blockmax_rows_torch bit for bit
     in both forms over every block, timed through the wrapper, alone
     and plain, beside its bound by bytes
  9b. block_optpfor past its resident word limit (inpass_path: the
     engine's RESIDENT_WORD_LIMIT lowered for that engine only, so no
     "optp" group remains and the groups with exceptions stay "opt",
     kernel optpfor_s16_decode, K1s): a block path (the kernel phase,
     K1s in every mode against its plain version and timed beside its
     bound: slot words, Simple16 words, fields, what it writes; the
     replicated line: the rows with exceptions repeated 16 times, each
     copy over its own inputs, one launch a stream past one wave,
     bit-equal to its plain version and timed alone beside its bound; the
     exhaustive main path, counts set to 0 just before it, K1s launched;
     the part phase with K1s's chain line; the oracle); every row with
     exceptions against the patched engine's K1 bit for bit; its and_skip
     path; the full log, exhaustive and and_skip, equal to the patched
     engine's query by query; µs/query of both engines in turns
  10. block_interpolative: a smaller oracle-only run (100 queries)
  11. block_varint (kernels varint_decode and interp_decode), block_qmx
     (qmx_decode and interp_decode) and block_mixed (rebuild_mixed over
     the block_optpfor index, each stream's codec drawn from a seed:
     optpfor_decode with exception patches, varint_decode,
     interp_decode): each a block path as above (a kernel first met here
     timed) and its and_skip path; on block_qmx and block_mixed with the
     second engine's decode pass
  12. the WSDM'15 tool chain (wsdm_phase), each tool in its own process:
     profile_queries and profile_decoding --engine resident on the card
     (its stats line shows K1s launched), dec_time_regression on the
     device profile, optimal_hybrid_index --check under block_optpfor's
     bytes (beside it, step 12b); the hybrid it built served on the card,
     equal to block_optpfor on the whole log
  12b. the front door (front_door_phase, at the same 1x collection; every
     count set to 0 just before it and read just after, into each JSON
     entry's front_door_launches): the quick-start tools, each in its own
     process as a user runs them (create_freq_index --check for opt and
     block_optpfor and create_wand_data at once; then queries over
     their files at once: block_optpfor's and, ranked_and, wand and
     maxscore and opt's ranked_and on the resident engine on the card,
     block_optpfor's ranked_and on the native CPU cursors), each exiting
     0 with its stats lines; the files loaded back (tools.common), the
     index byte-equal to the in-process one and an engine over it equal
     on every query; DocShardedEngine.from_collection (4 shards of
     block_optpfor on the card) against the single engine on every
     query (counts exact; ranked_and, ranked_or, and_skip, wand and
     maxscore within rtol 1e-3 of the exhaustive ops), each shard's
     parts and launches a pass and µs/query beside the single engine's;
     make_engine (a ResidentEngine under the limit it computes from the
     card's memory, a DocShardedEngine under a third of the index's
     bytes, equal results); ResidentEngine(devices=[cuda, cuda]) with
     parts round-robin, equal results; cache_dir over block_optpfor and
     the loaded opt index: a cold engine builds and saves, a second
     loads, both set-ups timed, the second launching K5 and the decode
     no time before its first pass and equal on and_skip
  13. the script's wall time, the kernels' JSON line, then {"ok": true,
     "device": {...}} last
  Every main path (each slice phase above, exhaustive and and_skip) also
  launches K3, the join and pack (join_part, csrc/join.cu: one launch a
  part), and ends in a join phase: every part of the path's
  plan through join_part against join_part_torch on the card, bit for
  bit; the kernel's work split over the plan (rows on a warp and on CTA
  items, rows with an empty slot, driving against all entries, AND
  candidates counted on the card, merged rows); and one pass of the join
  timed through the wrapper, alone and plain, beside its bound by bytes
  (join_bytes); the block_optpfor exhaustive path's numbers go into K3's
  JSON entry.

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
OR_PRUNE_QUERIES = 2000
INTERP_ORACLE_QUERIES = 100
RTOL = 1e-3  # the reference's ranked-test tolerance (test_ranked_queries.cpp:52)
FRONT_DOOR_SHARDS = 4
TOOL_TIMEOUT_S = 600
PASSES = 9
REPLICAS = 16  # copies of the rows with exceptions in K1s's replicated line
# the least time for a kernel's work: the bytes it must move over the H100
# SXM's 3.35 TB/s of device memory (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12


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


def collection_base():
    """The basename of the generated collection's files."""
    return os.path.join(CACHE, f"coll_{NUM_DOCS}_{POSTINGS}_{NUM_QUERIES}")


def load_collection():
    from ds2i_torch.host import (
        BinaryFreqCollection, WandData, generate_collection, read_queries, read_sizes,
    )

    os.makedirs(CACHE, exist_ok=True)
    base = collection_base()
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


def build_mixed_index(index):
    """block_mixed over the block_optpfor `index` (ds2i_torch's
    rebuild_mixed, each stream's codec drawn by mixed_choices: the
    reference picks it by predicted decode time, from a predictors file
    this repository does not have)."""
    from ds2i_torch.host import mixed_choices, rebuild_mixed

    t0 = time.perf_counter()
    mixed = rebuild_mixed(index, *mixed_choices(index))
    log(f"block_mixed index (rebuild_mixed over block_optpfor): {mixed.size()} lists "
        f"({time.perf_counter() - t0:.1f} s)")
    return mixed


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


def bound(nbytes):
    """(bound_ms, bound_by) of work that must move nbytes. No least count
    of the integer operations these decodes need is derived (a count
    taken from a kernel's own source is that kernel's cost, not the
    function's), so the bound is by bytes alone."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def pair_bytes(eng, launch, gtile_host, mode):
    """The bytes one pair_decode launch must move on this run's data, each
    input read once and each output written once: every row's map entry;
    a pad row's n_vals; per real row and decoded stream (docs, and freqs
    for "bm25"), the 10 field words its decode reads (all but F_PREV_CUM
    for docs, all but F_NVALS for freqs), the high-bits window words its
    F_WIN_LEN bits span (EF, strict EF and ranked-bitvector segments) and
    the words its n_vals * l low bits span (EF and strict EF); for "bm25"
    its tile_gblk0 entry and the den of each valid slot; each output block
    written (docs32, and w32 in the weighted modes)."""
    from ds2i_torch.engine.tiles import (
        F_KIND, F_LB_BITOFF, F_LOWER_BITS, F_NVALS, F_WIN_BITOFF, F_WIN_LEN,
    )
    from ds2i_torch.ops.segments import SEG_EF, SEG_EF_STRICT, SEG_RB

    h = launch.host.astype(np.int64)
    if not len(h):
        return 0
    nrows = h[:, 4]
    rows = np.repeat(h[:, 3] - (np.cumsum(nrows) - nrows), nrows) + np.arange(int(nrows.sum()))
    T = np.repeat(h[:, 2], nrows)
    ids = gtile_host[rows].astype(np.int64)
    r = ids[ids < eng.pad_tile]
    outputs = 1 if mode == "docs" else 2
    nbytes = 8 * len(ids) + 4 * (len(ids) - len(r)) + 4 * outputs * int(T.sum())
    n = eng.tiles.docs[r, F_NVALS].astype(np.int64)
    if mode == "bm25":
        nbytes += 8 * len(r) + 4 * int(n.sum())
    for table in (eng.tiles.docs, eng.tiles.freqs)[:2 if mode == "bm25" else 1]:
        f = table[r].astype(np.int64)
        high = np.isin(f[:, F_KIND], (SEG_EF, SEG_EF_STRICT, SEG_RB)) & (f[:, F_WIN_LEN] > 0)
        hw = np.where(high, (f[:, F_WIN_BITOFF] + f[:, F_WIN_LEN] + 31) // 32, 0)
        lbits = n * f[:, F_LOWER_BITS]
        low = np.isin(f[:, F_KIND], (SEG_EF, SEG_EF_STRICT)) & (lbits > 0)
        lw = np.where(low, (f[:, F_LB_BITOFF] + lbits + 31) // 32, 0)
        nbytes += 4 * (10 * len(r) + int(hw.sum()) + int(lw.sum()))
    return nbytes


def _same_bits(a, b):
    """Equal shapes and dtypes, and equal bits (so -0.0 != +0.0 and NaNs
    compare by payload)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def kernel_phase(eng, index):
    """Every tile of the EF-family index as one part
    (ResidentEngine.all_tiles_part): the norm cache's one docs-mode
    launch; pair_decode's launch in each mode (docs, presence, BM25)
    through the wrapper against decode_pair_launch_torch on the card, bit
    for bit; the whole part through pair_decode_part against
    pair_decode_part_torch; 200 lists against the host decoder (docids,
    and BM25 weights against f / (f + den) of the host's freqs); the BM25
    launch timed through the wrapper, alone and plain, beside its bound.
    Returns the kernel's JSON entry (launches filled later)."""
    import torch

    from ds2i_torch.engine.tiles import F_NVALS
    from ds2i_torch.ops.pair_decode import (
        decode_pair, decode_pair_launch_torch, pair_decode_part, pair_decode_part_torch,
    )

    n0 = decode_pair.launches
    eng._ensure_norm_cache()
    if decode_pair.launches - n0 != 1:
        raise AssertionError(f"the norm cache launched pair_decode {decode_pair.launches - n0} "
                             f"times, not once")
    s, dev, nd = eng.state, eng.device, eng.num_docs
    part = eng.all_tiles_part()
    gt, lay = part.gtile_ids, part.layout
    launch = lay.launch("pair", True, dev)
    largs = (s.docs_words, s.freqs_words, s.tiles_docs, s.tiles_freqs, gt)

    def run(fn, mode, out, w):
        return fn(launch, *largs, mode, nd, out, w, s.den_blocks, s.tile_gblk0)

    max_err = 0.0
    for mode in ("docs", "presence", "bm25"):
        res = []
        for fn in (decode_pair, decode_pair_launch_torch):
            out = torch.full((lay.nb_d, 32), -7, dtype=torch.int32, device=dev)
            w = torch.full((lay.nb_d, 32), -7.0, device=dev)
            res.append(run(fn, mode, out, w))
        torch.cuda.synchronize()
        (go, gw), (po, pw) = res
        max_err = max(max_err, float((go.long() - po.long()).abs().max()),
                      float((gw - pw).abs().max()))
        if not (_same_bits(go, po) and _same_bits(gw, pw)):
            raise AssertionError(f"pair_decode ({mode}) differs from decode_pair_launch_torch: "
                                 f"max |err| {max_err}")
        if mode == "bm25":
            docs_h, w_h = go.cpu().numpy(), gw.cpu().numpy()
    rows_p = 1 << max(lay.nb_d - 1, 0).bit_length()
    pargs = (*largs, lay, nd, "bm25", s.den_blocks, s.tile_gblk0, rows_p)
    (gd, gw), (pd, pw) = pair_decode_part(*pargs), pair_decode_part_torch(*pargs)
    torch.cuda.synchronize()
    if not (_same_bits(gd, pd) and _same_bits(gw, pw)):
        raise AssertionError("pair_decode_part differs from pair_decode_part_torch over every tile")
    log(f"kernel phase: {eng.pad_tile} tiles in {len(lay.groups)} groups, one launch "
        f"({launch.n_cta} CTAs, {lay.nb_d} blocks) [(W, WL, T) x rows: "
        f"{', '.join(f'{st[1:]}x{R}' for _, R, st in lay.groups)}]; norm cache: 1 launch")
    log(f"kernel phase: CUDA == plain bit for bit in modes docs, presence and BM25 (max |err| "
        f"{max_err}), and pair_decode_part == pair_decode_part_torch over every tile")

    # 200 random lists against the host decoder
    nvals = eng.tiles.docs[:, F_NVALS]
    den_h = s.den_blocks.cpu().numpy()
    g0 = s.tile_gblk0.cpu().numpy()
    rng = np.random.RandomState(0)
    lists = rng.choice(np.flatnonzero(eng.list_n > 0), size=min(200, int(np.sum(eng.list_n > 0))),
                       replace=False)
    for li in lists:
        tiles = range(int(eng.list_tile_start[li]), int(eng.list_tile_start[li + 1]))
        at = lambda a, t, b0: a[b0:][:4].reshape(-1)[:nvals[t]]  # noqa: E731
        docs = np.concatenate([at(docs_h, t, part.tblk[t]) for t in tiles])
        w = np.concatenate([at(w_h, t, part.tblk[t]) for t in tiles])
        den = np.concatenate([at(den_h, t, g0[t]) for t in tiles])
        hd, hf = index.decode_list(int(li))
        f = np.asarray(hf, dtype=np.float32)
        if not (np.array_equal(docs, hd)
                and np.array_equal(w.view(np.uint32), (f / (f + den)).view(np.uint32))):
            raise AssertionError(f"list {li}: CUDA decode differs from index.decode_list")
    log(f"kernel phase: {len(lists)} random lists: docids equal index.decode_list, BM25 weights "
        f"equal f / (f + den) of its freqs bit for bit")

    out = torch.empty((lay.nb_d, 32), dtype=torch.int32, device=dev)
    w = torch.empty((lay.nb_d, 32), dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: run(decode_pair, "bm25", out, w))
    dev_ms = device_only_ms(lambda: run(decode_pair, "bm25", out, w))
    plain_ms = cuda_ms(lambda: run(decode_pair_launch_torch, "bm25", out, w))
    nbytes = pair_bytes(eng, launch, gt.cpu().numpy(), "bm25")
    bound_ms, bound_by = bound(nbytes)
    log(f"kernel phase: the BM25 launch over every tile: kernel {ms:.4f} ms through the wrapper, "
        f"{fmt_ms(dev_ms)} alone, plain PyTorch {plain_ms:.4f} ms (median of 5); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes} bytes)")
    return {
        "name": "pair_decode",
        "route": "cuda",
        "source": "ds2i_torch/csrc/pair_decode.cu",
        "replaces": "ds2i_tpu/ops/pallas_decode.py:151",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call decodes Elias-Fano
    }


def pair_part_phase(eng, plan):
    """Over every part of the `opt` slice's plan: pair_decode_part on the
    card against pair_decode_part_torch, bit for bit; then one ranked
    pass's launches (one a part), timed through the wrapper and alone,
    beside their bound."""
    import torch

    from ds2i_torch.ops.pair_decode import decode_pair, pair_decode_part, pair_decode_part_torch

    s, dev, nd = eng.state, eng.device, eng.num_docs
    parts = []
    for p in plan["plans"]:
        gt = p["_dev"][dev][0]
        lay = p["layout"]
        rows = 1 << max(lay.nb_d - 1, 0).bit_length()
        args = (s.docs_words, s.freqs_words, s.tiles_docs, s.tiles_freqs, gt, lay, nd, "bm25",
                s.den_blocks, s.tile_gblk0, rows)
        (gd, gw), (pd, pw) = pair_decode_part(*args), pair_decode_part_torch(*args)
        torch.cuda.synchronize()
        if not (_same_bits(gd, pd) and _same_bits(gw, pw)):
            raise AssertionError("pair_decode_part differs from pair_decode_part_torch on a part "
                                 "of the slice's plan")
        parts.append((p, gt, lay.launch("pair", True, dev), gd, gw))
    log(f"opt part phase: pair_decode_part == pair_decode_part_torch on all {len(parts)} parts "
        f"of the slice's plan, docs32 and w32 bit for bit")

    def run():
        for _, gt, launch, docs, w in parts:
            decode_pair(launch, s.docs_words, s.freqs_words, s.tiles_docs, s.tiles_freqs, gt,
                        "bm25", nd, docs, w, s.den_blocks, s.tile_gblk0)

    ms = cuda_ms(run)
    dev_ms = device_only_ms(run)
    nbytes = sum(pair_bytes(eng, launch, np.asarray(p["gtile_ids"]), "bm25")
                 for p, _, launch, _, _ in parts)
    bound_ms, bound_by = bound(nbytes)
    log(f"opt part phase: pair_decode: one ranked pass, {len(parts)} launches "
        f"({sum(x[2].n_cta for x in parts)} CTAs): {ms:.4f} ms through the wrapper, "
        f"{fmt_ms(dev_ms)} alone (median of 5); bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes)")


def _interp_order(n):
    """(h, lo, hi) of the n - 1 codes of an n-value interpolative row: code
    h has bounds cum[lo - 1] (0 for lo = 0) and cum[hi]
    (codecs/interpolative.py: BitWriter32.write_interpolative)."""
    out, stack = [], [(0, n - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi > lo:
            h = lo + (hi - lo) // 2
            out.append((h, lo, hi))
            stack += [(h + 1, hi), (lo, h)]
    return np.array(out, dtype=np.int64).reshape(-1, 3).T


def interp_code_words(eng, part, docs32, freq32):
    """{True: docs, False: freqs}: each tile's interpolative code span in
    words, per stream (0 for other tiles and for rows of at most one value):
    ceil((BF_BOFF + code bits) / 32), the code bits counted from the
    decoded values as the encoder writes them (a value x in [0, u) takes
    b = msb(u) bits, b + 1 where x >= 2^(b+1) - u). Each row's count must
    fit the W words of its group's window."""
    from ds2i_torch.engine.block_tiles import BF_BOFF
    from ds2i_torch.engine.tiles import F_BASE, F_NVALS

    nvals = eng.tiles.docs[:, F_NVALS].astype(np.int64)
    out = {}
    for fields, gid, statics, vals, tblk, is_docs in (
            (eng.tiles.docs, eng.tile_gid_d, eng.group_statics_d, docs32, part.tblk, True),
            (eng.tiles.freqs, eng.tile_gid_f, eng.group_statics_f, freq32, part.tblk_f, False)):
        win = np.array([st[1] if st[0] == "interp" else 0 for st in statics], np.int64)[gid]
        words = np.zeros(eng.pad_tile + 1, np.int64)
        flat = vals.reshape(-1).astype(np.int64)
        for n in np.unique(nvals[win > 0]):
            if n <= 1:
                continue
            rows = np.flatnonzero((win > 0) & (nvals == n))
            v = flat[tblk[rows, None] * 32 + np.arange(n)]
            if is_docs:
                cum = v - fields[rows, F_BASE, None].astype(np.int64) - np.arange(n)
            else:
                cum = np.cumsum(v - 1, axis=1)
            cz = np.concatenate([np.zeros((len(rows), 1), np.int64), cum], axis=1)
            h, lo, hi = _interp_order(int(n))
            low, high, val = cz[:, lo], cz[:, hi + 1], cz[:, h + 1]
            u = high - low + 1
            b = np.frexp(u.astype(np.float64))[1].astype(np.int64) - 1
            bits = (b + (val - low >= (1 << (b + 1)) - u)).sum(axis=1)
            span = (fields[rows, BF_BOFF].astype(np.int64) + bits + 31) // 32
            words[rows] = np.where(bits > 0, span, 0)
        if np.any(words[:-1] > win):
            raise AssertionError("an interpolative row's code spans more words than its window")
        out[is_docs] = words
    return out


def s16_code_words(eng):
    """{("s16", True): docs, ("s16", False): freqs}: each tile's Simple16
    exception stream in words, per stream (0 for rows without
    exceptions): the words its 2 n_ex values take, walked from the index
    bytes as the tile walk walks them, and one more where BF_EX_BOFF
    splits them (the function needs no value past 2 n_ex: positions
    and highs of exceptions e < n_ex lie below it)."""
    from ds2i_torch.engine.block_tiles import (
        BF_EX_BOFF, BF_EX_W0, BF_NEX, KIND_OPT, _s16_words,
    )
    from ds2i_torch.engine.tiles import F_KIND

    data = np.asarray(eng.index.lists, dtype=np.uint8)
    data = np.concatenate([data, np.zeros(8, np.uint8)])
    out = {}
    for is_docs, fields in ((True, eng.tiles.docs), (False, eng.tiles.freqs)):
        f = fields.astype(np.int64)
        words = np.zeros(eng.pad_tile + 1, np.int64)
        for t in np.flatnonzero((f[:, F_KIND] == KIND_OPT) & (f[:, BF_NEX] > 0)):
            pos = 4 * int(f[t, BF_EX_W0]) + int(f[t, BF_EX_BOFF]) // 8
            words[t] = _s16_words(data, pos, 2 * int(f[t, BF_NEX])) + (f[t, BF_EX_BOFF] > 0)
        out["s16", is_docs] = words
    return out


def qmx_payload_bytes(eng, rows, fields, NI, S):
    """Per QMX row (fields of the rows' stream), the payload bytes its
    decode reads: ADV_OF_TYPE of each of its first min(ninst, NI)
    instances, their types from its first min(nsel, S) selectors (read
    from the index bytes, walking back from its last byte); and the
    distinct types of those instances."""
    from ds2i_torch.codecs.qmx import ADV_OF_TYPE
    from ds2i_torch.engine.block_tiles import BF_B, BF_EX_BOFF, BF_EX_W0, BF_NEX

    data = np.asarray(eng.index.lists, dtype=np.uint8)
    f = fields[rows]
    s = np.arange(S, dtype=np.int64)[None, :]
    pos = (4 * f[:, BF_EX_W0] + f[:, BF_EX_BOFF])[:, None] - s
    sel = data[np.clip(pos, 0, len(data) - 1)].astype(np.int64)
    valid = s < f[:, BF_NEX, None]
    batch = np.where(valid, 16 - (sel & 15), 0)
    types = np.minimum(np.where(valid, sel >> 4, 0), 14)
    adv = np.asarray(ADV_OF_TYPE, np.int64)[types]
    cum = np.cumsum(batch, axis=1)
    cap = np.minimum(f[:, BF_B], NI)[:, None]
    take = np.clip(np.minimum(cum, cap) - (cum - batch), 0, None)  # instances of each selector read
    return (take * adv).sum(axis=1), np.unique(types[take > 0])


def block_launch_bytes(eng, launch, gtile_host, mode, code_words):
    """The bytes one launch of a block kernel must move on this run's data,
    each input read once and each output written once: every row's map
    entry; a pad row's n_vals; a real row's fields the decode needs (K1:
    BF_W0, BF_BOFF, F_NVALS, with patches BF_NEX and BF_EX_BASE; K7:
    BF_W0, BF_B, BF_BOFF, F_NVALS; K8: BF_W0, BF_B, BF_NEX, BF_EX_W0,
    BF_BOFF, BF_EX_BOFF, F_NVALS; K2: BF_W0, BF_BOFF, F_NVALS and the sum;
    docs also F_BASE), its code (K1: the words of the 128 b-bit slots from
    BF_BOFF, and its min(n_ex, E) patch pairs; K7: 9 bytes a group; K8: its
    selector bytes and the payload bytes of its instances
    (qmx_payload_bytes); K2: code_words) and, for BM25 weights, its
    tile_gblk0 entry and the blkperm entry, freq and den of each valid
    slot's block and slot; for K8, once a launch, the lane-table words of
    the types its instances take (min(INTS_OF_TYPE, 128) lane entries and
    one meta word a type); each output block written (out, and w for
    weights). K1s (the exceptions decoded in the pass) reads BF_W0,
    BF_BOFF, F_NVALS, BF_B, BF_NEX, BF_EX_W0 and BF_EX_BOFF (docs also
    F_BASE), K1's slot words, and the Simple16 words of its exception
    stream (code_words[("s16", is_docs)], s16_code_words)."""
    from ds2i_torch.codecs.qmx import INTS_OF_TYPE
    from ds2i_torch.engine.block_tiles import BF_B, BF_BOFF, BF_NEX
    from ds2i_torch.engine.tiles import F_NVALS

    is_docs = mode != "freqs"
    fields = (eng.tiles.docs if is_docs else eng.tiles.freqs).astype(np.int64)
    nvals = eng.tiles.docs[:, F_NVALS].astype(np.int64)
    nt = eng.pad_tile
    nbytes, qmx_types = 0, set()
    for p1, p2, T, row0, n, _ in launch.host.tolist():
        ids = gtile_host[row0:row0 + n].astype(np.int64)
        r = ids[ids < nt]
        outputs = 2 if mode in ("presence", "bm25") else 1
        nbytes += 8 * n + 4 * (n - len(r)) + n * max(T // 32, 1) * 128 * outputs
        if mode == "bm25":
            nbytes += 8 * len(r) + 8 * int(((nvals[r] + 31) // 32).sum()) + 8 * int(nvals[r].sum())
        if launch.kernel == "optpfor":
            nf = 3 + (2 if p2 else 0) + (1 if is_docs else 0)
            bs = min(p1, 32)
            words = (fields[r, BF_BOFF] + 128 * bs + 31) // 32 if bs else np.zeros(len(r), np.int64)
            npatch = np.minimum(fields[r, BF_NEX], p2) if p2 else np.zeros(len(r), np.int64)
            nbytes += 4 * nf * len(r) + 4 * int(words.sum()) + 8 * int(npatch.sum())
        elif launch.kernel == "optpfor_s16":
            nf = 7 + (1 if is_docs else 0)
            bs = min(p1, 32)
            words = (fields[r, BF_BOFF] + 128 * bs + 31) // 32 if bs else np.zeros(len(r), np.int64)
            nbytes += (4 * nf * len(r) + 4 * int(words.sum())
                       + 4 * int(code_words[("s16", is_docs)][r].sum()))
        elif launch.kernel == "varint":
            nf = 4 + (1 if is_docs else 0)
            nbytes += 4 * nf * len(r) + 9 * int(np.minimum(fields[r, BF_B], p1).sum())
        elif launch.kernel == "qmx":
            nf = 7 + (1 if is_docs else 0)
            nsel = int(np.minimum(fields[r, BF_NEX], p2).sum())
            payload, types = qmx_payload_bytes(eng, r, fields, p1, p2)
            nbytes += 4 * nf * len(r) + nsel + int(payload.sum())
            qmx_types.update(types.tolist())
        else:
            nf = 4 + (1 if is_docs else 0)
            nbytes += 4 * nf * len(r) + 4 * int(code_words[is_docs][r].sum())
    return nbytes + 4 * sum(min(INTS_OF_TYPE[t], 128) + 1 for t in qmx_types)


def block_kernel_phase(eng, index, tag, timed):
    """Every tile of the split-mode index as one part
    (ResidentEngine.all_tiles_part): the whole part through
    split_decode_part against split_decode_part_torch, and 200 lists
    against the host decoder; then each block kernel's one launch per
    stream, in each mode the engine uses (freqs; docs with BM25 weights;
    docs alone, the norm cache's; docs with presence flags), through the
    wrapper and through decode_launch_torch on the card: bit equality;
    for the kernels in `timed`, both times per kernel (the freqs and the
    BM25 docs launch, as a ranked part runs them) and the bound, and for
    K1s the replicated line (replicated_line). Returns the JSON entries
    of the timed kernels the index launches (launches filled later) and
    each tile's interpolative code words (interp_code_words)."""
    import torch

    from ds2i_torch.engine.tiles import F_NVALS
    from ds2i_torch.ops.block_decode import (
        KERNELS, WRAPPERS, decode_launch_torch, split_decode_part, split_decode_part_torch,
    )

    eng._ensure_norm_cache()
    s, dev, nd = eng.state, eng.device, eng.num_docs
    part = eng.all_tiles_part()
    gt, gf, bp, lay = part[:4]
    host = {True: gt.cpu().numpy(), False: gf.cpu().numpy()}

    # the whole all-tiles part, ranked, as the engine runs it
    rows_p = 1 << max(lay.nb_d - 1, 0).bit_length()
    args = (s.docs_words, s.tiles_docs, s.tiles_freqs, gt, gf, bp, lay, nd, "bm25",
            s.den_blocks, s.tile_gblk0, rows_p)
    (gd, gw), (pd, pw) = split_decode_part(*args), split_decode_part_torch(*args)
    freq = torch.empty((lay.nb_f, 32), dtype=torch.int32, device=dev)
    for kernel in KERNELS:
        WRAPPERS[kernel](lay.launch(kernel, False, dev), s.docs_words, s.tiles_freqs, gf,
                         "freqs", nd, freq)
    torch.cuda.synchronize()
    if not (torch.equal(gd, pd) and torch.equal(gw, pw)):
        raise AssertionError("split_decode_part differs from split_decode_part_torch over every tile")
    log(f"{tag} kernel phase: split_decode_part over every tile ({lay.nb_d} docs blocks, "
        f"{lay.nb_f} freqs blocks) == split_decode_part_torch, docs32 and w32 bit for bit")

    # 200 random lists against the host decoder
    docs_h = gd.cpu().numpy()
    freq_h = freq.cpu().numpy()
    nvals = eng.tiles.docs[:, F_NVALS]
    rng = np.random.RandomState(0)
    lists = rng.choice(np.flatnonzero(eng.list_n > 0), size=min(200, int(np.sum(eng.list_n > 0))),
                       replace=False)
    for li in lists:
        tiles = range(int(eng.list_tile_start[li]), int(eng.list_tile_start[li + 1]))
        docs = np.concatenate([docs_h[part.tblk[t]:][:4].reshape(-1)[:nvals[t]] for t in tiles])
        freqs = np.concatenate([freq_h[part.tblk_f[t]:][:4].reshape(-1)[:nvals[t]]
                                for t in tiles])
        hd, hf = index.decode_list(int(li))
        if not (np.array_equal(docs, hd) and np.array_equal(freqs, hf)):
            raise AssertionError(f"list {li}: CUDA block decode differs from index.decode_list")
    log(f"{tag} kernel phase: {len(lists)} random lists equal index.decode_list")
    code_words = interp_code_words(eng, part, docs_h, freq_h)
    if any(lay.launch("optpfor_s16", d, dev).n_cta for d in (True, False)):
        code_words.update(s16_code_words(eng))

    docs_buf = torch.empty((lay.nb_d, 32), dtype=torch.int32, device=dev)
    w_buf = torch.empty((lay.nb_d, 32), dtype=torch.float32, device=dev)

    def launch_args(kernel, mode):
        is_docs = mode != "freqs"
        launch = lay.launch(kernel, is_docs, dev)
        table, gtile = (s.tiles_docs, gt) if is_docs else (s.tiles_freqs, gf)
        return launch, table, gtile

    entries = []
    for kernel in KERNELS:
        wrapper = WRAPPERS[kernel]
        if not any(lay.launch(kernel, d, dev).n_cta for d in (True, False)):
            continue
        max_err = 0.0
        for mode in ("freqs", "bm25", "docs", "presence"):
            launch, table, gtile = launch_args(kernel, mode)
            nb = lay.nb_d if mode != "freqs" else lay.nb_f
            res = []
            for fn in (wrapper, decode_launch_torch):
                out = torch.full((nb, 32), -7, dtype=torch.int32, device=dev)
                w = torch.full((nb, 32), -7.0, device=dev) if mode in ("bm25", "presence") else None
                fn(launch, s.docs_words, table, gtile, mode, nd, out, w, freq, bp,
                   s.den_blocks, s.tile_gblk0)
                res.append((out, w))
            torch.cuda.synchronize()
            (go, gw), (po, pw) = res
            max_err = max(max_err, float((go.long() - po.long()).abs().max()))
            same = _same_bits(go, po)
            if gw is not None:
                max_err = max(max_err, float((gw - pw).abs().max()))
                same = same and _same_bits(gw, pw)
            if not same:
                raise AssertionError(f"{wrapper.__name__} ({mode}) differs from "
                                     f"decode_launch_torch: max |err| {max_err}")
        rows = sum(int(lay.launch(kernel, d, dev).host[:, 4].sum()) for d in (True, False))
        ctas = [lay.launch(kernel, d, dev).n_cta for d in (True, False)]
        log(f"{tag} kernel phase: {wrapper.__name__}: one launch per stream over every tile "
            f"({rows} rows of both streams, {ctas[0]} + {ctas[1]} CTAs), modes freqs, docs+BM25 "
            f"weights, docs alone and docs+presence: CUDA == plain bit for bit (max |err| "
            f"{max_err})")
        if kernel not in timed:
            continue

        def run(fn):
            for mode in ("freqs", "bm25"):
                launch, table, gtile = launch_args(kernel, mode)
                out = freq if mode == "freqs" else docs_buf
                fn(launch, s.docs_words, table, gtile, mode, nd, out,
                   None if mode == "freqs" else w_buf, freq, bp, s.den_blocks, s.tile_gblk0)

        ms = cuda_ms(lambda: run(wrapper))
        plain_ms = cuda_ms(lambda: run(decode_launch_torch))
        dev_ms = device_only_ms(lambda: run(wrapper))
        nbytes = sum(block_launch_bytes(eng, launch_args(kernel, mode)[0], host[mode != "freqs"],
                                        mode, code_words) for mode in ("freqs", "bm25"))
        bound_ms, bound_by = bound(nbytes)
        log(f"{tag} kernel phase: {wrapper.__name__}: freqs + BM25 docs launches, every tile: "
            f"kernel {ms:.4f} ms through the wrapper, {fmt_ms(dev_ms)} alone, plain PyTorch "
            f"{plain_ms:.4f} ms (median of 5); bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes} bytes)")
        if kernel == "optpfor_s16":
            log(f"{tag} kernel phase: {wrapper.__name__}: rows with exceptions decoded in the "
                f"pass: {rows} of both streams")
            replicated_line(eng, lay, (gt, gf), bp, freq, code_words, tag)
        name = wrapper.__name__
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"ds2i_torch/csrc/{name}.cu",
            "replaces": {"optpfor_decode": "ds2i_tpu/ops/optpfor_device.py:78",
                         "optpfor_s16_decode": "ds2i_tpu/ops/optpfor_device.py:147",
                         "varint_decode": "ds2i_tpu/ops/varint_device.py:24",
                         "qmx_decode": "ds2i_tpu/ops/qmx_device.py:55",
                         "interp_decode": "ds2i_tpu/ops/interp_device.py:71"}[name],
            "launches": None,
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call decodes OptPFor, Varint-G8IU, QMX or
            # interpolative codes
            "library_ms": None,
        })
    return entries, code_words


def replicated_map(launch, gtile, fld, words, times, bm25=None):
    """`times` copies of a K1s launch's rows in one launch, each copy
    reading its own copy of every input, as the rows of an index `times`
    the size would: copy c's CTAs, rows and blocks after copy c - 1's;
    one field row a row (fld's row of its tile, BF_W0 and BF_EX_W0 moved
    into the c-th copy of the words); with bm25 = (freq, blkperm,
    den_blocks, tile_gblk0) of a docs launch, each block's freq row
    (blkperm's) and den row (tile_gblk0's) copied. Returns (Launch, its
    row-to-tile map, fields, words, freq, blkperm, den_blocks,
    tile_gblk0; the last four None without bm25) on gtile's device, and
    the launch's block of each block written (int64, on the host)."""
    import torch

    from ds2i_torch.engine.block_tiles import BF_EX_W0, BF_W0
    from ds2i_torch.ops.block_decode import Launch

    dev = gtile.device
    host = launch.host.astype(np.int64)
    if not (host[:, 2] == 128).all():
        raise ValueError("replicated_map takes a K1s launch (128 slots a row)")
    rows = np.concatenate([np.arange(r0, r0 + n) for r0, n in host[:, 3:5]])
    blocks = np.concatenate([np.arange(b0, b0 + 4 * n) for b0, n in host[:, [5, 4]]])
    tab = np.tile(host, (times, 1))
    size = np.tile(host[:, 4], times)
    tab[:, 3] = np.cumsum(size) - size
    tab[:, 5] = np.cumsum(4 * size) - 4 * size
    nw, nrow = len(words), len(rows)
    if max(tab.max(), times * nw) >= 2**31:
        raise ValueError("the replicated map's rows, blocks or words pass 2^31")
    tab = tab.astype(np.int32)
    tiles = torch.from_numpy(gtile.cpu().numpy()[rows]).to(dev)
    f = fld[tiles]
    fld_rep = f.repeat(times, 1)
    shift = torch.arange(times, dtype=torch.int32, device=dev).repeat_interleave(nrow) * nw
    fld_rep[:, BF_W0] += shift
    fld_rep[:, BF_EX_W0] += shift
    tail = (None,) * 4
    if bm25 is not None:
        freq, blkperm, den_blocks, tile_gblk0 = bm25
        blk = torch.from_numpy(blocks).to(dev)
        den_rows = (tile_gblk0[tiles][:, None] + torch.arange(4, device=dev)).reshape(-1)
        tail = (freq[blkperm[blk]].repeat(times, 1), torch.arange(times * len(blocks), device=dev),
                den_blocks[den_rows].repeat(times, 1), torch.arange(times * nrow, device=dev) * 4)
    return (Launch(launch.kernel, tab, torch.from_numpy(tab).to(dev)),
            torch.arange(times * nrow, device=dev), fld_rep, words.repeat(times), *tail), np.tile(
                blocks, times)


def replicated_line(eng, lay, gtiles, bp, freq, code_words, tag):
    """K1s over the all-tiles part's rows with exceptions repeated
    REPLICAS times, each copy over its own copy of the words, fields,
    freq and den rows (replicated_map), one launch a stream, as a pass
    over an index REPLICAS times the size launches it past one wave: the
    freqs and the BM25 docs launch (each docs block's freqs from the
    all-tiles freqs, blkperm of its block) through the wrapper against
    decode_launch_torch, bit for bit, then timed through the wrapper and
    alone beside their bound, REPLICAS times block_launch_bytes of the
    all-tiles launches (no byte read twice). gtiles: the part's (docs,
    freqs) row-to-tile maps."""
    import torch

    from ds2i_torch.ops.block_decode import decode_launch_torch, optpfor_s16_decode

    s, dev, nd = eng.state, eng.device, eng.num_docs
    runs, nbytes = [], 0
    for mode, is_docs in (("freqs", False), ("bm25", True)):
        base, gtile = lay.launch("optpfor_s16", is_docs, dev), gtiles[0 if is_docs else 1]
        nbytes += REPLICAS * block_launch_bytes(eng, base, gtile.cpu().numpy(), mode, code_words)
        (launch, *args), _ = replicated_map(
            base, gtile, s.tiles_docs if is_docs else s.tiles_freqs, s.docs_words, REPLICAS,
            (freq, bp, s.den_blocks, s.tile_gblk0) if is_docs else None)
        out = torch.empty((launch.end_blk, 32), dtype=torch.int32, device=dev)
        w = torch.empty((launch.end_blk, 32), dtype=torch.float32, device=dev) if is_docs else None
        runs.append((mode, launch, args, out, w))
    max_err = 0.0
    for mode, launch, (gtile, fld, words, fq, bpr, den, g0), out, w in runs:
        optpfor_s16_decode(launch, words, fld, gtile, mode, nd, out, w, fq, bpr, den, g0)
        po = torch.full_like(out, -7)
        pw = None if w is None else torch.full_like(w, -7.0)
        decode_launch_torch(launch, words, fld, gtile, mode, nd, po, pw, fq, bpr, den, g0)
        torch.cuda.synchronize()
        max_err = max(max_err, float((out.long() - po.long()).abs().max()))
        if w is not None:
            max_err = max(max_err, float((w - pw).abs().max()))
        if not (_same_bits(out, po) and (w is None or _same_bits(w, pw))):
            raise AssertionError(f"optpfor_s16_decode ({mode}) differs from decode_launch_torch "
                                 f"on the replicated map: max |err| {max_err}")

    def run():
        for mode, launch, (gtile, fld, words, fq, bpr, den, g0), out, w in runs:
            optpfor_s16_decode(launch, words, fld, gtile, mode, nd, out, w, fq, bpr, den, g0)

    ms = cuda_ms(run)
    dev_ms = device_only_ms(run)
    bound_ms, bound_by = bound(nbytes)
    rows = [int(launch.host[:, 4].sum()) for _, launch, *_ in runs]
    ctas = [launch.n_cta for _, launch, *_ in runs]
    log(f"{tag} kernel phase: optpfor_s16_decode replicated x{REPLICAS}, each copy over its own "
        f"inputs: {rows[1]} docs + {rows[0]} freqs rows ({ctas[1]} + {ctas[0]} CTAs), one launch "
        f"a stream, CUDA == plain bit for bit (max |err| {max_err}); {fmt_ms(dev_ms)} alone, "
        f"{ms:.4f} ms through the wrapper (median of 5); bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes)")


def part_kernel_phase(eng, plan, code_words, tag, chain=()):
    """Over every part of the slice's plan: split_decode_part on the card
    against split_decode_part_torch, bit for bit; then each block
    kernel's launches of one ranked pass (freqs and BM25 docs, every
    part), timed through the wrappers and alone, beside their bound. For
    the kernels in `chain` also the chain line: the same launches, each
    cut to its first CTA (a Launch of launch.host[:1]), timed alone; where
    one CTA takes most of a full launch's time, one row's latency (its
    dependent reads and the instructions between them), not the launch's
    bytes, sets the kernel's time."""
    import torch

    from ds2i_torch.ops.block_decode import (
        KERNELS, WRAPPERS, Launch, split_decode_part, split_decode_part_torch,
    )

    s, dev, nd = eng.state, eng.device, eng.num_docs
    parts = []
    for p in plan["plans"]:
        gt, gf, bp = p["_dev"][dev][:3]
        lay = p["layout"]
        rows = 1 << max(lay.nb_d - 1, 0).bit_length()
        args = (s.docs_words, s.tiles_docs, s.tiles_freqs, gt, gf, bp, lay, nd, "bm25",
                s.den_blocks, s.tile_gblk0, rows)
        (gd, gw), (pd, pw) = split_decode_part(*args), split_decode_part_torch(*args)
        torch.cuda.synchronize()
        if not (torch.equal(gd, pd) and torch.equal(gw, pw)):
            raise AssertionError("split_decode_part differs from split_decode_part_torch on a "
                                 "part of the slice's plan")
        freq = torch.empty((lay.nb_f, 32), dtype=torch.int32, device=dev)
        for kernel in KERNELS:
            launch = lay.launch(kernel, False, dev)
            if launch.n_cta:
                WRAPPERS[kernel](launch, s.docs_words, s.tiles_freqs, gf, "freqs", nd, freq)
        parts.append((p, gt, gf, bp, lay, freq, gd.clone(), gw.clone()))
    log(f"{tag} part phase: split_decode_part == split_decode_part_torch on all {len(parts)} "
        f"parts of the slice's plan, docs32 and w32 bit for bit")
    for kernel in KERNELS:
        wrapper = WRAPPERS[kernel]

        def run(first_cta=False):
            for _, gt, gf, bp, lay, freq, docs, w in parts:
                for mode in ("freqs", "bm25"):
                    is_docs = mode == "bm25"
                    launch = lay.launch(kernel, is_docs, dev)
                    if first_cta and launch.n_cta:
                        launch = Launch(kernel, launch.host[:1], launch.dev[:1])
                    if launch.n_cta:
                        wrapper(launch, s.docs_words, s.tiles_docs if is_docs else s.tiles_freqs,
                                gt if is_docs else gf, mode, nd, docs if is_docs else freq,
                                w if is_docs else None, freq, bp, s.den_blocks, s.tile_gblk0)

        n = sum(lay.launch(kernel, d, dev).n_cta > 0 for _, _, _, _, lay, _, _, _ in parts
                for d in (True, False))
        if n == 0:
            continue
        ms = cuda_ms(run)
        dev_ms = device_only_ms(run)
        nbytes = sum(block_launch_bytes(eng, lay.launch(kernel, mode == "bm25", dev),
                                        np.asarray(p[key]), mode, code_words)
                     for p, _, _, _, lay, _, _, _ in parts
                     for mode, key in (("freqs", "gtile_f"), ("bm25", "gtile_ids")))
        bound_ms, bound_by = bound(nbytes)
        log(f"{tag} part phase: {wrapper.__name__}: one ranked pass, {n} launches: {ms:.4f} ms "
            f"through the wrapper, {fmt_ms(dev_ms)} alone (median of 5); bound {bound_ms:.4f} ms "
            f"by {bound_by} ({nbytes} bytes)")
        if kernel in chain:
            cta_ms = device_only_ms(lambda: run(first_cta=True))
            ctas = [lay.launch(kernel, d, dev).n_cta for _, _, _, _, lay, _, _, _ in parts
                    for d in (True, False)]
            share = "not measured" if None in (cta_ms, dev_ms) else f"{cta_ms / dev_ms:.3f}"
            log(f"{tag} part phase: {wrapper.__name__} chain: the pass's {n} launches "
                f"({sum(ctas)} CTAs, {max(ctas)} in the largest) {fmt_ms(dev_ms)} alone; the same "
                f"launches cut to their first CTA {fmt_ms(cta_ms)} alone (median of 5); one CTA's "
                f"share of a full launch {share}")


def join_bytes(p):
    """The bytes the join of part p must move, each input read once and
    each output written once: its real directory entries (4 B each), the
    32 docids and 32 weights of each block they name (every block once),
    each packed row's tmax query weights and tgt, and the packed rows.
    Whichever slot drives a row, the function still needs every named
    block: an AND result's score sums a weight of each of the row's
    slots, and the search must read a block to know a docid is not in
    it."""
    lay = p["join"]
    blocks = len(np.unique(lay.ent >> 5))
    item = 2 if "counts" not in p["ops"] and p["fscale"] is not None else 4
    return (4 * len(lay.ent) + 256 * blocks + 4 * lay.n_rows * (lay.tmax + 1)
            + item * lay.n_rows * lay.width)


def and_candidates(lay, docs32, nd):
    """(AND candidates of the multi-term rows, real postings of the
    single-term rows) of a part: the docids found in all tgt slots of
    their row, counted with torch on the card from the part's decode."""
    import torch

    dev = docs32.device
    ent0, nent, tgt = (torch.from_numpy(lay.rows[:, i].astype(np.int64)).to(dev)
                       for i in range(3))
    total = int(nent.sum())
    if not total:
        return 0, 0
    row_of = torch.repeat_interleave(torch.arange(len(lay.rows), device=dev), nent)
    at = (torch.repeat_interleave(ent0 - (torch.cumsum(nent, 0) - nent), nent)
          + torch.arange(total, device=dev))
    ent = torch.from_numpy(lay.ent.astype(np.int64)).to(dev)[at]
    doc = docs32[ent >> 5].long()
    real = doc < nd
    key = (row_of[:, None] * (nd + 1) + doc)[real]
    u, c = torch.unique(key, return_counts=True)
    t = tgt[u // (nd + 1)]
    return int(((c == t) & (t > 1)).sum()), int(c[t == 1].sum())


def join_phase(eng, plan, tag, entry=None):
    """Over every part of the slice's plan: K3 (join_part, csrc/join.cu)
    on the part's decode against join_part_torch on the card, bit for bit,
    one launch a part; then one pass of the join (every part)
    timed through the wrapper, alone and plain, beside its bound by bytes
    (join_bytes). entry: K3's JSON entry, to take these numbers."""
    import torch

    from ds2i_torch.engine import resident
    from ds2i_torch.ops.join import join_part, join_part_torch

    s, dev, nd = eng.state, eng.device, eng.num_docs
    ranked = "or" in plan["ops"] or "and" in plan["ops"]
    parts, max_err = [], 0.0
    for p in plan["plans"]:
        gt, gf, bp = p["_dev"][dev][:3]
        docs32, w32 = resident._decode_part(s, gt, gf, bp, p["layout"], nd, ranked)
        fetch16 = "counts" not in p["ops"] and p["fscale"] is not None
        fscale = p["fscale"] if fetch16 else None
        args = (docs32, w32, p["join"], nd, fetch16, fscale)
        n0 = join_part.launches
        got = join_part(*args)
        n = join_part.launches - n0
        exp = join_part_torch(docs32, w32, *p["join"].plain(dev), nd, p["k"], p["ops"],
                              p["tmax"], fetch16, fscale)
        torch.cuda.synchronize()
        if n != 1:
            raise AssertionError(f"{tag}: join_part launched {n} times on one part")
        same = got.shape == exp.shape and got.dtype == exp.dtype and torch.equal(
            got.view(torch.int16 if fetch16 else torch.int32),
            exp.view(torch.int16 if fetch16 else torch.int32))
        if not same:
            raise AssertionError(f"{tag}: join_part differs from join_part_torch on a part of "
                                 f"the slice's plan")
        fin = torch.isfinite(exp)
        if fin.any():
            max_err = max(max_err, float((got.float() - exp.float())[fin].abs().max()))
        parts.append((p, args, exp))
    st = {}
    for p, (docs32, *_), _ in parts:
        for key, v in p["join"].structure().items():
            st[key] = st.get(key, 0) + v
        cand, single = and_candidates(p["join"], docs32, nd)
        st["and_candidates"] = st.get("and_candidates", 0) + cand
        st["single_term_postings"] = st.get("single_term_postings", 0) + single
    rows = sum(p["join"].n_rows for p, _, _ in parts)
    log(f"{tag} join phase: join_part == join_part_torch on all {len(parts)} parts of the "
        f"slice's plan, packed rows bit for bit ({rows} rows: {st['warp_rows']} on a warp, "
        f"{st['cta_rows']} on {st['items']} CTA items, {st['empty_rows']} with an empty slot; "
        f"{st['drive_entries']} driving of {st['entries']} directory entries; "
        f"{st['and_candidates']} AND candidates in multi-term rows, "
        f"{st['single_term_postings']} postings of single-term rows; "
        f"{st['merged_rows']} merged rows)")

    def run():
        for _, args, _ in parts:
            join_part(*args)

    def run_plain():
        for p, (docs32, w32, lay, _, fetch16, fscale), _ in parts:
            join_part_torch(docs32, w32, *lay.plain(dev), nd, p["k"], p["ops"], p["tmax"],
                            fetch16, fscale)

    n0 = join_part.launches
    run()
    launches = join_part.launches - n0
    ms = cuda_ms(run)
    dev_ms = device_only_ms(run)
    plain_ms = cuda_ms(run_plain)
    nbytes = sum(join_bytes(p) for p, _, _ in parts)
    bound_ms, bound_by = bound(nbytes)
    log(f"{tag} join phase: K3 over one pass, {launches} launches ({len(parts)} parts): "
        f"{ms:.4f} ms through the wrapper, {fmt_ms(dev_ms)} alone, plain PyTorch "
        f"{plain_ms:.4f} ms (median of 5); bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
        f"bytes)")
    if entry is not None:
        entry.update({"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      # no single PyTorch call joins rows by docid, counts
                      # and takes the top-k of the runs
                      "library_ms": None})


def slice_phase(eng, queries, wrappers, tag, prune=False):
    """A main path: prepare the whole log (prune: the and_skip plan, its
    probe run on the card), 1 warmup + PASSES timed passes. Every
    wrapper's launch count must rise in the timed passes; a pass launches
    pair_decode at most once a part, each block kernel at most twice a
    part (once per stream) and join_part once a part. Returns
    the plan and the last pass's results."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = eng.prepare(queries, k=10, ops=("and",), prune=prune)
    t1 = time.perf_counter()
    eng.execute(plan)  # warmup: builds the norm cache, uploads the plan
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ngroups = sum(len(p["groups"]) + len(p["groups_f"]) for p in plan["plans"])
    log(f"{tag} slice phase: prepare {t1 - t0:.2f} s ({len(plan['plans'])} parts, "
        f"{ngroups} decode groups); warmup pass {t2 - t1:.2f} s")
    if prune:
        log(f"{tag} slice phase: the plan's counts {plan['counts']}; the AND probe ran "
            f"{plan['counts']['probe_rows']} of {len(queries)} rows")
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
    nparts = len(plan["plans"])
    log(f"{tag} slice phase: launches a pass: "
        f"{ {name: n / PASSES for name, n in timed.items()} } over {nparts} parts")
    pair = plan["plans"][0]["layout"].pair
    for name, n in timed.items():
        per_part = 1 if pair or name == "join_part" else 2
        if n > per_part * nparts * PASSES:
            raise AssertionError(f"{name}: {n / PASSES} launches a pass, more than {per_part} a "
                                 f"part")
    us = [x / len(queries) * 1e6 for x in times]
    op = "and_skip (pruned) ranked_and" if prune else "exhaustive ranked_and"
    log(f"{tag} slice phase: {op} top-10, {len(queries)} queries, {PASSES} "
        f"passes: median {statistics.median(us):.4f} us/query (min {min(us):.4f}, max "
        f"{max(us):.4f}); pass seconds {[round(x, 4) for x in times]}; launches in the timed "
        f"passes: {timed}")
    log(f"{tag} slice phase: resident state {eng.state.nbytes()} bytes; "
        f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return plan, res


def main_path(eng, queries, path_kernels, tag, prune=False, before=None, join_entry=None):
    """Drive one main path with every kernel's launch count set to 0 just
    before it: before() (if given), then the slice phase. path_kernels is
    [(JSON entry or None, wrapper)] of the decode kernels the path must
    launch, and K3 (join_part, its JSON entry join_entry or None) runs on
    every path; each entry takes its count read just after, and the
    kernels other than blockmax (which runs only in before()) must launch
    in the timed passes. Then the join phase over the path's plan (K3
    timed into join_entry). Returns the plan and the last pass's
    results."""
    from ds2i_torch.ops import blockmax, join

    path_kernels = list(path_kernels) + [(join_entry, join.join_part)]
    all_wrappers = kernel_wrappers()
    for w in all_wrappers:
        w.launches = 0
    if before is not None:
        before()
    plan, res = slice_phase(eng, queries, [w for _, w in path_kernels
                                           if w is not blockmax.blockmax_rows], tag, prune)
    log(f"{tag} slice phase: launches over the main path: "
        f"{ {w.__name__: w.launches for w in all_wrappers} }")
    for entry, w in path_kernels:
        if entry is not None:
            entry["launches"] = w.launches
        if w.launches <= 0:
            raise AssertionError(f"the {tag} main path never launched the CUDA {w.__name__}")
    check_results(res, len(queries))
    decode_stage_phase(eng, plan, tag)
    join_phase(eng, plan, tag, join_entry)
    return plan, res


def kernel_wrappers():
    """Every kernel's wrapper, each counting its launches."""
    from ds2i_torch.ops import block_decode, blockmax, decode, join, pair_decode

    return (pair_decode.decode_pair, *block_decode.WRAPPERS.values(), blockmax.blockmax_rows,
            join.join_part, decode.decode_rows, pair_decode.decode_group)


def decode_stage_phase(eng, plan, tag):
    """The decode stage of one ranked pass alone: every part's
    _decode_part, host clock from the first call to a synchronise after
    the last (median of 5, after one untimed pass)."""
    import torch

    from ds2i_torch.engine import resident

    dev = eng.device
    s = eng.state

    def one_pass():
        for p in plan["plans"]:
            gt, gf, bp = p["_dev"][dev][:3]
            resident._decode_part(s, gt, gf, bp, p["layout"], eng.num_docs, True)
        torch.cuda.synchronize()

    one_pass()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        one_pass()
        times.append((time.perf_counter() - t) * 1e3)
    log(f"{tag} decode stage: _decode_part over the {len(plan['plans'])} parts of a ranked pass: "
        f"{statistics.median(times):.4f} ms host clock to the synchronise (median of 5; "
        f"min {min(times):.4f}, max {max(times):.4f})")


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


BLOCKMAX_FIELDS = (
    "wmax_blk", "dmax_blk", "dmin_blk", "gblk0", "tile_of_gblk", "list_gblk0",
    "list_wmax", "_kth_vals", "_kth_start", "rank_blk", "_blk_dlo",
    "_dmax_keys", "_dlo_keys", "_pyr", "_pyr_off", "_pyr_q",
    "is_short", "_short_keys", "_short_w",
)


def topk_mismatches(got, exp):
    """Indices of queries whose top-k lists differ in length or in a score
    beyond rtol RTOL."""
    return [i for i, (g, e) in enumerate(zip(got, exp))
            if len(g) != len(e) or (e and not np.allclose(g, e, rtol=RTOL, atol=0))]


def dir_blocks(plan):
    """Directory entries (query row, block) of a plan."""
    return sum(int((b["dir"] != p["sent_dir"]).sum()) for p in plan["plans"] for b in p["buckets"])


def and_skip_path(eng, index, coll, wdata, queries, exhaustive_plan, exhaustive_res, tag,
                  decode_wrappers, entry=None, second_engine=True):
    """bench.py's default path (and_skip) on a split-mode engine:
    build_blockmax over the collection (blockmax in planes form),
    prepare(prune=True, ops=("and",)) with its probe on the card, 1 warmup
    + PASSES timed passes, counts set to 0 before build_blockmax; blockmax
    and every decode wrapper given must launch. Then: the full log against
    the exhaustive ranked_and of the same engine; the decode pass
    (_ensure_blockmax, rows form) on a second engine (second_engine), every
    pruning table byte-equal to the collection pass's; wand and maxscore
    against ranked_or. Returns the decode-pass engine (or None),
    blockmax's JSON entry (`entry` takes the launches of this path; the
    rest is filled by blockmax_phase) and the last timed pass's
    results."""
    import torch

    from ds2i_torch.ops import blockmax

    def build():
        t0 = time.perf_counter()
        eng.build_blockmax(coll)
        torch.cuda.synchronize()
        log(f"{tag} and_skip: build_blockmax over the collection {time.perf_counter() - t0:.2f} "
            f"s ({len(eng.wmax_blk)} blocks, {blockmax.blockmax_rows.launches} blockmax "
            f"launches, planes form)")

    plan, res = main_path(eng, queries, [(entry, blockmax.blockmax_rows)]
                          + [(None, w) for w in decode_wrappers],
                          f"{tag} and_skip", prune=True, before=build)
    kept, full = dir_blocks(plan), dir_blocks(exhaustive_plan)
    log(f"{tag} and_skip: {len(plan['plans'])} parts; directory entries kept {kept} of the "
        f"exhaustive plan's {full} ({kept / max(full, 1):.4f}); decode groups "
        f"{sum(len(p['groups']) + len(p['groups_f']) for p in plan['plans'])}")

    # the full log: pruned against exhaustive, query by query
    got = [eng._topk_list(r[3]) for r in res]
    exp = [eng._topk_list(r[3]) for r in exhaustive_res]
    bad = topk_mismatches(got, exp)
    log(f"{tag} and_skip: full-log identity over {len(queries)} queries: {len(bad)} mismatches "
        f"against the exhaustive ranked_and (equal lengths, rtol {RTOL}); {sum(map(len, got))} "
        f"results")
    if bad:
        raise AssertionError(f"{tag}: and_skip differs from the exhaustive ranked_and on queries "
                             f"{bad[:10]}")

    # the decode pass on a second engine: byte-equal tables
    dec = None
    if second_engine:
        dec = start_engine(index, wdata)
        n0 = blockmax.blockmax_rows.launches
        t0 = time.perf_counter()
        dec._ensure_blockmax()
        torch.cuda.synchronize()
        log(f"{tag} and_skip: _ensure_blockmax (every tile decoded, rows form) on a second "
            f"engine {time.perf_counter() - t0:.2f} s ({blockmax.blockmax_rows.launches - n0} "
            f"blockmax launches, norm cache included)")
        for name in BLOCKMAX_FIELDS:
            a, b = np.asarray(getattr(dec, name)), np.asarray(getattr(eng, name))
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"{tag} {name}: the decode pass and build_blockmax differ")
        log(f"{tag} and_skip: all {len(BLOCKMAX_FIELDS)} pruning tables byte-equal between the "
            f"decode pass and build_blockmax")

    # OR pruning against the exhaustive ranked_or
    qs = queries[:OR_PRUNE_QUERIES]
    t0 = time.perf_counter()
    exact = eng.ranked_or(qs, k=10)
    for op in ("wand", "maxscore"):
        bad = topk_mismatches(getattr(eng, op)(qs, k=10), exact)
        if bad:
            raise AssertionError(f"{tag}: {op} differs from ranked_or on queries {bad[:10]}")
    log(f"{tag} and_skip: wand and maxscore equal ranked_or on {len(qs)} queries "
        f"({time.perf_counter() - t0:.1f} s)")
    return dec, entry, res


def blockmax_phase(eng, dec, coll, entry):
    """The blockmax kernel against blockmax_rows_torch on the card, bit for
    bit, over every block in both forms: rows form over the decode pass's
    BM25 rows of every tile (dec), planes form over the collection's slot
    planes; each timed through the wrapper, alone and plain, beside its
    bound by bytes: each row's docs and w (rows) or docs and freqs
    (planes) read once, norm_den once, wmax, dmax and dmin written (and
    the w plane, planes form)."""
    import torch

    from ds2i_torch.engine import resident
    from ds2i_torch.ops.blockmax import blockmax_rows, blockmax_rows_torch

    nd = eng.num_docs
    docs32, w32, _, _, _ = resident._decode_slots_step(dec.state, dec.all_tiles_part(), nd)
    dp, fp = eng._collection_planes(coll)
    planes = (torch.from_numpy(dp).cuda(), torch.from_numpy(fp).cuda(), eng.state.norm_den)
    max_err, out = 0.0, {}
    for form, (d, v, den) in (("rows", (docs32, w32, None)), ("planes", planes)):
        got, exp = blockmax_rows(d, v, nd, den), blockmax_rows_torch(d, v, nd, den)
        torch.cuda.synchronize()
        for g, e in zip(got, exp):
            if (g is None) != (e is None) or (g is not None and not _same_bits(g, e)):
                raise AssertionError(f"blockmax ({form} form) differs from blockmax_rows_torch")
            if g is not None:
                max_err = max(max_err, float((g.double() - e.double()).abs().max()))
        rows = d.shape[0]
        nbytes = rows * (256 + 12) + (rows * 128 + 4 * nd if den is not None else 0)
        ms = cuda_ms(lambda: blockmax_rows(d, v, nd, den))
        dev_ms = device_only_ms(lambda: blockmax_rows(d, v, nd, den))
        plain_ms = cuda_ms(lambda: blockmax_rows_torch(d, v, nd, den))
        bound_ms, bound_by = bound(nbytes)
        out[form] = (ms, plain_ms, bound_ms, bound_by)
        what = "the decode pass, every tile" if den is None else "the collection, every block"
        log(f"blockmax phase: {form} form, {rows} rows ({what}): "
            f"CUDA == plain bit for bit; kernel {ms:.4f} ms through the wrapper, {fmt_ms(dev_ms)} "
            f"alone, plain PyTorch {plain_ms:.4f} ms (median of 5); bound {bound_ms:.4f} ms by "
            f"{bound_by} ({nbytes} bytes)")
    ms, plain_ms, bound_ms, bound_by = out["planes"]  # the form of the main path's launches
    entry.update({"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by,
                  # no single PyTorch call takes the masked row max, the masked
                  # docid max and the first slot together
                  "library_ms": None})
    return entry


def opt_prune_phase(eng, queries):
    """ranked_and(prune=True) on the `opt` engine (the decode pass in pair
    mode, its probe through pair_decode) against its exhaustive
    ranked_and."""
    from ds2i_torch.ops import blockmax, pair_decode

    qs = queries[:ORACLE_QUERIES]
    n0, b0 = pair_decode.decode_pair.launches, blockmax.blockmax_rows.launches
    t0 = time.perf_counter()
    bad = topk_mismatches(eng.ranked_and(qs, k=10, prune=True), eng.ranked_and(qs, k=10))
    if bad:
        raise AssertionError(f"opt: pruned ranked_and differs from exhaustive on queries {bad[:10]}")
    log(f"opt prune phase: ranked_and(prune=True) equals the exhaustive ranked_and on {len(qs)} "
        f"queries ({time.perf_counter() - t0:.1f} s; pair_decode launches "
        f"{pair_decode.decode_pair.launches - n0}, blockmax {blockmax.blockmax_rows.launches - b0})")



def kernel_of_entry(entry):
    """The ops/block_decode.py KERNELS name of a block kernel's JSON entry
    (its wrapper's name less "_decode")."""
    return entry["name"][:-len("_decode")]


def block_path(index, wdata, queries, entries, tag, join_entry=None):
    """A split-mode main path: the engine, the block kernel phase over
    every tile (each kernel bit-equal to its plain version in every mode;
    kernels not yet in `entries` timed, and their JSON entries added
    there), the 35k-query exhaustive slice (launch counts set to 0 just
    before it; an entry takes its kernel's count from the first path that
    times it), the part phase (the chain line for the kernels timed
    here: K1 and K2 on block_optpfor, K7 on block_varint, K8 on
    block_qmx) and the 300-query oracle. Returns the
    engine, the plan, the last pass's results and the decode wrappers the
    path launched. join_entry: K3's JSON entry, timed on this path."""
    from ds2i_torch.ops import block_decode

    eng = start_engine(index, wdata)
    new, code_words = block_kernel_phase(eng, index, tag, timed=set(block_decode.WRAPPERS)
                                         - {kernel_of_entry(e) for e in entries})
    entries += new
    part = eng.all_tiles_part()
    wrappers = [w for k, w in block_decode.WRAPPERS.items()
                if any(part.layout.launch(k, d, eng.device).n_cta for d in (True, False))]
    entry_of = {e["name"]: e for e in new}
    plan, res = main_path(eng, queries, [(entry_of.get(w.__name__), w) for w in wrappers], tag,
                          join_entry=join_entry)
    part_kernel_phase(eng, plan, code_words, tag, chain={kernel_of_entry(e) for e in new})
    oracle_phase(eng, index, wdata, queries, ORACLE_QUERIES, tag)
    return eng, plan, res, wrappers


def inpass_engine_limit(index):
    """The resident word limit just above a block index's own words: its
    exception patch pairs pass it, so an engine built under it decodes
    the exceptions in the pass (K1s), as past 2^31 words."""
    n = len(np.asarray(index.lists))
    return (n + (-n) % 4 + 8) // 4 + 1


def inpass_vs_patched(eng, patched, tag):
    """Every tile decoded by both engines' all-tiles part on the card
    (BM25 docs32 and w32, and the raw freqs): the tiles of the in-pass
    engine's ("opt", b, E > 0) groups, K1s's rows, equal the patched
    engine's ("optp", K1 with resident patches) bit for bit. Returns the
    rows with exceptions of each stream."""
    import torch

    from ds2i_torch.ops.block_decode import KERNELS, WRAPPERS, split_decode_part

    out, rows = [], {}
    for e in (eng, patched):
        e._ensure_norm_cache()
        s, dev, nd = e.state, e.device, e.num_docs
        part = e.all_tiles_part()
        gt, gf, bp, lay = part[:4]
        docs32, w32 = split_decode_part(s.docs_words, s.tiles_docs, s.tiles_freqs, gt, gf, bp,
                                        lay, nd, "bm25", s.den_blocks, s.tile_gblk0)
        freq = torch.empty((lay.nb_f, 32), dtype=torch.int32, device=dev)
        for kernel in KERNELS:
            launch = lay.launch(kernel, False, dev)
            if launch.n_cta:
                WRAPPERS[kernel](launch, s.docs_words, s.tiles_freqs, gf, "freqs", nd, freq)
        out.append((part, docs32, w32, freq))
    torch.cuda.synchronize()
    blk = torch.arange(4, device=eng.device)
    for is_docs, gid, statics in ((True, eng.tile_gid_d, eng.group_statics_d),
                                  (False, eng.tile_gid_f, eng.group_statics_f)):
        ex = np.array([st[0] == "opt" and st[2] > 0 for st in statics])[gid]
        tiles = np.flatnonzero(ex[:eng.pad_tile])
        rows[is_docs] = len(tiles)
        got = []
        for part, docs32, w32, freq in out:
            tblk = torch.from_numpy(np.asarray(part.tblk if is_docs else part.tblk_f)[tiles])
            idx = (tblk.to(eng.device)[:, None] + blk[None, :]).reshape(-1)
            got.append((docs32[idx], w32[idx]) if is_docs else (freq[idx],))
        if not all(_same_bits(a, b) for a, b in zip(*got)):
            raise AssertionError(f"{tag}: K1s differs from the patched engine's K1 on the "
                                 f"{'docs' if is_docs else 'freqs'} rows with exceptions")
    full = {}
    for is_docs, gid, statics in ((True, eng.tile_gid_d, eng.group_statics_d),
                                  (False, eng.tile_gid_f, eng.group_statics_f)):
        opt = np.array([st[0] in ("opt", "optp") and st[-1] == 128 for st in statics])
        full[is_docs] = int(opt[gid[:eng.pad_tile]].sum())
    log(f"{tag}: K1s == the patched engine's K1 (\"optp\") bit for bit on every row with "
        f"exceptions: {rows[True]} docs rows (docs32, BM25 w32) of {full[True]} full OptPFor "
        f"blocks, {rows[False]} freqs rows of {full[False]}")
    return rows


def inpass_path(index, coll, wdata, queries, entries, patched, patched_plan, patched_res,
                patched_skip):
    """The block_optpfor engine past its resident word limit (the limit
    lowered for that engine only: inpass_engine_limit): no "optp" group
    remains and the OptPFor groups with exceptions decode in the pass,
    by K1s. A block path (block_path: the kernel phase over every tile,
    K1s timed into its new JSON entry; the exhaustive main path with every
    count set to 0 just before it; the part phase with K1s's chain line;
    the oracle), the rows with exceptions against the patched engine's
    (inpass_vs_patched), its and_skip path (and_skip_path, no second
    engine); the full log, exhaustive and and_skip, against the patched
    engine's query by query; then µs/query of both engines in turns
    (patched, in-pass, in-pass, patched), exhaustive and and_skip."""
    from ds2i_torch.engine import resident
    from ds2i_torch.ops import block_decode

    tag = "block_optpfor in-pass"
    t0 = time.perf_counter()
    limit, old = inpass_engine_limit(index), resident.RESIDENT_WORD_LIMIT
    resident.RESIDENT_WORD_LIMIT = limit
    try:
        eng, plan, res, wrappers = block_path(index, wdata, queries, entries, tag)
    finally:
        resident.RESIDENT_WORD_LIMIT = old
    statics = eng.group_statics_d + eng.group_statics_f
    npatch = patched.state.docs_words.numel() - eng.state.docs_words.numel()
    if any(st[0] == "optp" for st in statics) or not any(st[0] == "opt" and st[2] > 0
                                                         for st in statics):
        raise AssertionError(f"{tag}: the engine kept no in-pass group or left an \"optp\" one")
    if block_decode.optpfor_s16_decode not in wrappers:
        raise AssertionError(f"{tag}: the main path did not run K1s")
    log(f"{tag}: resident word limit lowered to {limit} for this engine (index words "
        f"{eng.state.docs_words.numel()}, patch words {npatch}): "
        f"{sum(st[0] == 'opt' and st[2] > 0 for st in statics)} in-pass groups, no \"optp\"")
    inpass_vs_patched(eng, patched, tag)
    _, _, skip = and_skip_path(eng, index, coll, wdata, queries, plan, res, tag, wrappers,
                               second_engine=False)
    for label, got, exp in (("exhaustive", res, patched_res), ("and_skip", skip, patched_skip)):
        bad = topk_mismatches([eng._topk_list(r[3]) for r in got],
                              [patched._topk_list(r[3]) for r in exp])
        if bad:
            raise AssertionError(f"{tag}: {label} differs from the patched engine on queries "
                                 f"{bad[:10]}")
    log(f"{tag}: the full log equals the patched engine's query by query, exhaustive and "
        f"and_skip (equal lengths, rtol {RTOL}; {len(queries)} queries each)")
    skip_plans = [e.prepare(queries, k=10, ops=("and",), prune=True) for e in (patched, eng)]
    for label, plans in (("exhaustive ranked_and", (patched_plan, plan)), ("and_skip", skip_plans)):
        us = {"patched": [], "in-pass": []}
        for name in ("patched", "in-pass", "in-pass", "patched"):
            e, p = (patched, plans[0]) if name == "patched" else (eng, plans[1])
            us[name].append(pass_us(e, p, len(queries)))
        log(f"{tag}: {label}: {statistics.mean(us['in-pass']):.4f} µs/query in-pass "
            f"({', '.join(f'{x:.4f}' for x in us['in-pass'])}) against "
            f"{statistics.mean(us['patched']):.4f} patched "
            f"({', '.join(f'{x:.4f}' for x in us['patched'])}), medians of 5 passes, in turns")
    log(f"{tag} phase: {time.perf_counter() - t0:.1f} s")


class Tools:
    """Tools run as a user runs them, `python -m ds2i_torch.tools.<tool>
    arguments` from the repository's root, each in its own process; a
    wave of them starts at once and runs while this process goes on (the
    queries tool gets --device tool_device when given). A thread a tool
    reads its output as it comes and notes when it exits, so a tool never
    waits on a full pipe and its seconds are its own, however long this
    process is busy. kill() stops any still running."""

    def __init__(self, tool_device=None, tag="front door"):
        self.tool_device = tool_device
        self.tag = tag
        self.procs = []

    @staticmethod
    def _drain(proc, box):
        box["out"], box["err"] = proc.communicate()
        box["exit"] = time.perf_counter()

    def start(self, cmds):
        """Start every tool of `cmds` ({label: [tool, arguments...]})."""
        import threading

        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0, wave = time.perf_counter(), {}
        for label, (tool, *args) in cmds.items():
            if tool == "queries" and self.tool_device is not None:
                args += ["--device", self.tool_device]
            proc = subprocess.Popen(
                [sys.executable, "-m", f"ds2i_torch.tools.{tool}", *map(str, args)], cwd=HERE,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            self.procs.append(proc)
            box = {}
            reader = threading.Thread(target=Tools._drain, args=(proc, box), daemon=True)
            reader.start()
            wave[label] = (proc, reader, box)
        return t0, wave, self.tag

    @staticmethod
    def wait(started):
        """Wait for a started wave; every tool must exit 0 within
        TOOL_TIMEOUT_S of the wait. Returns {label: (seconds from the
        wave's start to its exit, its stats lines)}."""
        t0, wave, tag = started
        out = {}
        for label, (proc, reader, box) in wave.items():
            reader.join(TOOL_TIMEOUT_S)
            if reader.is_alive():
                proc.kill()
                reader.join()
                raise AssertionError(f"{label} ran past {TOOL_TIMEOUT_S} s")
            if proc.returncode != 0:
                raise AssertionError(f"{label} exited {proc.returncode}:\n{box['err'][-3000:]}")
            out[label] = (box["exit"] - t0,
                          [json.loads(x) for x in box["out"].splitlines() if x.startswith("{")])
            log(f"{tag}: {label}: exit 0 after {out[label][0]:.1f} s from its wave's start; "
                f"stats lines: {json.dumps(out[label][1])}")
        return out

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


QUERY_TOOL_OPS = "and:ranked_and:wand:maxscore"


def build_tools(base, f):
    """The quick start's first wave: create_freq_index --check for opt
    and block_optpfor, and create_wand_data."""
    return {
        "create_freq_index opt --check": ["create_freq_index", "opt", base, f("opt.bin"),
                                          "--check"],
        "create_freq_index block_optpfor --check": ["create_freq_index", "block_optpfor", base,
                                                    f("block_optpfor.bin"), "--check"],
        "create_wand_data": ["create_wand_data", base, f("wand.bin")],
    }


def check_built(built):
    """Each create_freq_index printed its build's stats lines (postings,
    size; partitions for opt); create_wand_data prints none (its file
    is loaded by loaded_phase)."""
    for label, (_, lines) in built.items():
        if label.startswith("create_freq_index"):
            name = label.split()[1]
            if not (any(x.get("type") == name and x.get("postings", 0) > 0 for x in lines)
                    and any("size" in x and "bits_per_posting" in x for x in lines)
                    and (name != "opt" or any(x.get("partitions", 0) > 0 for x in lines))):
                raise AssertionError(f"{label}: its stats lines lack the build's: {lines}")


def query_tools(base, f):
    """The second wave, over the first's files: the queries tool with
    block_optpfor's four ops and opt's ranked_and on the resident engine
    (the card), block_optpfor's ranked_and on the native CPU cursors."""
    q = ["--queries", base + ".queries"]
    return {
        "queries block_optpfor resident": ["queries", "block_optpfor", QUERY_TOOL_OPS,
                                           f("block_optpfor.bin"), f("wand.bin"), *q, "--engine",
                                           "resident"],
        "queries opt resident": ["queries", "opt", "ranked_and", f("opt.bin"), f("wand.bin"), *q,
                                 "--engine", "resident"],
        "queries block_optpfor native": ["queries", "block_optpfor", "ranked_and",
                                         f("block_optpfor.bin"), f("wand.bin"), *q, "--engine",
                                         "native"],
    }


def check_served(served):
    """Each queries run printed one stats line an op, on its engine."""
    want = {"queries block_optpfor resident": QUERY_TOOL_OPS.split(":"),
            "queries opt resident": ["ranked_and"], "queries block_optpfor native": ["ranked_and"]}
    for label, (_, lines) in served.items():
        engine = label.split()[-1]
        if ([x.get("query") for x in lines] != want[label]
                or not all(x.get("engine") == engine and x.get("avg", 0) > 0 for x in lines)):
            raise AssertionError(f"{label}: stats lines {lines}, expected {want[label]} on the "
                                 f"{engine} engine")


def loaded_phase(f, index, wdata, single, queries, exact_and):
    """The files the tools wrote, loaded back through the port's front
    door (tools.common): the block_optpfor index byte-equal to the
    in-process one (lists and endpoints), the wand data equal, and an
    engine over them giving the in-process engine's top-10 on every
    query. Returns the loaded `opt` index."""
    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.tools.common import load_index, load_wand_data

    loaded = load_index(f("block_optpfor.bin"), "block_optpfor")
    lw = load_wand_data(f("wand.bin"))
    if not (np.asarray(loaded.lists).tobytes() == np.asarray(index.lists).tobytes()
            and np.array_equal(np.asarray(loaded.endpoints()), np.asarray(index.endpoints()))):
        raise AssertionError("the block_optpfor index the tool wrote differs from the in-process one")
    for name in ("norm_lens", "max_term_weight"):
        if np.asarray(getattr(lw, name)).tobytes() != np.asarray(getattr(wdata, name)).tobytes():
            raise AssertionError(f"the wand data the tool wrote differs in {name}")
    eng = ResidentEngine(loaded, lw, device=single.device)
    bad = topk_mismatches(eng.ranked_and(queries, k=10), exact_and)
    if bad:
        raise AssertionError(f"the engine over the loaded index differs on queries {bad[:10]}")
    log(f"front door: the loaded block_optpfor index is byte-equal to the in-process one "
        f"({len(loaded.lists)} bytes, {loaded.size()} lists), the wand data equal; an engine "
        f"over them gives the same top-10 on all {len(queries)} queries")
    return load_index(f("opt.bin"), "opt")


def pass_us(eng, plan, n, passes=5):
    """Median µs/query of `passes` executions of `plan` (after one
    untimed), host clock."""
    import torch

    eng.execute(plan)
    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.execute(plan)
        times.append((time.perf_counter() - t) / n * 1e6)
    return statistics.median(times)


def shard_phase(coll, wdata, single, queries, exact_and, exact_or, dev):
    """DocShardedEngine.from_collection, FRONT_DOOR_SHARDS doc-range
    shards of block_optpfor on the card, against the single engine on
    every query: and/or counts exact; exhaustive ranked_and and
    ranked_or, and_skip, wand and maxscore within rtol RTOL of the
    single engine's exhaustive ops. Returns the sharded engine."""
    from ds2i_torch.parallel import DocShardedEngine

    t0 = time.perf_counter()
    sharded = DocShardedEngine.from_collection(coll, "block_optpfor", wdata,
                                               num_shards=FRONT_DOOR_SHARDS, devices=[dev])
    log(f"front door: DocShardedEngine.from_collection, {sharded.num_shards} shards on {dev}: "
        f"{time.perf_counter() - t0:.1f} s; doc bounds {sharded.bounds.tolist()}")
    for op in ("and_counts", "or_counts"):
        got, exp = getattr(sharded, op)(queries), getattr(single, op)(queries)
        if not np.array_equal(got, exp):
            raise AssertionError(f"sharded {op} differ on {int(np.sum(got != exp))} queries")
    for op, got, exp in (
            ("ranked_and", sharded.ranked_and(queries, k=10), exact_and),
            ("ranked_or", sharded.ranked_or(queries, k=10), exact_or),
            ("and_skip", sharded.ranked_and(queries, k=10, prune=True), exact_and),
            ("wand", sharded.wand(queries, k=10), exact_or),
            ("maxscore", sharded.maxscore(queries, k=10), exact_or)):
        bad = topk_mismatches(got, exp)
        if bad:
            raise AssertionError(f"sharded {op} differs from the single engine's exhaustive op "
                                 f"on queries {bad[:10]}")
    log(f"front door: the sharded engine equals the single engine on all {len(queries)} "
        f"queries: and/or counts exact; ranked_and, ranked_or, and_skip, wand and maxscore "
        f"within rtol {RTOL} of the exhaustive ops")
    return sharded


def shard_timing(sharded, single, queries):
    """Each shard's parts and kernel launches a pass, and µs/query of the
    sharded engine beside the single engine's, exhaustive and
    and_skip."""
    wrappers = kernel_wrappers()
    for label, prune in (("exhaustive ranked_and", False), ("and_skip", True)):
        plan = sharded.prepare(queries, k=10, ops=("and",), prune=prune)
        one = single.prepare(queries, k=10, ops=("and",), prune=prune)
        for i, (e, p) in enumerate(zip(sharded.engines, plan["shards"])):
            n0 = [w.launches for w in wrappers]
            e.execute(p)
            n = {w.__name__: w.launches - a for w, a in zip(wrappers, n0) if w.launches > a}
            log(f"front door: {label}: shard {i}: {len(p['plans'])} parts, launches a pass {n}")
        log(f"front door: {label}: {pass_us(sharded, plan, len(queries)):.4f} µs/query over "
            f"{sharded.num_shards} shards against {pass_us(single, one, len(queries)):.4f} on "
            f"the single engine ({len(one['plans'])} parts), median of 5 passes each")


def make_engine_phase(index, wdata, single, queries, exact_and):
    """make_engine: a ResidentEngine under the limit it computes from the
    card's memory, a DocShardedEngine with equal results under a third
    of the index's bytes."""
    import torch

    from ds2i_torch.engine import ResidentEngine, make_engine, resident_stream_limit
    from ds2i_torch.parallel import DocShardedEngine

    dev = single.device
    limit = resident_stream_limit(dev)
    log(f"front door: make_engine's limit on {torch.cuda.get_device_name(dev)}: {limit} bytes "
        f"(the JAX package's {(1 << 33) - (1 << 20)}; half the card's memory "
        f"{torch.cuda.get_device_properties(dev).total_memory // 2})")
    eng = make_engine(index, wdata, device=dev)
    if not isinstance(eng, ResidentEngine):
        raise AssertionError(f"make_engine gave a {type(eng).__name__} for {len(index.lists)} bytes")
    del eng
    forced = make_engine(index, wdata, limit=len(index.lists) // 3, device=dev)
    if not isinstance(forced, DocShardedEngine):
        raise AssertionError(f"make_engine under a third of the bytes gave {type(forced).__name__}")
    bad = topk_mismatches(forced.ranked_and(queries, k=10), exact_and)
    if bad or not np.array_equal(forced.and_counts(queries), single.and_counts(queries)):
        raise AssertionError(f"make_engine's sharded engine differs on queries {bad[:10]}")
    log(f"front door: make_engine: a ResidentEngine for {len(index.lists)} bytes; under "
        f"{len(index.lists) // 3} bytes a DocShardedEngine of {forced.num_shards} shards, equal "
        f"on all {len(queries)} queries (and counts, ranked_and)")


def replica_phase(index, wdata, queries, exact_and, exact_skip, dev):
    """ResidentEngine(devices=[dev, dev]): two copies of the resident
    state on the card, a plan's parts round-robin over them, results
    equal to the single engine's (exhaustive and and_skip)."""
    from ds2i_torch.engine import ResidentEngine

    two = ResidentEngine(index, wdata, devices=[dev, dev],
                         max_part_queries=-(-len(queries) // 8))
    plan = two.prepare(queries, k=10, ops=("and",))
    if len(plan["plans"]) < 4:
        raise AssertionError(f"{len(plan['plans'])} parts: too few to round-robin")
    got = [two._topk_list(r[3]) for r in two.execute(plan)]
    bad = topk_mismatches(got, exact_and) + topk_mismatches(
        two.ranked_and(queries, k=10, prune=True), exact_skip)
    if bad:
        raise AssertionError(f"two replicas differ from one engine on queries {bad[:10]}")
    log(f"front door: ResidentEngine(devices=[{dev}, {dev}]): {len(plan['plans'])} parts "
        f"round-robin over 2 copies of the state ({two.state.nbytes()} bytes each), exhaustive "
        f"and and_skip equal to one engine on all {len(queries)} queries")


def cache_phase(name, index, coll, wdata, queries, cache_dir, dev):
    """cache_dir: a cold engine builds and saves, a second engine over
    the same index loads. Both set-ups timed (init, _ensure_norm_cache,
    build_blockmax, prepare(prune=True, ops=("and",))); the second
    launches K5 (blockmax) and the norm cache's decode zero times, and
    its and_skip answers equal the first's."""
    import torch

    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.ops import blockmax

    decoders = [w for w in kernel_wrappers() if w.__name__.endswith("decode")
                or w.__name__ == "decode_pair"]
    runs = []
    for run in ("cold", "warm"):
        k5, dec = blockmax.blockmax_rows.launches, sum(w.launches for w in decoders)
        t = {}
        t0 = time.perf_counter()
        eng = ResidentEngine(index, wdata, device=dev, cache_dir=cache_dir)
        t["init"] = time.perf_counter() - t0
        for stage, fn in (("_ensure_norm_cache", eng._ensure_norm_cache),
                          ("build_blockmax", lambda: eng.build_blockmax(coll)),
                          ("prepare", lambda: eng.prepare(queries, k=10, ops=("and",),
                                                          prune=True))):
            t0 = time.perf_counter()
            plan = fn()
            torch.cuda.synchronize()
            t[stage] = time.perf_counter() - t0
        k5, dec = blockmax.blockmax_rows.launches - k5, sum(w.launches for w in decoders) - dec
        res = [eng._topk_list(r[3]) for r in eng.execute(plan)]
        runs.append((t, k5, dec, res))
        log(f"front door: {name} cache_dir, {run} engine: set-up (s) "
            f"{ {k: round(v, 4) for k, v in t.items()} }, total {sum(t.values()):.4f}; K5 "
            f"launches {k5}, decode launches before the first pass {dec}; the AND probe ran "
            f"{plan['counts']['probe_rows']} rows")
        del eng
    (_, k5_cold, _, cold), (_, k5_warm, dec_warm, warm) = runs
    if k5_cold <= 0 or k5_warm != 0 or dec_warm != 0:
        raise AssertionError(f"{name}: K5 launched {k5_cold} times cold, {k5_warm} warm; the "
                             f"warm set-up launched {dec_warm} decodes")
    bad = topk_mismatches(warm, cold)
    if bad:
        raise AssertionError(f"{name}: the cached engine's and_skip differs on queries {bad[:10]}")
    log(f"front door: {name} cache_dir: the second engine launched K5 0 times and equals the "
        f"first's and_skip on all {len(queries)} queries; files "
        f"{sorted(os.listdir(cache_dir))}")


def front_door_phase(coll, wdata, queries, index, entries, tool_device=None):
    """This slice's path, its launch counts set to 0 just before it and
    read just after (into each JSON entry's front_door_launches). The
    tools run in their own processes while this one checks what needs
    no file of theirs: their first wave (build_tools) beside the
    doc-sharded engine (shard_phase), make_engine (make_engine_phase)
    and two replicas (replica_phase); their second (query_tools) beside
    the files loaded back (loaded_phase). Then, with no tool running,
    what is timed: the sharded engine's passes (shard_timing) and
    cache_dir over block_optpfor and the loaded `opt` index
    (cache_phase). index: the in-process block_optpfor index. The
    launches of the tools' own processes are not counted here."""
    import shutil

    import torch

    from ds2i_torch.ops import blockmax, join, pair_decode

    for w in kernel_wrappers():
        w.launches = 0
    t_phase = time.perf_counter()
    out = os.path.join(HERE, "build", "ds2i_front_door")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    f = lambda name: os.path.join(out, name)  # noqa: E731
    base = collection_base()
    tools = Tools(tool_device)
    try:
        wave = tools.start(build_tools(base, f))
        single = start_engine(index, wdata)
        dev = single.device
        exact_and, exact_or = single.ranked_and(queries, k=10), single.ranked_or(queries, k=10)
        exact_skip = single.ranked_and(queries, k=10, prune=True)
        sharded = shard_phase(coll, wdata, single, queries, exact_and, exact_or, dev)
        make_engine_phase(index, wdata, single, queries, exact_and)
        replica_phase(index, wdata, queries, exact_and, exact_skip, dev)
        check_built(Tools.wait(wave))
        wave = tools.start(query_tools(base, f))
        opt_index = loaded_phase(f, index, wdata, single, queries, exact_and)
        check_served(Tools.wait(wave))
        log(f"front door: the tools' two waves and the checks beside them: "
            f"{time.perf_counter() - t_phase:.1f} s")
        shard_timing(sharded, single, queries)
        del single, sharded
        torch.cuda.empty_cache()
        for name, idx in (("block_optpfor", index), ("opt", opt_index)):
            cache_phase(name, idx, coll, wdata, queries, f(f"cache_{name}"), dev)
    finally:
        tools.kill()
        shutil.rmtree(out, ignore_errors=True)
    counts = {w.__name__: w.launches for w in kernel_wrappers()}
    log(f"front door: launches over the phase (this process): {counts}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    for w in (pair_decode.decode_pair, *(w for w in kernel_wrappers() if w.__name__ in (
            "optpfor_decode", "interp_decode")), blockmax.blockmax_rows, join.join_part):
        if w.launches <= 0:
            raise AssertionError(f"the front door phase never launched the CUDA {w.__name__}")
    wrapper_of = {"pair_decode": "decode_pair", "blockmax": "blockmax_rows", "join": "join_part",
                  "segment_decode": "decode_rows", "tile_decode": "decode_group"}
    for e in entries:
        e["front_door_launches"] = counts[wrapper_of.get(e["name"], e["name"])]


GEN_ORACLE_QUERIES = 300
GEN_RANDOM_LISTS = 200
GEN_REPLAY_CALLS = 24  # engine decode_rows calls replayed through the plain version
GEN_REPLAY_SEED = 5
PLANE_SEED = 13  # the sharded plane's seeded batch


PLAIN_BITS = 1 << 27  # the most window bits (rows x W x 32) one plain piece expands


def plain_pieces(f, st):
    """decode_rows_torch's pieces of one decode_rows call (the call's nine
    fields `f` and statics `st`), whose (R, W*32) bit planes over every
    row at the call's W would not fit: its rows bucketed by the pow4
    window words they span and cut to at most PLAIN_BITS bits a piece,
    each piece with a W and Lseg that decode its rows as the call's do
    (min(W, 4**b) spans every window of bucket b; min(Lseg, the pow2 of
    the piece's n_vals) every slot it writes)."""
    import torch

    from ds2i_torch.engine.device_index import _pow_at_least

    ss, sl, n = (f[k].cpu().numpy().astype(np.int64) for k in ("sel_start", "sel_len", "n_vals"))
    words = ((ss & 31) + np.maximum(sl, 0) + 31) // 32
    bucket = np.ceil(np.log2(np.maximum(words, 4)) / 2).astype(np.int64)
    dev = f["kind"].device
    pieces = []
    for b in np.unique(bucket):
        sel = np.flatnonzero(bucket == b)
        W = min(st["W"], 4 ** int(b))
        Lseg = min(st["Lseg"], _pow_at_least(max(int(n[sel].max()), 1), lo=32))
        per = max(1, PLAIN_BITS // (W * 32 + Lseg))
        for i in range(0, len(sel), per):
            part = sel[i:i + per]
            Lp = min(Lseg, _pow_at_least(max(int(n[part].max()), 1), lo=32))
            pieces.append((torch.from_numpy(part).to(dev), W, Lp))
    return pieces


def plain_pieces_run(words, f, list_n, st, pieces, sentinel):
    """decode_rows_torch over each piece with `sentinel`: the plain
    version's work for the call."""
    from ds2i_torch.ops.decode import FIELDS, decode_rows_torch

    return [decode_rows_torch(words, *(f[k][idx] for k in FIELDS), list_n,
                              **dict(st, W=W, Lseg=Lseg, sentinel=sentinel))
            for idx, W, Lseg in pieces]


def plain_decode(words, f, list_n, st, pieces):
    """The call's output by decode_rows_torch, piece by piece: each piece
    decoded with the call's sentinel and with another, a slot it writes
    reads the same in both and every other slot its sentinel, so the
    pieces' writes merge into one sentinel-filled output."""
    import torch

    s0 = st["sentinel"]
    s1 = s0 - 1 if s0 > 0 else s0 + 1
    out = torch.full((st["rows"], st["L_out"]), s0, dtype=torch.int32, device=words.device)
    for a, b in zip(plain_pieces_run(words, f, list_n, st, pieces, s0),
                    plain_pieces_run(words, f, list_n, st, pieces, s1)):
        out = torch.where(a == b, a, out)
    return out


def segment_call(dindex, stream):
    """Every segment of one stream of a DeviceIndex as one decode_rows
    call into one flat output row (each list's values at its offset in
    the stream's postings order, as FlatQueryEngine lays them out): the
    call's words, fields and list_n on the index's device, its statics
    and the host segment table."""
    import torch

    from ds2i_torch.engine.device_index import _pow_at_least
    from ds2i_torch.ops.decode import FIELDS

    segs = dindex.docs_segs if stream == "docs" else dindex.freqs_segs
    lid = segs["list_id"]
    list_start = np.concatenate([[0], np.cumsum(dindex.list_n)])
    total = int(list_start[-1])
    fields = {k: segs[k] for k in FIELDS if k not in ("out_begin", "list_row")}
    fields["out_begin"] = list_start[lid] + segs["out_begin"]
    fields["list_row"] = np.zeros(len(lid), dtype=np.int64)
    words = ((segs["sel_start"] & 31) + segs["sel_len"] + 31) // 32
    dev = dindex.device
    t = {k: torch.from_numpy(np.ascontiguousarray(fields[k], dtype=np.int32)).to(dev)
         for k in FIELDS}
    statics = dict(W=_pow_at_least(int(words.max()), lo=4),
                   Lseg=_pow_at_least(int(segs["n_vals"].max()), lo=32),
                   rows=1, L_out=total, sentinel=dindex.num_docs if stream == "docs" else 0)
    w = dindex.docs_words if stream == "docs" else dindex.freqs_words
    list_n = torch.tensor([total], dtype=torch.int32, device=dev)
    return w, t, list_n, statics, segs


def segment_bytes(segs, statics):
    """The bytes one call over these segments must move on this run's data,
    each input read once and each output written once: per segment with
    values its nine fields, the window words its bits span (EF, strict EF
    and ranked-bitvector kinds) and the words its n_vals * l low bits span
    (EF kinds); the output rows written in full (the sentinel fill too)
    and their list_n."""
    from ds2i_torch.ops.segments import SEG_EF, SEG_EF_STRICT, SEG_RB

    n = np.minimum(segs["n_vals"], statics["Lseg"])
    real = n > 0
    kind = segs["kind"]
    high = real & np.isin(kind, (SEG_EF, SEG_EF_STRICT, SEG_RB)) & (segs["sel_len"] > 0)
    hw = np.where(high, ((segs["sel_start"] & 31) + segs["sel_len"] + 31) // 32, 0)
    lbits = n * segs["lower_bits"]
    low = real & np.isin(kind, (SEG_EF, SEG_EF_STRICT)) & (lbits > 0)
    lw = np.where(low, ((segs["lb_start"] & 31) + lbits + 31) // 32, 0)
    return (4 * (9 * int(real.sum()) + 2 * int((~real).sum()) + int(hw.sum()) + int(lw.sum()))
            + 4 * statics["rows"] * (statics["L_out"] + 1))


SEGMENT_STAGE_WORDS = 32  # csrc/segment_decode.cu kStageWords


def segment_staged(segs, statics):
    """(staged, ef): the EF-kind segments with values whose low bits K9
    stages a word a lane (their n*l bits span at most SEGMENT_STAGE_WORDS
    words), and all EF-kind segments with values."""
    from ds2i_torch.ops.segments import SEG_EF, SEG_EF_STRICT

    n = np.minimum(segs["n_vals"], statics["Lseg"]).astype(np.int64)
    l = segs["lower_bits"].astype(np.int64)
    ef = (n > 0) & np.isin(segs["kind"], (SEG_EF, SEG_EF_STRICT))
    nlw = ((segs["lb_start"].astype(np.int64) & 31) + n * l + 31) >> 5
    return int((ef & (l >= 0) & (nlw <= SEGMENT_STAGE_WORDS)).sum()), int(ef.sum())


def engine_calls(engines, queries):
    """The arguments of every decode_rows call one ranked_or over `queries`
    makes in each engine (cls -> [(args, statics), ...]): the engines'
    modules read decode_rows as a global, swapped for a recorder that
    passes each call on for the op."""
    from ds2i_torch.engine import executor, flat_executor
    from ds2i_torch.ops import decode

    real = decode.decode_rows
    calls = {}
    for cls, eng in engines.items():
        rec = calls[cls] = []

        def record(*args, **st):
            rec.append((args, st))
            return real(*args, **st)

        executor.decode_rows = flat_executor.decode_rows = record
        try:
            eng.ranked_or(queries, k=10)
        finally:
            executor.decode_rows = flat_executor.decode_rows = real
    return calls


def engine_call_phase(engines, queries, tag):
    """K9 against decode_rows_torch bit for bit on the calls the engines
    make: a seeded sample of GEN_REPLAY_CALLS of each engine's decode_rows
    calls over one ranked_or (QueryEngine's chunks of B*T+1 rows with pad
    rows and list_n, FlatQueryEngine's window buckets with sentinel -1),
    each call launched again and decoded by the plain version."""
    import torch

    from ds2i_torch.ops.decode import FIELDS, decode_rows

    rng = np.random.RandomState(GEN_REPLAY_SEED)
    for cls, calls in engine_calls(engines, queries).items():
        if not calls:
            raise AssertionError(f"{tag} {cls}: ranked_or made no decode_rows call")
        pick = np.sort(rng.choice(len(calls), size=min(GEN_REPLAY_CALLS, len(calls)),
                                  replace=False))
        shapes = set()
        for i in pick:
            args, st = calls[i]
            words, list_n = args[0], args[-1]
            f = dict(zip(FIELDS, args[1:-1]))
            got = decode_rows(*args, **st)
            exp = plain_decode(words, f, list_n, st, plain_pieces(f, st))
            if not torch.equal(got, exp):
                raise AssertionError(f"{tag} {cls}: segment_decode differs from decode_rows_torch "
                                     f"on call {i} ({st}): {int((got != exp).sum())} values")
            shapes.add((len(args[1]), st["W"], st["Lseg"], st["rows"], st["L_out"]))
        span = ", ".join(f"{k} {min(v)}-{max(v)}" for k, v in
                         zip(("R", "W", "Lseg", "rows", "L_out"), zip(*shapes)))
        log(f"{tag} {cls}: K9 segment_decode == decode_rows_torch bit for bit on {len(pick)} of "
            f"the {len(calls)} decode_rows calls of one ranked_or over {len(queries)} queries "
            f"(seeded sample; {span})")


def segment_kernel_phase(dindexes, engines, queries):
    """K9 (decode_rows, csrc/segment_decode.cu) over every docs segment and
    every freqs segment of each index, one launch each, against
    decode_rows_torch on the card bit for bit (plain_decode's pieces);
    on a sample of the calls QueryEngine and FlatQueryEngine make over one
    ranked_or (engine_call_phase: the whole log on `opt`, the oracle's
    queries on `ef`); 200 random lists of each index through DeviceIndex
    against the host decoder; the `opt` docs call timed through the
    wrapper, alone and plain, beside its bound by bytes. Returns K9's JSON
    entry (launches filled later)."""
    import torch

    from ds2i_torch.engine.device_index import _pow_at_least
    from ds2i_torch.ops.decode import FIELDS, decode_rows

    entry = None
    for name, dindex in dindexes.items():
        for stream in ("docs", "freqs"):
            w, f, list_n, st, segs = segment_call(dindex, stream)
            args = (w, *(f[k] for k in FIELDS), list_n)
            got = decode_rows(*args, **st)
            pieces = plain_pieces(f, st)
            exp = plain_decode(w, f, list_n, st, pieces)
            if not torch.equal(got, exp):
                raise AssertionError(f"segment_decode differs from decode_rows_torch on {name} "
                                     f"{stream}: {int((got != exp).sum())} values")
            staged, ef = segment_staged(segs, st)
            log(f"generations: K9 segment_decode == decode_rows_torch bit for bit on every {stream} "
                f"segment of {name} ({len(segs['kind'])} segments, {st['L_out']} values, one "
                f"launch; the plain version in {len(pieces)} pieces; W {st['W']}, Lseg "
                f"{st['Lseg']}); low bits staged a word a lane for {staged} of its {ef} EF "
                f"segments with values ({100.0 * staged / max(ef, 1):.2f}%)")
            if name == "opt" and stream == "docs":
                ms = cuda_ms(lambda: decode_rows(*args, **st))
                dev_ms = device_only_ms(lambda: decode_rows(*args, **st))
                plain_ms = cuda_ms(lambda: plain_pieces_run(w, f, list_n, st, pieces,
                                                            st["sentinel"]))
                nbytes = segment_bytes(segs, st)
                bound_ms, bound_by = bound(nbytes)
                log(f"generations: K9 over every opt docs segment: {ms:.4f} ms through the "
                    f"wrapper, {fmt_ms(dev_ms)} alone, plain PyTorch {plain_ms:.4f} ms (its "
                    f"{len(pieces)} piece calls; median of 5); bound {bound_ms:.4f} ms by "
                    f"{bound_by} ({nbytes} bytes)")
                entry = {"name": "segment_decode", "route": "cuda",
                         "source": "ds2i_torch/csrc/segment_decode.cu",
                         "replaces": "ds2i_tpu/ops/decode.py:33", "launches": None,
                         "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}  # no single PyTorch call decodes Elias-Fano
        engine_call_phase(engines[name], queries if name == "opt" else
                          queries[:GEN_ORACLE_QUERIES], f"generations {name}")
        # random lists against the host decoder
        index = dindex.index
        rng = np.random.RandomState(0)
        nonempty = np.flatnonzero(dindex.list_n > 0)
        lists = rng.choice(nonempty, size=min(GEN_RANDOM_LISTS, len(nonempty)), replace=False)
        L = _pow_at_least(dindex.max_list_len(lists), lo=32)
        docs = dindex.decode_docs(lists, L).cpu().numpy()
        cums = dindex.decode_freq_cums(lists, L).cpu().numpy()
        for row, li in enumerate(lists):
            hd, hf = index.decode_list(int(li))
            n = len(hd)
            if not (np.array_equal(docs[row, :n], hd) and np.all(docs[row, n:] == dindex.num_docs)
                    and np.array_equal(np.diff(cums[row, :n], prepend=0), hf)):
                raise AssertionError(f"{name} list {li}: DeviceIndex on the card differs from "
                                     f"index.decode_list")
        log(f"generations: {len(lists)} random {name} lists through DeviceIndex on the card equal "
            f"index.decode_list (docids, freqs from the cums)")
    return entry


def tile_group_bytes(gfields, groups):
    """The bytes K6g's launches over these groups must move on this run's
    data, both streams: per real row and stream the 10 field words it
    reads (all but F_PREV_CUM), the window words its F_WIN_LEN bits span
    (EF, strict EF and ranked-bitvector kinds), the words its n_vals * l
    low bits span (EF kinds) and its n_vals output slots; a pad row's kind
    and n_vals. The contract leaves a row's slots past n_vals undefined,
    so they, and a pad row's output, are not counted."""
    from ds2i_torch.engine.tiles import (
        F_KIND, F_LB_BITOFF, F_LOWER_BITS, F_NVALS, F_WIN_BITOFF, F_WIN_LEN, N_FIELDS, TILE,
    )
    from ds2i_torch.ops.segments import SEG_EF, SEG_EF_STRICT, SEG_RB

    nbytes = 0
    for off, R, _, _ in groups:
        for s in (0, N_FIELDS):
            f = gfields[off:off + R, s:s + N_FIELDS].astype(np.int64)
            n = f[:, F_NVALS]
            real = n > 0
            high = real & np.isin(f[:, F_KIND], (SEG_EF, SEG_EF_STRICT, SEG_RB)) & (f[:, F_WIN_LEN] > 0)
            hw = np.where(high, (f[:, F_WIN_BITOFF] + f[:, F_WIN_LEN] + 31) // 32, 0)
            lbits = n * f[:, F_LOWER_BITS]
            low = real & np.isin(f[:, F_KIND], (SEG_EF, SEG_EF_STRICT)) & (lbits > 0)
            lw = np.where(low, (f[:, F_LB_BITOFF] + lbits + 31) // 32, 0)
            nbytes += 4 * (10 * int(real.sum()) + 2 * int((~real).sum()) + int(hw.sum())
                           + int(lw.sum()) + int(np.minimum(n[real], TILE).sum()))
    return nbytes


TILE_CANARIES = (-0x5EED, 0x7EEDBEEF)


def tile_written(calls):
    """(slots K6g wrote, slots j < n_vals) over `calls` (words, fields, W,
    WL): each call decoded twice into outputs filled with one of two
    patterns; a slot was written where it differs from its pattern in
    either (a written value cannot equal both)."""
    import torch

    from ds2i_torch.engine.tiles import F_NVALS, TILE
    from ds2i_torch.ops.pair_decode import decode_group

    written = valid = 0
    for words, fld, W, WL in calls:
        bufs = [torch.full((fld.shape[0], TILE), c, dtype=torch.int32, device=fld.device)
                for c in TILE_CANARIES]
        for buf in bufs:
            decode_group(words, fld, W, WL, out=buf)
        written += int(((bufs[0] != TILE_CANARIES[0]) | (bufs[1] != TILE_CANARIES[1])).sum())
        valid += int(torch.clamp(fld[:, F_NVALS], 0, TILE).sum())
    return written, valid


def tile_kernel_phase(eng):
    """K6g (decode_group, csrc/tile_decode.cu) on every group of the tile
    engine's layout over every list of its index (each list a one-term
    query), both streams, against _decode_stream on the card on the slots
    j < n_vals; all groups' launches timed through the wrapper, alone and
    plain, beside their bound by bytes, and the bytes they write counted
    (tile_written: exactly the n_vals slots, none past them, none in a pad
    row). Returns K6g's JSON entry."""
    import torch

    from ds2i_torch.engine.tiles import F_NVALS, N_FIELDS, TILE
    from ds2i_torch.ops.pair_decode import _decode_stream, decode_group

    d = eng.dindex
    nl = d.num_lists
    groups, gfields = eng._build_batch(np.arange(nl), np.ones(nl, np.float32),
                                       np.ones(nl, np.int64))[:2]
    g_dev = torch.from_numpy(gfields).to(eng.device)
    calls = [(words, g_dev[off:off + R, s:s + N_FIELDS].contiguous(), W, WL)
             for off, R, W, WL in groups
             for s, words in ((0, d.docs_words), (N_FIELDS, d.freqs_words))]
    slots = 0
    for words, fld, W, WL in calls:
        got = decode_group(words, fld, W, WL)
        exp = _decode_stream(words, fld, W, WL, TILE).to(torch.int32)
        valid = torch.arange(TILE, device=eng.device)[None, :] < fld[:, F_NVALS, None]
        slots += int(valid.sum())
        if not torch.equal(got[valid], exp[valid]):
            raise AssertionError(f"tile_decode differs from _decode_stream on group (W {W}, WL "
                                 f"{WL}): {int((got[valid] != exp[valid]).sum())} slots")
    log(f"generations: K6g tile_decode == _decode_stream on every group of the opt tile layout "
        f"({len(groups)} groups x 2 streams, {len(gfields)} rows, {slots} valid slots) "
        f"[(W, WL) x rows: {', '.join(f'({W}, {WL})x{R}' for _, R, W, WL in groups)}]")

    def run():
        for c in calls:
            decode_group(*c)

    def plain():
        for words, fld, W, WL in calls:
            _decode_stream(words, fld, W, WL, TILE)

    ms = cuda_ms(run)
    dev_ms = device_only_ms(run)
    plain_ms = cuda_ms(plain)
    nbytes = tile_group_bytes(gfields, groups)
    bound_ms, bound_by = bound(nbytes)
    written, valid = tile_written(calls)
    if written != valid:
        raise AssertionError(f"tile_decode wrote {written} slots where the contract defines "
                             f"{valid}")
    log(f"generations: K6g over every opt tile, {len(calls)} launches: {ms:.4f} ms through the "
        f"wrapper, {fmt_ms(dev_ms)} alone, plain PyTorch {plain_ms:.4f} ms (median of 5); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes} bytes); it wrote {4 * written} bytes "
        f"({written} slots, all j < n_vals: none past them, none in a pad row) of the bound's "
        f"{4 * valid} bytes of output")
    return {"name": "tile_decode", "route": "cuda", "source": "ds2i_torch/csrc/tile_decode.cu",
            "replaces": "ds2i_tpu/engine/tile_executor.py:61", "launches": None,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None}  # no single PyTorch call decodes Elias-Fano


def generation_runs(engines, queries, exact, tag):
    """Each engine's and_counts, or_counts, ranked_and and ranked_or over
    `queries` against `exact` (the exhaustive ResidentEngine's): counts
    exact, top-10 within rtol RTOL query by query; seconds and µs/query of
    each op."""
    from ds2i_torch.ops import decode, pair_decode

    for cls, eng in engines.items():
        n9, n6 = decode.decode_rows.launches, pair_decode.decode_group.launches
        secs = {}
        got = {}
        for op in ("and_counts", "or_counts", "ranked_and", "ranked_or"):
            t = time.perf_counter()
            got[op] = getattr(eng, op)(queries) if op.endswith("counts") else \
                getattr(eng, op)(queries, k=10)
            secs[op] = time.perf_counter() - t
        for op in ("and_counts", "or_counts"):
            if not np.array_equal(np.asarray(got[op]), np.asarray(exact[op])):
                bad = np.flatnonzero(np.asarray(got[op]) != np.asarray(exact[op]))
                raise AssertionError(f"{tag} {cls}: {op} differs from the exhaustive "
                                     f"ResidentEngine's on queries {bad[:10].tolist()}")
        for op in ("ranked_and", "ranked_or"):
            bad = topk_mismatches(got[op], exact[op])
            if bad:
                raise AssertionError(f"{tag} {cls}: {op} differs from the exhaustive "
                                     f"ResidentEngine's on queries {bad[:10]}")
        log(f"{tag} {cls}: and_counts and or_counts exact, ranked_and and ranked_or top-10 within "
            f"rtol {RTOL} of the exhaustive ResidentEngine on all {len(queries)} queries; seconds "
            f"{ {op: round(s, 3) for op, s in secs.items()} }, us/query "
            f"{ {op: round(s / len(queries) * 1e6, 3) for op, s in secs.items()} }; launches "
            f"K9 {decode.decode_rows.launches - n9}, K6g "
            f"{pair_decode.decode_group.launches - n6}")


def plane_batch(num_docs, B=16, T=4, L=512):
    """A seeded (docs, freqs, qw, norm_lens) batch for the sharded plane:
    sorted docids from pools that overlap (so AND matches exist), pads
    num_docs, a third of the term slots empty (qw 0)."""
    rng = np.random.RandomState(PLANE_SEED)
    docs = np.full((B, T, L), num_docs, dtype=np.int32)
    freqs = np.zeros((B, T, L), dtype=np.int32)
    qw = rng.uniform(0.5, 3.0, size=(B, T)).astype(np.float32)
    qw[rng.rand(B, T) < 0.3] = 0.0
    for b in range(B):
        for t in range(T):
            n = rng.randint(L // 4, L + 1)
            docs[b, t, :n] = np.sort(rng.choice(min(num_docs, 2 * L + 97 * t), n, replace=False))
            freqs[b, t, :n] = rng.randint(1, 20, n)
    return docs, freqs, qw, rng.uniform(0.3, 2.5, num_docs).astype(np.float32)


def plane_phase(num_docs):
    """make_sharded_plane_step on a (1, 1) mesh of cuda:0 and a (2, 2) grid
    of cuda:0 against the port's own run on a CPU mesh, on one seeded
    batch: counts exact, top-10 within rtol RTOL (scatter-add order)."""
    import torch

    from ds2i_torch.parallel.sharded_engine import make_mesh, make_sharded_plane_step

    batch = plane_batch(num_docs)
    cpu = [x.numpy() for x in make_sharded_plane_step(
        make_mesh([torch.device("cpu")] * 4, dp=2, tp=2), num_docs, 10)(*batch)]
    if not (cpu[0] > 0).any():
        raise AssertionError("the plane's seeded batch has no AND match")
    for shape in ((1, 1), (2, 2)):
        t = time.perf_counter()
        mesh = make_mesh([torch.device("cuda", 0)] * (shape[0] * shape[1]), *shape)
        got = [x.cpu().numpy() for x in make_sharded_plane_step(mesh, num_docs, 10)(*batch)]
        for g, c, what in zip(got, cpu, ("and_counts", "or_counts", "topk_or", "topk_and")):
            fin = np.isfinite(c)
            if what.endswith("counts"):
                ok = np.array_equal(g, c)
            else:
                ok = np.array_equal(np.isfinite(g), fin) and np.allclose(g[fin], c[fin], rtol=RTOL,
                                                                         atol=0)
            if not ok:
                raise AssertionError(f"sharded plane {shape}: {what} differs from the CPU mesh's")
        log(f"generations: sharded plane on a {shape} mesh of cuda:0 equals the CPU mesh's "
            f"(batch {batch[0].shape}, num_docs {num_docs}: counts exact, top-10 within rtol "
            f"{RTOL}; {time.perf_counter() - t:.2f} s)")


def generations_phase(coll, wdata, queries, opt_index, exact):
    """The JAX package's three earlier engine generations, DeviceIndex and
    the mesh plane, ported (every count set to 0 just before it): K9 and
    K6g against their plain versions (segment_kernel_phase, with a sample
    of the calls QueryEngine and FlatQueryEngine make; tile_kernel_phase);
    then the path, its counts set to 0 again just
    before it: QueryEngine, FlatQueryEngine and TileQueryEngine over one
    DeviceIndex of the 1x `opt` index on the card, the whole log, against
    `exact` (the exhaustive ResidentEngine's and_counts, or_counts,
    ranked_and and ranked_or); the same engines over the 1x `ef` index on
    300 queries against the oracle; then the sharded plane. Returns the
    JSON entries of K9 and K6g, their launches those of the engines'
    runs. Prints each kernel's registers, local and shared bytes once
    (kernels.attributes), and K9's share of EF segments whose low bits it
    stages a word a lane (segment_staged)."""
    import torch

    from ds2i_torch import kernels
    from ds2i_torch.engine import DeviceIndex, FlatQueryEngine, QueryEngine, TileQueryEngine
    from ds2i_torch.ops import decode, pair_decode

    for w in kernel_wrappers():
        w.launches = 0
    t_phase = time.perf_counter()
    ef_index = build_index(coll, "ef")
    t0 = time.perf_counter()
    dindexes = {"opt": DeviceIndex(opt_index), "ef": DeviceIndex(ef_index)}
    tile = TileQueryEngine(dindexes["opt"], wdata)
    torch.cuda.synchronize()
    log(f"generations: DeviceIndex of opt and ef, the opt tile tables "
        f"({time.perf_counter() - t0:.1f} s)")
    segment_engines = {name: {"QueryEngine": QueryEngine(d, wdata),
                              "FlatQueryEngine": FlatQueryEngine(d, wdata)}
                       for name, d in dindexes.items()}
    for name in kernels.ATTRIBUTES:
        a = kernels.attributes(name)
        log(f"generations: csrc/{name}.cu kernel: {a['registers']} registers a thread, "
            f"{a['local_bytes']} B local (spilled) a thread, {a['shared_bytes']} B static shared "
            f"a block (cudaFuncGetAttributes)")
    seg_entry = segment_kernel_phase(dindexes, segment_engines, queries)
    tile_entry = tile_kernel_phase(tile)
    log(f"generations: launches of the kernel checks: "
        f"{ {w.__name__: w.launches for w in kernel_wrappers() if w.launches} }")

    for w in kernel_wrappers():
        w.launches = 0
    t0 = time.perf_counter()
    engines = dict(segment_engines["opt"], TileQueryEngine=tile)
    generation_runs(engines, queries, exact, "generations opt")
    for cls, make in (("QueryEngine", QueryEngine), ("FlatQueryEngine", FlatQueryEngine),
                      ("TileQueryEngine", TileQueryEngine)):
        oracle_phase(make(dindexes["ef"], wdata), ef_index, wdata, queries, GEN_ORACLE_QUERIES,
                     f"generations ef {cls}")
    counts = {w.__name__: w.launches for w in kernel_wrappers()}
    log(f"generations: the engines' runs {time.perf_counter() - t0:.1f} s; launches {counts}")
    for entry, w in ((seg_entry, decode.decode_rows), (tile_entry, pair_decode.decode_group)):
        if w.launches <= 0:
            raise AssertionError(f"the generations path never launched the CUDA {w.__name__}")
        entry["launches"] = w.launches
    plane_phase(opt_index.num_docs())
    log(f"generations phase: {time.perf_counter() - t_phase:.1f} s")
    return [seg_entry, tile_entry]


WSDM_FRACTION = 0.05  # of the lists profile_decoding samples


def wsdm_tools(f, base, budget):
    """The WSDM'15 chain's tools, in three waves (each needs the one
    before): profile_queries (ranked_and over the log, closed form) and
    profile_decoding --engine resident on the card; dec_time_regression
    on the device profile; optimal_hybrid_index --check with a space
    budget of the block_optpfor index's bytes."""
    idx = ["block_optpfor"]
    return (
        {"profile_queries": ["profile_queries", *idx, "ranked_and", f("idx.bin"), f("wand.bin"),
                             "--queries", base + ".queries", "--out", f("blockstats.tsv")],
         "profile_decoding --engine resident": [
             "profile_decoding", *idx, f("idx.bin"), WSDM_FRACTION, "--out", f("prof.jsonl"),
             "--engine", "resident"]},
        {"dec_time_regression": ["dec_time_regression", f("prof.jsonl"), "--out",
                                 f("weights.tsv")]},
        {"optimal_hybrid_index --check": [
            "optimal_hybrid_index", *idx, f("weights.tsv"), f("blockstats.tsv"), f("idx.bin"),
            f("lambdas.bin"), budget, f("mixed.bin"), "--check", base]},
    )


def wsdm_phase(index, wdata, queries, exact_and, beside):
    """The WSDM'15 tool chain on the card, each tool in its own process
    as a user runs it (wsdm_tools), over the block_optpfor index and the
    wand data saved by the port's tools.common; files under
    build/ds2i_wsdm/, removed after. Beside the first wave, the closed
    form of the block stats in this process (profile_queries.fast_profile,
    its dump byte-equal to the tool's file); beside the third, the long
    pole (rebuild_mixed and the collection check in Python), `beside()`.
    Then the hybrid the chain built, loaded back and served by a
    ResidentEngine on the card: exhaustive ranked_and over the whole log
    equal to block_optpfor's (exact_and) query by query, its kernels'
    launches counted. profile_decoding's stats line must show K1s
    launched."""
    import io
    import shutil

    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.tools.common import load_index, save_index, save_wand_data
    from ds2i_torch.tools.profile_queries import fast_profile

    t_phase = time.perf_counter()
    out = os.path.join(HERE, "build", "ds2i_wsdm")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    f = lambda name: os.path.join(out, name)  # noqa: E731
    save_index(index, f("idx.bin"))
    save_wand_data(wdata, f("wand.bin"))
    waves = wsdm_tools(f, collection_base(), len(index.lists))
    tools = Tools(tag="wsdm")
    seconds = {}
    try:
        wave = tools.start(waves[0])
        expected = io.StringIO()
        fast_profile(index, queries, 1).dump(expected)
        done = Tools.wait(wave)
        if open(f("blockstats.tsv")).read() != expected.getvalue():
            raise AssertionError("profile_queries' block stats differ from fast_profile's")
        (prof,) = done["profile_decoding --engine resident"][1]
        if prof.get("launches", {}).get("optpfor_s16_decode", 0) <= 0 or prof["groups"] <= 0:
            raise AssertionError(f"profile_decoding timed no K1s group: {prof}")
        nrec = sum(1 for _ in open(f("prof.jsonl")))
        log(f"wsdm: profile_queries == fast_profile ({len(expected.getvalue())} bytes); "
            f"profile_decoding: {nrec} records, {prof['groups']} groups timed on the card "
            f"{prof['groups_by_kernel']}, launches {prof['launches']}")
        seconds.update({k: v[0] for k, v in done.items()})
        done = Tools.wait(tools.start(waves[1]))
        seconds.update({k: v[0] for k, v in done.items()})
        log(f"wsdm: weights {open(f('weights.tsv')).read().splitlines()}")
        wave = tools.start(waves[2])
        t_beside = time.perf_counter()
        beside()
        t_beside = time.perf_counter() - t_beside
        done = Tools.wait(wave)
        seconds.update({k: v[0] for k, v in done.items()})
        lines = done["optimal_hybrid_index --check"][1]
        if not any(x.get("type") == "block_mixed" and x.get("size", 0) > 0 for x in lines):
            raise AssertionError(f"optimal_hybrid_index printed no block_mixed size: {lines}")
        mixed = load_index(f("mixed.bin"), "block_mixed")
    finally:
        tools.kill()
        shutil.rmtree(out, ignore_errors=True)
    log(f"wsdm: each tool's seconds from its wave's start to its exit "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }; beside the third wave "
        f"{t_beside:.1f} s of this process's work")
    counts = {w: w.launches for w in kernel_wrappers()}
    t0 = time.perf_counter()
    eng = start_engine(mixed, wdata)
    kinds = sorted({st[0] for st in eng.group_statics_d + eng.group_statics_f})
    got = eng.ranked_and(queries, k=10)
    bad = topk_mismatches(got, exact_and)
    if bad:
        raise AssertionError(f"wsdm: the hybrid's ranked_and differs from block_optpfor's on "
                             f"queries {bad[:10]}")
    launched = {w.__name__: w.launches - n for w, n in counts.items() if w.launches > n}
    log(f"wsdm: the hybrid ({len(mixed.lists)} bytes against block_optpfor's "
        f"{len(index.lists)}; group kinds {kinds}) served on the card: exhaustive ranked_and "
        f"equal to block_optpfor's on all {len(queries)} queries (equal lengths, rtol {RTOL}); "
        f"launches {launched} ({time.perf_counter() - t0:.1f} s)")
    log(f"wsdm phase: {time.perf_counter() - t_phase:.1f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    plan, _ = main_path(eng, queries, [(pair_entry, pair_decode.decode_pair)], "opt")
    pair_part_phase(eng, plan)
    oracle_phase(eng, index, wdata, queries, ORACLE_QUERIES, "opt")
    opt_prune_phase(eng, queries)
    exact = {op: getattr(eng, op)(queries) for op in ("and_counts", "or_counts")}
    exact.update({op: getattr(eng, op)(queries, k=10) for op in ("ranked_and", "ranked_or")})
    del eng
    torch.cuda.empty_cache()

    # the earlier engine generations over DeviceIndex, K9 and K6g, the mesh plane
    gen_entries = generations_phase(coll, wdata, queries, index, exact)
    del exact
    torch.cuda.empty_cache()

    # block_optpfor path: split mode, then and_skip, bench.py's default path
    block_entries = []
    join_entry = {"name": "join", "route": "cuda", "source": "ds2i_torch/csrc/join.cu",
                  "replaces": "ds2i_tpu/engine/resident.py:527"}
    opt_index = build_index(coll, "block_optpfor")
    eng, plan, res, wrappers = block_path(opt_index, wdata, queries, block_entries,
                                          "block_optpfor", join_entry)
    bm_entry = {"name": "blockmax", "route": "cuda", "source": "ds2i_torch/csrc/blockmax.cu",
                "replaces": "ds2i_tpu/engine/resident.py:358"}
    dec, _, skip_res = and_skip_path(eng, opt_index, coll, wdata, queries, plan, res,
                                     "block_optpfor", wrappers, entry=bm_entry)
    blockmax_phase(eng, dec, coll, bm_entry)
    del dec
    exact_and = [eng._topk_list(r[3]) for r in res]

    # block_optpfor past its resident word limit: the exceptions decoded
    # in the pass (K1s), against the patched engine above
    inpass_path(opt_index, coll, wdata, queries, block_entries, eng, plan, res, skip_res)
    del eng, plan, res, skip_res
    torch.cuda.empty_cache()

    # block_interpolative: oracle only
    index = build_index(coll, "block_interpolative")
    eng = start_engine(index, wdata)
    n0 = block_decode.interp_decode.launches
    oracle_phase(eng, index, wdata, queries, INTERP_ORACLE_QUERIES, "block_interpolative")
    if block_decode.interp_decode.launches <= n0:
        raise AssertionError("the block_interpolative run never launched the CUDA interp_decode")
    del eng

    # block_varint, block_qmx and block_mixed (rebuilt from block_optpfor)
    for name in ("block_varint", "block_qmx", "block_mixed"):
        index = build_mixed_index(opt_index) if name == "block_mixed" else build_index(coll, name)
        eng, plan, res, wrappers = block_path(index, wdata, queries, block_entries, name)
        kinds = {st[0] for st in eng.group_statics_d + eng.group_statics_f}
        log(f"{name}: group kinds {sorted(kinds)}")
        if name == "block_mixed" and not {"optp", "var", "interp"} <= kinds:
            raise AssertionError(f"block_mixed lacks OptPFor blocks with exceptions, Varint-G8IU "
                                 f"or interpolative blocks: {sorted(kinds)}")
        and_skip_path(eng, index, coll, wdata, queries, plan, res, name, wrappers,
                      second_engine=name != "block_varint")
        del eng, plan, res
        torch.cuda.empty_cache()

    by_name = {e["name"]: e for e in block_entries}
    order = ("optpfor_decode", "optpfor_s16_decode", "varint_decode", "qmx_decode",
             "interp_decode")
    if sorted(by_name) != sorted(order):
        raise AssertionError(f"block kernels timed: {sorted(by_name)}, expected {sorted(order)}")
    entries = [pair_entry, *(by_name[n] for n in order), bm_entry, join_entry, *gen_entries]

    # the WSDM'15 tool chain, its long pole (optimal_hybrid_index) beside
    # the front door: the tools, a doc-sharded engine, make_engine,
    # replicas and cache_dir over the block_optpfor index
    wsdm_phase(opt_index, wdata, queries, exact_and,
               beside=lambda: front_door_phase(coll, wdata, queries, opt_index, entries))
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
