"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell is a configuration (a deployment:
its collection, index type and scale, configs/<name>.json) under a
traffic mix (traffic/<name>.json). The harness drives the port's
serving path, `ds2i_torch.engine.make_engine`, in a closed loop with one
client: each batch is a fresh draw of queries from the seed's stream
(stream.py), sent through `prepare` and then `execute`'s two halves,
`dispatch` and `collect`; the next batch goes once the last one's
results are in hand. No plan is replayed.

Set-up (setup_s: process start to the first timed batch, less the cold
build) loads the configuration's built files, or builds them in a
checkout's first run (deploy.py, timed apart), opens the engine, sends
the mix's warm-up batches from another part of the stream, and draws
the window's queries ahead, as many as the warm-up's pace would answer
in the window and a quarter more. The window then runs for --seconds;
the client's work in it is a slice of those queries a batch and the
sample's copies. With --trace 1 torch.profiler records it, and the
device is synchronised before each `collect`, so that collect's host
time is its unpack alone.

Every metric is a file of its own under metrics/, `read(run)` over the
window's record (`Run`), found by the names BENCHMARK.json lists for the
cell: its end_to_end metrics with --trace 0, its per_layer ones with
--trace 1. A reader that finds nothing to read returns None, and the
metric is left out.

After the window the engine is freed and a sample of the answers drawn
from the seed (a reservoir over every answered query, and the heaviest
queries) is compared with the plain reference (reference.py), which
decides `correct`: ranked AND answers against `Reference.ranked_and`,
ranked OR answers (WAND, with the mix's `prune`) against
`Reference.ranked_or`. A mix whose `ops` neither judges exits before
the cell is built. The numbers compared and their limits end standard
error and the result line, which is the last line of standard output.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and
3 when jax, jaxlib, flax or ds2i_tpu is loaded once the window has
closed.
"""

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

BANNED = frozenset({"jax", "jaxlib", "flax", "ds2i_tpu"})
# the sample that the comparison (reference.LIMITS) judges: a reservoir of
# RESERVOIR answered queries, and the HEAVIEST heaviest of the batches'
# heaviest queries
RESERVOIR, HEAVIEST = 1500, 100
# the window's queries drawn in set-up: the warm-up's pace times this
PREFETCH_MARGIN = 1.25
# a traffic mix's ops: (the slot of ResidentEngine.collect's result tuple
# that holds a query's top-k scores, the reference.Reference method that
# answers the same query)
JUDGED = {("and",): (3, "ranked_and"), ("or",): (2, "ranked_or")}


def process_start():
    """The wall-clock time this process started (to 10 ms), from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def banned_modules(modules=None):
    """The top-level names in `modules` (sys.modules) that the port must
    not load, compared whole: ds2i_torch is not ds2i_tpu."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & BANNED)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench, name):
    """(cell, configuration entry, metric entries for --trace 0, for
    --trace 1) of BENCHMARK.json's cell `name`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return cell, cfg, e2e, layer


def metric_reader(name, here=HERE):
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a window leaves for the metric readers: per batch, its
    queries and the host seconds of prepare, dispatch, the traced run's
    synchronise, and collect; the window's length, the set-up's, the
    trace's reading, and the configuration's list sizes."""

    def __init__(self, cfg, traffic, lens, list_bytes):
        self.config, self.traffic = cfg, traffic
        self.lens, self.list_bytes = lens, list_bytes
        self.sizes, self.prepare_s, self.dispatch_s, self.sync_s, self.collect_s = [], [], [], [], []
        self.batch_terms = []  # the distinct terms of each batch (traced runs)
        self.seconds = self.setup_s = 0.0
        self.trace = None

    @property
    def queries(self):
        return sum(self.sizes)

    @property
    def batch_ms(self):
        return [(p + d + s + c) * 1e3 for p, d, s, c in
                zip(self.prepare_s, self.dispatch_s, self.sync_s, self.collect_s)]


def smi():
    """The card's name, power limit and clocks (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def host_probe():
    """The host's state beside a run, for the set-up log line:
    milliseconds of a fixed piece of interpreter work, and the seconds
    this process has waited for a CPU so far (/proc/self/schedstat)."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    out = {"probe_ms": (time.perf_counter() - t) * 1e3}
    try:
        with open("/proc/self/schedstat") as f:
            out["wait_s"] = int(f.read().split()[1]) * 1e-9
    except (OSError, ValueError, IndexError):
        pass
    return out


def io_bytes():
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (line.split(":") for line in f)}
    except OSError:
        return {}


class Sampler:
    """The answers a run compares, drawn from the seed: a reservoir of R
    slots over every answered query (Algorithm R: query i takes slot i
    while i < R, else slot floor(u_i * (i + 1)) where that is below R,
    u_i the stream's draw) and the n_heavy heaviest among each batch's
    heaviest query."""

    def __init__(self, R, n_heavy):
        self.R, self.n_heavy = R, n_heavy
        self.reservoir = [(-1, None, None)] * R
        self.heavy = []

    def add(self, pos, qs, work, u, answers):
        """A batch of queries [pos, pos + len(qs)) and their answers
        (answers(i): the i-th query's)."""
        import numpy as np

        idx = np.arange(pos, pos + len(qs))
        slot = np.where(idx < self.R, idx, (u * (idx + 1)).astype(np.int64))
        for h in np.nonzero(slot < self.R)[0].tolist():
            self.reservoir[slot[h]] = (pos + h, qs[h], answers(h))
        h = int(np.argmax(work))
        self.heavy.append((int(work[h]), pos + h, qs[h], answers(h)))

    def picks(self):
        """[(query, answer)], each query once, in stream order."""
        picked = {pos: (terms, got) for pos, terms, got in self.reservoir if pos >= 0}
        for _, pos, terms, got in sorted(self.heavy, key=lambda x: (-x[0], x[1]))[:self.n_heavy]:
            picked[pos] = (terms, got)
        return [picked[p] for p in sorted(picked)]


def resolve(name, trace, root=ROOT):
    """(cell, configuration file, configuration, traffic mix, [(metric
    entry, reader)]) of cell `name`, found by name in `root`'s
    BENCHMARK.json and the benchmark's folder there."""
    here = os.path.join(root, os.path.relpath(HERE, ROOT))
    cell, cfg_entry, e2e, layer = cell_spec(load_json(root, "BENCHMARK.json"), name)
    cfg = load_json(root, cfg_entry["file"])
    traffic = load_json(here, "traffic", f"{cell['traffic']}.json")
    metrics = [(m, metric_reader(m["name"], here)) for m in (layer if trace else e2e)]
    return cell, cfg_entry["file"], cfg, traffic, metrics


def judged_by(cell, traffic):
    """(answer slot, reference method) of a cell's traffic mix (JUDGED);
    exits naming the traffic file where its ops cannot be judged."""
    got = JUDGED.get(tuple(traffic["ops"]))
    if got is None:
        raise SystemExit(f"run.py: traffic/{cell['traffic']}.json: ops {traffic['ops']!r} "
                         f"cannot be judged; the reference answers {[list(o) for o in JUDGED]}")
    return got


def run_cell(name, seed, seconds, trace, device="cuda", root=ROOT, log=None, engine_hook=None):
    """One run of cell `name` of the checkout at `root`; returns (result
    dict, checks), or (None, None) when the window loaded a banned
    module. engine_hook, for the tests: called with the opened engine,
    may replace it."""
    import numpy as np
    import torch

    import corpus
    import deploy
    import reference
    import stream as stream_mod
    import timeline

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell, cfg_file, cfg, traffic, metrics = resolve(name, trace, root)
    slot, method = judged_by(cell, traffic)
    cuda = device != "cpu"

    path, cold, build_s = deploy.ensure(root, cfg_file, device, log)
    coll = corpus.Collection(os.path.join(path, "coll"))
    run = Run(cfg, traffic, coll.lens, np.load(os.path.join(path, "list_bytes.npy")))
    cache_dir = deploy.run_cache_dir(path)
    try:
        eng = deploy.open_engine(path, device, cache_dir)
        if engine_hook is not None:
            eng = engine_hook(eng) or eng
        k, B = cfg["k"], traffic["batch"]
        ops, prune = tuple(traffic["ops"]), traffic["prune"]
        warm = stream_mod.Stream(coll.lens, seed, *stream_mod.law(traffic), stream_mod.WARMUP)
        took = []
        for i in range(traffic["warmup_batches"]):
            qs = warm.batch(i * B, B)[0]
            t0 = time.perf_counter()
            eng.execute(eng.prepare(qs, k=k, ops=ops, prune=prune))
            took.append(time.perf_counter() - t0)
        del warm
        if cuda:
            torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() if cuda else 0
        stream = stream_mod.Stream(coll.lens, seed, *stream_mod.law(traffic))
        stream.prefetch(planned_queries(took, seconds, B))
        sampler = Sampler(RESERVOIR, HEAVIEST)
        failed = 0
        span = torch.profiler.record_function if trace else (lambda _: contextlib.nullcontext())
        prof = contextlib.nullcontext()
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        sync = torch.cuda.synchronize if (trace and cuda) else (lambda: None)
        # what set-up left in memory is never garbage: the collector stops
        # scanning it, so the window's collections cost what the window's
        # own objects cost
        gc.collect()
        gc.freeze()
        probe = [host_probe()]
        run.setup_s = time.time() - T_START - build_s
        with prof:
            with span("window"):
                t_start = time.perf_counter()
                deadline = t_start + seconds
                pos = 0
                while True:
                    qs, work, u = stream.batch(pos, B)
                    t0 = time.perf_counter()
                    with span("prepare"):
                        plan = eng.prepare(qs, k=k, ops=ops, prune=prune)
                    t1 = time.perf_counter()
                    with span("dispatch"):
                        pending = eng.dispatch(plan)
                    t2 = time.perf_counter()
                    with span("sync"):
                        sync()
                    t3 = time.perf_counter()
                    with span("collect"):
                        res = eng.collect(plan, pending)
                    t4 = time.perf_counter()
                    run.sizes.append(B)
                    run.prepare_s.append(t1 - t0)
                    run.dispatch_s.append(t2 - t1)
                    run.sync_s.append(t3 - t2)
                    run.collect_s.append(t4 - t3)
                    if len(res) != B:
                        res = list(res)[:B] + [None] * max(B - len(res), 0)
                    failed += res.count(None)
                    sampler.add(pos, qs, work, u, lambda i: _answer(res[i], slot))
                    pos += B
                    if t4 >= deadline:
                        break
                run.seconds = t4 - t_start
            if cuda:
                torch.cuda.synchronize()
        probe.append(host_probe())
        found = banned_modules()
        if found:
            log(f"run.py: the window loaded {', '.join(found)}")
            return None, None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if trace:
            run.batch_terms = [np.unique(stream.terms(p, B)) for p in range(0, pos, B)]
            tpath = os.path.join(cache_dir, "window_trace.json")
            prof.export_chrome_trace(tpath)
            run.trace = timeline.analyse(tpath)
        del eng, plan, pending, res, prof
        gc.unfreeze()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)

    t_ref = time.perf_counter()
    sample = sampler.picks()
    ref = reference.Reference(coll, cfg["bm25_k1"], cfg["bm25_b"])
    answer = getattr(ref, method)
    checks = reference.judge([g for _, g in sample], [answer(t, k) for t, _ in sample])
    correct = reference.passes(checks)

    values = {m["name"]: (m, read(run)) for m, read in metrics}
    out = {
        "correct": correct,
        "attempted": run.queries,
        "failed": failed,
        "metrics": {n: {"value": v, "unit": m["unit"]} for n, (m, v) in values.items()
                    if v is not None},
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = timeline.breakdown(run.trace)
    out["compared"] = len(sample)
    out["checks"] = {n: {"value": v, "limit": reference.LIMITS[n]} for n, v in checks.items()}
    io = io_bytes()
    log("setup " + json.dumps({
        "cell": name, "seed": seed, "trace": int(trace), "card": smi() if cuda else None,
        "setup": "cold" if cold else "warm", "cold": cold, "cold_build_s": build_s,
        "setup_s": run.setup_s, "warmup_batch_s": took, "prefetched": len(stream.chunks) - stream.late,
        "late_chunks": stream.late, "batches": len(run.sizes), "window_s": run.seconds, "queries": run.queries,
        "host_us_per_query": {n: sum(getattr(run, n + "_s")) / max(run.queries, 1) * 1e6
                              for n in ("prepare", "dispatch", "sync", "collect")},
        "host": probe, "resident_bytes": int(resident), "memory_peak_bytes": int(peak),
        "wchar": io.get("wchar"), "write_bytes": io.get("write_bytes"),
        "reference_s": time.perf_counter() - t_ref}))
    return out, checks


def planned_queries(took, seconds, B):
    """The queries to draw ahead of a window of `seconds`: what the
    later half of the warm-up batches' pace (seconds a batch, `took`)
    answers in it, PREFETCH_MARGIN times over."""
    later = sorted(took[len(took) // 2:]) or [1.0]
    pace = max(later[len(later) // 2], 1e-4)
    return (int(PREFETCH_MARGIN * seconds / pace) + 1) * B


def _answer(r, slot):
    """The scores in `slot` of one result tuple (JUDGED), copied out of
    the download buffer; None for a result that did not come."""
    import numpy as np

    if r is None:
        return None
    try:
        return np.array(r[slot], dtype=np.float32)
    except (TypeError, IndexError, ValueError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with few threads: the host path is single-threaded
    # numpy and enqueues, and idle pools only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # the kernel caches live in the checkout, at fixed paths (the port's
    # own nvcc builds go to build/ds2i_torch/ there)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "benchmark", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "benchmark", "triton")
    import torch

    chips = {w["name"]: w["chips"] for w in load_json(ROOT, "BENCHMARK.json")["workloads"]}
    need = chips.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"run.py: needs {need} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if out is None:
        return 3
    for n, c in checks.items():
        print(f"check {n} {c!r} limit {__import__('reference').LIMITS[n]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
