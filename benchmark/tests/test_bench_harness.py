"""The harness driven on the CPU at a tiny size: discovery of cells by
name, the no-JAX check, the roofline's byte count, the per-run engine
state, set-up time without cold builds (a transformed configuration's
chain too), and `correct` against the control and planted faults."""

import ast
import glob
import json
import os

import numpy as np
import pytest

import control
import deploy
import reference
import run
from conftest import BENCH, CELLS, make_root

PRUNED = "tiny_block.and_skip-b1024"
EXHAUSTIVE = "tiny_opt.and-b1024"
WAND = "tiny_block.wand-b1024"
MIXED = "tiny_mixed.and-b1024"


def test_banned_modules_by_whole_top_level_name():
    assert run.banned_modules({"ds2i_torch", "ds2i_torch.engine", "jaxtyping", "flaxen"}) == []
    assert run.banned_modules({"jax.numpy", "ds2i_tpu.ops.decode", "flax", "jaxlib"}) == [
        "ds2i_tpu", "flax", "jax", "jaxlib"]


def test_benchmark_sources_import_no_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not run.banned_modules(mods), (path, mods)


def test_roofline_bytes_on_a_hand_worked_batch():
    reader = run.metric_reader("decode_roofline")
    bb = reader.__globals__["batch_bytes"]
    list_bytes, lens = np.array([10, 20, 30, 40]), np.array([1, 2, 3, 4])
    # terms 0 and 2 (2 twice): 10 + 30 bytes read, 8 B for each of 1 + 3 postings
    assert bb([0, 2, 2], list_bytes, lens) == 72

    class R:
        trace = {"kernels": {"(anonymous namespace)::pair_part_kernel(int)": (3, 1e-6),
                             "join_kernel": (1, 5.0)}}
        batch_terms = [np.array([0, 2]), np.array([1])]

    R.list_bytes, R.lens = list_bytes, lens
    want = 100 * (72 + 20 + 16) / 3.35e12 / 1e-6
    assert reader(R) == pytest.approx(want)


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    with open(os.path.join(root, "benchmark", "configs", "tiny_opt.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_new", num_docs=1000)
    with open(os.path.join(root, "benchmark", "configs", "tiny_new.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark", "traffic", "and-b7.json"), "w") as f:
        json.dump({"name": "and-b7", "why": "t", "batch": 7, "ops": ["and"], "prune": False,
                   "warmup_batches": 1, "query_len_p": [0, 1], "term_df_power": 1.0}, f)
    with open(os.path.join(root, "benchmark", "metrics", "batches_seen.py"), "w") as f:
        f.write("def read(run):\n    return len(run.sizes)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_new", "source": "s", "why": "w", "reduced": [],
                            "file": "benchmark/configs/tiny_new.json"})
    spec["workloads"].append({"name": "tiny_new.and-b7", "config": "tiny_new",
                              "traffic": "and-b7", "chips": 1, "why": "w"})
    spec["per_layer"].append({"name": "batches_seen", "unit": "n", "better": "higher",
                              "source": "host_clock", "layer": "client", "moves": "qps"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell, _, cfg, traffic, metrics = run.resolve("tiny_new.and-b7", True, root)
    assert cfg["num_docs"] == 1000 and traffic["batch"] == 7
    names = [m["name"] for m, _ in metrics]
    assert "batches_seen" in names and "decode_roofline" not in names
    r = run.Run(cfg, traffic, None, None)
    r.sizes = [7, 7, 7]
    assert dict((m["name"], read) for m, read in metrics)["batches_seen"](r) == 3
    # a metric with no workloads key goes to every cell that reports what it moves
    assert "batches_seen" in [m["name"] for m, _ in run.resolve(PRUNED, True, root)[4]]
    assert [m["name"] for m, _ in run.resolve("tiny_new.and-b7", False, root)[4]] == [
        "qps", "p95_batch_ms", "setup_s"]


@pytest.mark.parametrize("name", [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")[
    "workloads"]])
def test_each_cell_reads_what_its_metrics_move(name):
    """Each cell of BENCHMARK.json reports setup_s and another end-to-end
    metric, and per-layer metrics that each move one it reports, every
    metric with a reader of its own; the latency copies read as their
    originals do."""
    spec = run.load_json(run.ROOT, "BENCHMARK.json")
    _, _, e2e, layer = run.cell_spec(spec, name)
    reported = {m["name"] for m in e2e}
    assert "setup_s" in reported and len(reported) >= 2 and layer
    assert all(m["moves"] in reported for m in layer), [(m["name"], m["moves"]) for m in layer]
    r = run.Run({}, {}, None, None)
    r.sizes, r.prepare_s, r.seconds = [4, 4], [1e-3, 3e-3], 0.5
    r.trace = {"window_s": 0.5, "busy_s": 0.1,
               "kernels": {"pair_part_kernel": (2, 1e-4), "join_kernel": (2, 2e-4)}}
    for m in e2e + layer:
        read = run.metric_reader(m["name"])
        base = m["name"].rsplit(".", 1)[0]
        if m["name"].endswith(".latency"):
            assert read(r) == run.metric_reader(base)(r) is not None, m["name"]


def _run(root, name, seed, trace=0, hook=None):
    out, checks = run.run_cell(name, seed, 0.5, trace, device="cpu", root=root,
                               log=lambda msg: None, engine_hook=hook)
    return out, checks


def test_pruned_run_is_correct_and_leaves_no_theta_file(tiny_root):
    out, checks = _run(tiny_root, PRUNED, 2**31 + 5)
    assert out["correct"] and out["failed"] == 0 and out["compared"] > 100
    assert set(out["metrics"]) == {"qps", "p95_batch_ms", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    state = os.path.join(tiny_root, "build", "benchmark", "tiny_block", "state")
    assert os.listdir(state) and not glob.glob(os.path.join(state, f"*{deploy.THETA}*"))
    # a theta file planted in the built state never reaches a run
    planted = os.path.join(state, f"torch_resident_x{deploy.THETA}and_y.npz")
    open(planted, "w").close()
    try:
        d = deploy.run_cache_dir(os.path.dirname(state))
        assert os.listdir(d) and not glob.glob(os.path.join(d, f"*{deploy.THETA}*"))
    finally:
        os.remove(planted)
    again, _ = _run(tiny_root, PRUNED, 2**31 + 5)
    assert again["correct"]
    assert not glob.glob(os.path.join(state, f"*{deploy.THETA}*"))


@pytest.mark.parametrize("name, builds", [(EXHAUSTIVE, 1), (MIXED, 2)])
def test_setup_s_leaves_out_the_cold_build(tmp_path, monkeypatch, name, builds):
    """A transformed configuration's cold set-up is a chain of two builds
    in child processes (its source's, then the transform), both left out."""
    import time

    root = make_root(tmp_path)
    children = []
    build_in_child = deploy.build_in_child

    def timed(*args):
        children.append(build_in_child(*args))
        return children[-1]

    monkeypatch.setattr(deploy, "build_in_child", timed)
    lines = []
    for _ in range(2):
        t = time.time()
        monkeypatch.setattr(run, "T_START", t)  # the run's process start
        out, _ = run.run_cell(name, 2**31 + 9, 0.3, 0, device="cpu", root=root,
                              log=lines.append)
        wall = time.time() - t
        rec = json.loads([m for m in lines if m.startswith("setup ")][-1][len("setup "):])
        setup = out["metrics"]["setup_s"]["value"]
        assert out["correct"] and setup == pytest.approx(rec["setup_s"])
        assert 0 < setup and setup + rec["cold_build_s"] < wall + 1.0
    cold, warm = [json.loads(m[len("setup "):]) for m in lines if m.startswith("setup ")]
    assert cold["setup"] == "cold" and cold["cold_build_s"] > 0
    assert warm["setup"] == "warm" and warm["cold_build_s"] == 0.0
    assert len(children) == builds and cold["cold_build_s"] >= sum(children)
    # the window's queries were drawn in set-up
    assert cold["late_chunks"] == warm["late_chunks"] == 0 and warm["prefetched"] >= 1


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_reports_its_metrics(tiny_root, name):
    out, _ = _run(tiny_root, name, 31, trace=1)
    assert out["correct"]
    host = {"plan_us_per_query", "dispatch_us_per_query", "collect_us_per_query"}
    # the CPU path runs no kernel: the device readers find nothing and are left out
    assert host <= set(out["metrics"]) and "decode_dev_us_per_query" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.parametrize("precision", ["bf16", "f16"])
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", [EXHAUSTIVE, WAND, MIXED])
def test_control_reads_not_correct(tiny_root, name, seed, precision):
    deploy.ensure(tiny_root, run.resolve(name, False, tiny_root)[1], "cpu", lambda msg: None)
    numbers, n = control.reading(name, seed, 8 * 1024, root=tiny_root, precision=precision)
    assert n > 1000 and not reference.passes(numbers), numbers
    assert numbers["missing"] == numbers["len_mismatch"] == 0
    exact, _ = control.reading(name, seed, 8 * 1024, root=tiny_root, precision="f32")
    assert exact == {"missing": 0, "len_mismatch": 0, "max_rel_gap": 0.0}


def _half_batch(eng):
    """A plan that leaves out the second half of each batch."""
    prepare = eng.prepare

    def half(queries, **kw):
        plan = prepare(queries[: len(queries) // 2], **kw)
        plan["n"] = len(queries)
        return plan

    eng.prepare = half


def _altered_answer(eng):
    """Every score, ranked OR's and ranked AND's, altered by 1% where the
    answers are produced."""
    collect = eng.collect

    def alter(r):
        return None if r is None else np.where(np.isfinite(r), r * np.float32(1.01), r)

    def altered(plan, pending):
        return [(a, o, alter(r_or), alter(r)) for a, o, r_or, r in collect(plan, pending)]

    eng.collect = altered


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer])
@pytest.mark.parametrize("name", [PRUNED, EXHAUSTIVE, WAND, MIXED])
def test_a_broken_timed_path_reads_not_correct(tiny_root, name, fault):
    out, checks = _run(tiny_root, name, 2**31 + 17, hook=fault)
    assert not out["correct"], checks


def test_wand_run_is_judged_against_ranked_or(tiny_root, monkeypatch):
    out, checks = _run(tiny_root, WAND, 2**31 + 23)
    assert out["correct"] and out["failed"] == 0 and out["compared"] > 100, checks
    assert set(out["metrics"]) == {"qps", "p95_batch_ms", "setup_s"}
    assert checks["missing"] == checks["len_mismatch"] == 0
    # the same answers judged as ranked AND ones fail: the reference matters
    monkeypatch.setitem(run.JUDGED, ("or",), (2, "ranked_and"))
    out, checks = _run(tiny_root, WAND, 2**31 + 23)
    assert not out["correct"] and checks["len_mismatch"] > 0, checks


def test_unjudged_ops_exit_before_the_cell_is_built(tmp_path):
    root = make_root(tmp_path)
    with open(os.path.join(root, "benchmark", "traffic", "or_and-b7.json"), "w") as f:
        json.dump({"name": "or_and-b7", "why": "t", "batch": 7, "ops": ["or", "and"],
                   "prune": False, "warmup_batches": 1, "query_len_p": [0, 1],
                   "term_df_power": 1.0}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny_opt.or_and-b7", "config": "tiny_opt",
                              "traffic": "or_and-b7", "chips": 1, "why": "w"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    opened = []
    with pytest.raises(SystemExit, match=r"traffic/or_and-b7\.json"):
        _run(root, "tiny_opt.or_and-b7", 1, hook=opened.append)
    with pytest.raises(SystemExit, match=r"traffic/or_and-b7\.json"):
        control.reading("tiny_opt.or_and-b7", 1, 7, root=root)
    assert not opened and not os.path.exists(os.path.join(root, "build"))


@pytest.mark.cuda
def test_card_run_is_correct(tmp_path, cuda_card):
    root = make_root(tmp_path)
    for name in (PRUNED, EXHAUSTIVE, WAND, MIXED):
        out, checks = run.run_cell(name, 2**31 + 3, 2.0, 1, device="cuda", root=root,
                                   log=lambda msg: None)
        assert out["correct"], checks
        assert out["device"]["busy_s"] > 0 and "decode_dev_us_per_query" in out["metrics"]


def test_trace_reading_on_a_hand_worked_timeline(tmp_path):
    import timeline

    ev = [("user_annotation", "window", 0, 100), ("user_annotation", "prepare", 0, 30),
          ("user_annotation", "dispatch", 30, 20), ("user_annotation", "collect", 60, 10),
          ("kernel", "k1", 10, 5), ("kernel", "k2", 40, 5), ("gpu_memcpy", "copy", 42, 10),
          ("kernel", "k1", 99, 4), ("kernel", "late", 101, 5)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in ev]}))
    a = timeline.analyse(str(path))
    # busy: 10-15, 40-52 and 99-100 (cut at the window's end); idle by host span
    assert a["window_s"] == pytest.approx(1e-4) and a["busy_s"] == pytest.approx(18e-6)
    assert a["kernels"]["k1"] == (2, pytest.approx(9e-6)) and "late" not in a["kernels"]
    idle = dict(timeline.breakdown(a)["idle_gaps"])
    assert idle == pytest.approx({"prepare": 25e-6, "dispatch": 10e-6, "collect": 10e-6,
                                  "client": 37e-6})
