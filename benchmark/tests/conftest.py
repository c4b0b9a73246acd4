"""Fixtures of the benchmark's own tests: a checkout-like root in a
temporary directory, holding a BENCHMARK.json of tiny cells (2,000
docs), the benchmark's traffic mixes and metric readers and the tests'
own mixes, whose runs the tests drive on the CPU through run.run_cell.
One tiny configuration, tiny_mixed, is built by transformation of
another's index (deploy.py's optimal hybrid), under the tests' own
decode-time model."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"num_docs": 2000, "num_terms": 22000, "postings_target": 300000}
CELLS = {
    "tiny_block.and_skip-b1024": ("tiny_block", "and_skip-b1024"),
    "tiny_opt.and-b1024": ("tiny_opt", "and-b1024"),
    "tiny_block.wand-b1024": ("tiny_block", "wand-b1024"),
    "tiny_mixed.and-b1024": ("tiny_mixed", "and-b1024"),
}
# tiny_mixed: the optimal hybrid of tiny_block's index, under a decode-time
# model of the tests' own (dec_time_regression's TSV, one line a block
# type: PFOR, VARINT, INTERPOLATIVE) in which Varint-G8IU decodes fastest
# and interpolative slowest, so that at the source's space the greedy
# gives full blocks all three codecs
PREDICTORS = ("type 0 bias 1.0 size 0.1\n"
              "type 1 bias 0.5 nonzeros 0.01\n"
              "type 2 bias 2.0 size 0.1\n")
TRANSFORM = {"from": "tiny_block", "method": "optimal_hybrid",
             "predictors": "benchmark/configs/tiny_mixed.predictors.tsv",
             "train_traffic": "and-b1024", "train_queries": 20000, "budget_share": 1.0}
# mixes of the tests alone, written into the root beside the benchmark's:
# top-10 ranked OR with WAND, the judged OR path that no cell runs yet
MIXES = {
    "wand-b1024": {"name": "wand-b1024", "why": "test", "batch": 1024, "ops": ["or"],
                   "prune": True, "warmup_batches": 8, "query_len_p": [0.25] * 4,
                   "term_df_power": 0.5},
}


def make_root(path):
    """A root with BENCHMARK.json's tiny cells and the benchmark's data
    files and readers; the modules run from the repository's copy."""
    bench = os.path.join(path, "benchmark")
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(bench, sub))
    for name, mix in MIXES.items():
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    os.makedirs(os.path.join(bench, "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = []
    with open(os.path.join(path, TRANSFORM["predictors"]), "w") as f:
        f.write(PREDICTORS)
    for name, base, extra in (
            ("tiny_block", "block_optpfor-50x", {}), ("tiny_opt", "opt-5x", {}),
            ("tiny_mixed", "block_optpfor-50x",
             {"index_type": "block_mixed", "transform": TRANSFORM})):
        with open(os.path.join(BENCH, "configs", f"{base}.json")) as f:
            cfg = json.load(f)
        cfg.update(name=name, **TINY, **extra)
        rel = f"benchmark/configs/{name}.json"
        with open(os.path.join(path, rel), "w") as f:
            json.dump(cfg, f)
        spec["configs"].append({"name": name, "source": cfg["source"], "file": rel,
                                "reduced": sorted(TINY), "why": "a tiny test size"})
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                         for n, (c, t) in CELLS.items()]
    # every tiny cell reports every end-to-end metric, and every per-layer
    # metric but decode_roofline, which goes to the exhaustive cells alone
    for m in spec["end_to_end"]:
        m.pop("workloads", None)
    for m in spec["per_layer"]:
        m["workloads"] = [n for n, (_, t) in CELLS.items()
                          if t == "and-b1024" or m["name"] != "decode_roofline"]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return str(path)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench_root"))


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
