"""A configuration's deployment: its collection, index, wand data and
engine state, built once in a checkout and loaded by every later run.

The first run of a configuration in a checkout (a cold set-up) generates
the collection (`corpus.py`), builds the index and the wand data through
the port's own builders and writes them with the port's own
`tools/common.py` savers, then builds the engine's derived state under a
`cache_dir` (tile tables, exception patches, the norm cache, the
block-max tables), as an offline tool (ds2i's create_freq_index) builds
the one index a deployment serves. All of it goes to
build/benchmark/<config>/, written under a temporary name and renamed
when whole.

A configuration whose file carries a "transform" object is built from
another configuration's built index instead, as ds2i builds its optimal
hybrid index (WSDM'15: create_freq_index block_optpfor, profile_queries,
optimal_hybrid_index). Its one method, "optimal_hybrid", takes:

    "transform": {"from": <the source configuration's name, its file
                           beside this one>,
                  "method": "optimal_hybrid",
                  "predictors": <repo-relative path of a decode-time model,
                                 dec_time_regression's TSV>,
                  "train_traffic": <traffic mix whose law draws the
                                    training log>,
                  "train_queries": <queries in the training log>,
                  "budget_share": <the space budget over the source
                                   index's bytes>}

The source is ensured first, in its own child process; the collection
keys (COLLECTION_KEYS) must equal the source's. The transform links the
source's collection and wand data (nothing is generated again, so the
reference judges the same collection), draws the training log from the
stream's TRAIN part with the seed `corpus_seed`, counts block accesses
(the port's `profile_queries.fast_profile`), and runs the port's
`index/hybrid.py` chain as `tools/optimal_hybrid_index.py` does; the
index, list sizes and engine state are then saved by the same tail as a
built configuration's.

Every run (a warm set-up) loads those files and opens the engine over a
cache_dir of its own under TMPDIR, which links the built state files and
nothing else: the probe thresholds a pruned prepare writes there
(`torch_resident_*_theta_*.npz`) never pass from one run to another.
"""

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

if __name__ == "__main__":
    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import corpus  # noqa: E402
import stream as stream_mod  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
THETA = "_theta_"
# what a transformed configuration shares with its source: its collection
COLLECTION_KEYS = ("num_docs", "num_terms", "postings_target", "corpus_seed", "clustered")
METHOD = "optimal_hybrid"


def build_dir(root, cfg):
    return os.path.join(root, "build", "benchmark", cfg["name"])


def load_json(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def _tree_bytes(path):
    """The bytes of the files written under `path` (links not followed)."""
    return sum(os.path.getsize(p) for p in glob.glob(os.path.join(path, "**"), recursive=True)
               if os.path.isfile(p) and not os.path.islink(p))


def list_bytes(index):
    """Each list's compressed bytes, docs and freqs together: what a
    decode of the whole list has to read."""
    if hasattr(index, "docs_sequences"):
        total = np.zeros(index.size(), dtype=np.int64)
        for coll in (index.docs_sequences, index.freqs_sequences):
            ends = np.append(np.asarray(coll.endpoints(), np.int64), int(coll.bits_bv.nbits))
            total += (np.diff(ends) + 7) // 8
        return total
    ends = np.append(np.asarray(index.endpoints(), np.int64), len(index.lists))
    return np.diff(ends)


def source_file(root, cfg_file, cfg):
    """The file of the configuration that `cfg` is transformed from (its
    "from" name, beside its own file); exits naming what does not hold:
    an unknown method, a budget share not above 0, a collection key
    that differs from the source's."""
    spec = cfg["transform"]
    if spec["method"] != METHOD:
        raise SystemExit(f"deploy.py: {cfg_file}: transform method {spec['method']!r} "
                         f"is not {METHOD!r}, the one method")
    if not spec["budget_share"] > 0:
        raise SystemExit(f"deploy.py: {cfg_file}: budget_share {spec['budget_share']!r} "
                         f"is not above 0")
    src_file = os.path.join(os.path.dirname(cfg_file), spec["from"] + ".json")
    src = load_json(root, src_file)
    for key in COLLECTION_KEYS:
        if cfg[key] != src[key]:
            raise SystemExit(f"deploy.py: {cfg_file}: {key} is {cfg[key]!r} but its source "
                             f"{src_file} has {src[key]!r}; a transformed configuration "
                             f"serves its source's collection")
    return src_file


def ensure(root, cfg_file, device, log):
    """The configuration's built directory; builds it when absent, in a
    process of its own, so that what the build leaves in memory never
    reaches the run's window; a transformed configuration's source first,
    in a process of its own too. Returns (path, cold set-up record or
    None, seconds the cold set-ups took: 0.0 when there was none)."""
    cfg = load_json(root, cfg_file)
    path = build_dir(root, cfg)
    if os.path.exists(os.path.join(path, "built.json")):
        return path, None, 0.0
    took = 0.0
    if "transform" in cfg:
        took = ensure(root, source_file(root, cfg_file, cfg), device, log)[2]
    took += build_in_child(root, cfg_file, device, log)
    with open(os.path.join(path, "built.json")) as f:
        return path, json.load(f), took


def build_in_child(root, cfg_file, device, log):
    """Runs this file's cold set-up of one configuration in a child
    process; returns its seconds."""
    t = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), root, cfg_file, device],
                          stdout=subprocess.PIPE, text=True)
    took = time.time() - t
    log(proc.stdout.strip())
    if proc.returncode:
        raise RuntimeError(f"the cold set-up of {cfg_file} exited {proc.returncode}")
    return took


def _fresh(path):
    """The empty temporary directory a cold set-up of `path` writes."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "state"))
    return tmp


def build(root, cfg, device, log):
    """Builds the configuration's directory (the cold set-up)."""
    from ds2i_torch.global_params import GlobalParameters
    from ds2i_torch.index.types import make_index_type
    from ds2i_torch.io import BinaryFreqCollection, read_sizes
    from ds2i_torch.queries import WandData
    from ds2i_torch.tools.common import save_wand_data

    path = build_dir(root, cfg)
    tmp = _fresh(path)
    base = os.path.join(tmp, "coll")
    rec, t = {}, time.perf_counter()
    _, lists, n_postings, _ = corpus.write(base, cfg["num_docs"], cfg["num_terms"],
                                           cfg["postings_target"], cfg["corpus_seed"],
                                           cfg["clustered"])
    rec["generate_s"], t = time.perf_counter() - t, time.perf_counter()
    coll = BinaryFreqCollection(base)
    wdata = WandData.build(read_sizes(base), coll)
    save_wand_data(wdata, os.path.join(tmp, "wand.bin"))
    rec["wand_s"], t = time.perf_counter() - t, time.perf_counter()
    b = make_index_type(cfg["index_type"]).builder(coll.num_docs, GlobalParameters())
    for docs, freqs in coll:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs, dtype=np.int64).sum()))
    rec.update(lists=lists, postings=n_postings)
    _finish(cfg, path, b.build(), wdata, coll, device, rec, "index_s", t, log)


def transform(root, cfg_file, device, log):
    """Builds a transformed configuration's directory from its source's
    (the cold set-up): the WSDM'15 optimal hybrid through the port's
    functions, as tools/optimal_hybrid_index.py calls them."""
    from ds2i_torch.codecs.time_prediction import load_predictors
    from ds2i_torch.index.hybrid import compute_lambdas, greedy_tradeoff, rebuild_mixed
    from ds2i_torch.io import BinaryFreqCollection
    from ds2i_torch.tools.common import load_index, load_wand_data
    from ds2i_torch.tools.profile_queries import fast_profile

    cfg = load_json(root, cfg_file)
    spec = cfg["transform"]
    src = build_dir(root, load_json(root, source_file(root, cfg_file, cfg)))
    path = build_dir(root, cfg)
    tmp = _fresh(path)
    for p in sorted(glob.glob(os.path.join(src, "coll.*"))) + [os.path.join(src, "wand.bin")]:
        os.symlink(os.path.relpath(p, tmp), os.path.join(tmp, os.path.basename(p)))
    base = os.path.join(tmp, "coll")
    rec, t = {}, time.perf_counter()
    index = load_index(os.path.join(src, "index.bin"))
    wdata = load_wand_data(os.path.join(tmp, "wand.bin"))
    lens = corpus.Collection(base).lens
    rec["load_s"], t = time.perf_counter() - t, time.perf_counter()
    traffic = load_json(root, os.path.join(os.path.basename(HERE), "traffic",
                                           f"{spec['train_traffic']}.json"))
    log_queries = stream_mod.Stream(lens, cfg["corpus_seed"], *stream_mod.law(traffic),
                                    part=stream_mod.TRAIN).batch(0, spec["train_queries"])[0]
    prof = fast_profile(index, log_queries, len(traffic["ops"]))
    counts = {term: c.tolist() for term, c in prof.counts.items()}
    del log_queries, prof
    rec["profile_s"], t = time.perf_counter() - t, time.perf_counter()
    predictors = load_predictors(os.path.join(root, spec["predictors"]))
    lambdas_file = os.path.join(tmp, "lambdas.npy")
    lambdas = compute_lambdas(index, predictors, counts, lambdas_file)
    rec["lambdas_s"], t = time.perf_counter() - t, time.perf_counter()
    budget = round(spec["budget_share"] * len(index.lists))
    types, params = greedy_tradeoff(index, lambdas, budget)
    del lambdas
    os.remove(lambdas_file)
    rec["greedy_s"], t = time.perf_counter() - t, time.perf_counter()
    mixed = rebuild_mixed(index, types, params, index.params)
    keys, n = np.unique(types.astype(np.int64) << 8 | params, return_counts=True)
    rec.update(lists=len(lens), postings=int(lens.sum()), budget_bytes=budget,
               source_bytes=len(index.lists), space_bytes=len(mixed.lists),
               streams={f"({k >> 8},{k & 255})": c for k, c in zip(keys.tolist(), n.tolist())},
               partial_streams=2 * int((lens % index.codec.block_size != 0).sum()))
    del index
    _finish(cfg, path, mixed, wdata, BinaryFreqCollection(base), device, rec, "rebuild_s", t, log)


def _finish(cfg, path, index, wdata, coll, device, rec, stage, t, log):
    """A cold set-up's tail: saves the index and its list sizes (closing
    rec[stage], begun at perf_counter time t), builds the engine's state,
    writes built.json and moves the temporary directory into `path`."""
    from ds2i_torch.engine import make_engine
    from ds2i_torch.tools.common import save_index

    tmp = path + ".tmp"
    save_index(index, os.path.join(tmp, "index.bin"))
    np.save(os.path.join(tmp, "list_bytes.npy"), list_bytes(index))
    rec[stage], t = time.perf_counter() - t, time.perf_counter()
    eng = make_engine(index, wdata, device=device, cache_dir=os.path.join(tmp, "state"))
    rec["engine_s"], t = time.perf_counter() - t, time.perf_counter()
    eng.build_blockmax(coll)
    # one exhaustive batch builds the norm cache (a pruned one would
    # leave a theta file behind)
    eng.execute(eng.prepare([[0]], k=cfg["k"], ops=("and",)))
    rec["state_s"] = time.perf_counter() - t
    del eng
    if glob.glob(os.path.join(tmp, "state", f"*{THETA}*")):
        raise RuntimeError("the cold set-up left a probe threshold file in the engine state")
    rec["bytes_written"] = _tree_bytes(tmp)
    with open(os.path.join(tmp, "built.json"), "w") as f:
        json.dump(rec, f)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    log(f"cold set-up of {cfg['name']}: {json.dumps(rec)}")


def run_cache_dir(path):
    """A fresh cache_dir under TMPDIR holding links to the built engine
    state and no theta file; the caller removes it."""
    d = tempfile.mkdtemp(prefix="ds2i_bench_state_")
    for p in glob.glob(os.path.join(path, "state", "*")):
        if THETA in os.path.basename(p):
            continue
        os.symlink(os.path.abspath(p), os.path.join(d, os.path.basename(p)))
    return d


def open_engine(path, device, cache_dir):
    """The port's index, wand data and engine from the built files."""
    from ds2i_torch.engine import make_engine
    from ds2i_torch.tools.common import load_index, load_wand_data

    index = load_index(os.path.join(path, "index.bin"))
    wdata = load_wand_data(os.path.join(path, "wand.bin"))
    return make_engine(index, wdata, device=device, cache_dir=cache_dir)


if __name__ == "__main__":
    # python3 deploy.py <checkout root> <configuration file> <device>
    _root, _cfg_file, _device = sys.argv[1:4]
    _cfg = load_json(_root, _cfg_file)
    _log = lambda msg: print(msg, flush=True)  # noqa: E731
    if "transform" in _cfg:
        transform(_root, _cfg_file, _device, _log)
    else:
        build(_root, _cfg, _device, _log)
