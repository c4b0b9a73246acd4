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

THETA = "_theta_"


def build_dir(root, cfg):
    return os.path.join(root, "build", "benchmark", cfg["name"])


def _tree_bytes(path):
    return sum(os.path.getsize(p) for p in glob.glob(os.path.join(path, "**"), recursive=True)
               if os.path.isfile(p))


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


def ensure(root, cfg_file, device, log):
    """The configuration's built directory; builds it when absent, in a
    process of its own, so that what the build leaves in memory never
    reaches the run's window. Returns (path, cold set-up record or None,
    seconds the build took: 0.0 when there was none)."""
    with open(os.path.join(root, cfg_file)) as f:
        path = build_dir(root, json.load(f))
    if os.path.exists(os.path.join(path, "built.json")):
        return path, None, 0.0
    t = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), root, cfg_file, device],
                          stdout=subprocess.PIPE, text=True)
    took = time.time() - t
    log(proc.stdout.strip())
    if proc.returncode:
        raise RuntimeError(f"the cold set-up of {cfg_file} exited {proc.returncode}")
    with open(os.path.join(path, "built.json")) as f:
        return path, json.load(f), took


def build(root, cfg, device, log):
    """Builds the configuration's directory (the cold set-up)."""
    path = build_dir(root, cfg)
    from ds2i_torch.engine import make_engine
    from ds2i_torch.global_params import GlobalParameters
    from ds2i_torch.index.types import make_index_type
    from ds2i_torch.io import BinaryFreqCollection, read_sizes
    from ds2i_torch.queries import WandData
    from ds2i_torch.tools.common import save_index, save_wand_data

    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "state"))
    base = os.path.join(tmp, "coll")
    rec, t = {}, time.perf_counter()
    _, lists, n_postings, _ = corpus.write(base, cfg["num_docs"], cfg["num_terms"],
                                           cfg["postings_target"], cfg["corpus_seed"],
                                           cfg["clustered"])
    rec["generate_s"], t = time.perf_counter() - t, time.perf_counter()
    coll = BinaryFreqCollection(base)
    b = make_index_type(cfg["index_type"]).builder(coll.num_docs, GlobalParameters())
    for docs, freqs in coll:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs, dtype=np.int64).sum()))
    index = b.build()
    save_index(index, os.path.join(tmp, "index.bin"))
    np.save(os.path.join(tmp, "list_bytes.npy"), list_bytes(index))
    rec["index_s"], t = time.perf_counter() - t, time.perf_counter()
    wdata = WandData.build(read_sizes(base), coll)
    save_wand_data(wdata, os.path.join(tmp, "wand.bin"))
    rec["wand_s"], t = time.perf_counter() - t, time.perf_counter()
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
    rec.update(lists=lists, postings=n_postings, bytes_written=_tree_bytes(tmp))
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
    with open(os.path.join(_root, _cfg_file)) as _f:
        build(_root, json.load(_f), _device, lambda msg: print(msg, flush=True))
