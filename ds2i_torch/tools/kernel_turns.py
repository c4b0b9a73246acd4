"""Time K9 and K6g against another version of their sources, in turns, on the card.

Builds chip_smoke.py's 1x collection and its `opt` index (10k docs, 2M
postings; DS2I_BENCH_* and DS2I_BENCH_CACHE as there), a DeviceIndex and
a TileQueryEngine of it on the card, and the inputs chip_smoke.py's
generations phase times: K9 (csrc/segment_decode.cu) over every docs
segment of `opt` in one launch, and K6g (csrc/tile_decode.cu) over every
group of the tile layout, both streams (12 launches).

Each --other DIR holds another version's segment_decode.cu and
tile_decode.cu (and the common.cuh they include), for example a parent's
csrc/ from `git show`; the versions are named A (this tree's csrc/), then
B, C, ... in the order given. Each version's two sources are built with
this tree's nvcc flags and -Xptxas -v into build/kernel_turns/<name>/
(their ptxas lines printed) and loaded with the same argtypes. A turn
swaps one version's libraries into ds2i_torch.kernels and runs the real
wrappers (decode_rows, decode_group) on the same inputs: ms through the
wrapper (CUDA events) and alone (queued behind a spin kernel), each the
median of REPS, as chip_smoke.py times them. The turns go A, B, ...,
then back (ABBA for one other version). Before the turns each version is
held to the plain versions (K9 bit for bit, K6g on the n_vals slots),
K6g's output bytes written are counted (two patterned fills), and each
of this tree's K6g launches is timed alone. Prints the card's name and
power limit, a line per turn and a JSON summary.

    python3 ds2i_torch/tools/kernel_turns.py --other DIR [--other DIR ...]

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
ROOT = os.path.dirname(os.path.dirname(HERE))
SOURCES = ("segment_decode", "tile_decode")
REPS = 9
OUT = os.path.join(ROOT, "build", "kernel_turns")


def build(csrc, tag, out_dir):
    """Both sources of `csrc` built with -Xptxas -v, one nvcc each, at once:
    {name: (ctypes handle, ptxas lines)}."""
    from ds2i_torch import kernels

    os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = os.path.join(out_dir, tag, f"libds2i_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {name}.cu:\n{err}")
        handle = kernels.load(so, name)
        ptxas = [ln.strip() for ln in (out + err).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        libs[name] = (handle, ptxas)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="directory of another version's sources (B, C, ... in order)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    import chip_smoke
    from ds2i_torch import kernels
    from ds2i_torch.engine import DeviceIndex, TileQueryEngine
    from ds2i_torch.engine.tiles import F_NVALS, N_FIELDS, TILE
    from ds2i_torch.ops.decode import FIELDS, decode_rows
    from ds2i_torch.ops.pair_decode import _decode_stream, decode_group

    t0 = time.perf_counter()
    dirs = [os.path.join(ROOT, "ds2i_torch", "csrc"), *map(os.path.abspath, args.other)]
    versions = {chr(ord("A") + i): build(d, chr(ord("A") + i), OUT) for i, d in enumerate(dirs)}
    turns = "".join(versions) + "".join(reversed(versions))
    kernels.lib("segment_decode")  # the wrappers' libraries, replaced turn by turn below
    for v, libs in versions.items():
        for name, (_, ptxas) in libs.items():
            for ln in ptxas:
                print(f"ptxas {v} {name}: {ln}", flush=True)
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)

    coll, wdata, _ = chip_smoke.load_collection()
    index = chip_smoke.build_index(coll, "opt")
    dindex = DeviceIndex(index)
    tile = TileQueryEngine(dindex, wdata)
    w, f, list_n, st, segs = chip_smoke.segment_call(dindex, "docs")
    seg_args = (w, *(f[k] for k in FIELDS), list_n)
    nl = dindex.num_lists
    groups, gfields = tile._build_batch(np.arange(nl), np.ones(nl, np.float32),
                                        np.ones(nl, np.int64))[:2]
    g_dev = torch.from_numpy(gfields).to(dindex.device)
    calls = [(words, g_dev[off:off + R, s:s + N_FIELDS].contiguous(), W, WL)
             for off, R, W, WL in groups
             for s, words in ((0, dindex.docs_words), (N_FIELDS, dindex.freqs_words))]
    seg_bytes = chip_smoke.segment_bytes(segs, st)
    tile_bytes = chip_smoke.tile_group_bytes(gfields, groups)

    def use(v):
        for name, (handle, _) in versions[v].items():
            kernels._LIBS[name] = handle

    def k9():
        return decode_rows(*seg_args, **st)

    def k6g():
        for c in calls:
            decode_group(*c)

    # each version against the plain versions, and K6g's bytes written
    exp9 = chip_smoke.plain_decode(w, f, list_n, st, chip_smoke.plain_pieces(f, st))
    written = {}
    for v in versions:
        use(v)
        if not torch.equal(k9(), exp9):
            raise AssertionError(f"version {v}: segment_decode differs from decode_rows_torch")
        for words, fld, W, WL in calls:
            valid = torch.arange(TILE, device=fld.device)[None, :] < fld[:, F_NVALS, None]
            got = decode_group(words, fld, W, WL)
            exp = _decode_stream(words, fld, W, WL, TILE).to(torch.int32)
            if not torch.equal(got[valid], exp[valid]):
                raise AssertionError(f"version {v}: tile_decode differs from _decode_stream "
                                     f"on ({W}, {WL})")
        written[v] = 4 * chip_smoke.tile_written(calls)[0]
    del exp9
    # each K6g launch alone, this tree's version
    use("A")
    per_launch = [{"W": c[2], "WL": c[3], "rows": int(c[1].shape[0]),
                   "alone_ms": chip_smoke.device_only_ms(lambda c=c: decode_group(*c),
                                                         reps=REPS)}
                  for c in calls]
    print(json.dumps({"k6g_launches_alone_A": per_launch}), flush=True)

    rows = []
    for i, v in enumerate(turns):
        use(v)
        row = {"turn": i, "version": v,
               "k9_ms": chip_smoke.cuda_ms(k9, reps=REPS),
               "k9_alone_ms": chip_smoke.device_only_ms(k9, reps=REPS),
               "k6g_ms": chip_smoke.cuda_ms(k6g, reps=REPS),
               "k6g_alone_ms": chip_smoke.device_only_ms(k6g, reps=REPS)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"card": smi, "versions": dict(zip(versions, dirs)), "turns": turns,
               "reps": REPS,
               "k9_segments": len(segs["kind"]), "k9_bound_ms": chip_smoke.bound(seg_bytes)[0],
               "k9_bytes": seg_bytes, "k6g_launches": len(calls), "k6g_rows": len(gfields),
               "k6g_bound_ms": chip_smoke.bound(tile_bytes)[0], "k6g_bytes": tile_bytes,
               "k6g_written_bytes": written}
    for v in versions:
        mine = [r for r in rows if r["version"] == v]
        for key in ("k9_ms", "k9_alone_ms", "k6g_ms", "k6g_alone_ms"):
            vals = [r[key] for r in mine if r[key] is not None]
            summary[f"{v}_{key}"] = statistics.median(vals) if vals else None
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
