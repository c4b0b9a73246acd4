"""CLI: measure per-(type,param) block decode times (profile_decoding.cpp).

Usage: python -m ds2i_torch.tools.profile_decoding <type> <index> <fraction>
           [--out FILE] [--replays N] [--engine host|resident] [--copies N]
           [--device cuda|cpu]

Samples `fraction` of the full blocks (rng seeded 1729, like the
reference), re-encodes each with every viable (type, param), measures
decode time over repeated replays, and emits one JSON line per
measurement with the block's features: the training data for the
decode-time regression (dec_time_regression).

--engine host (default) times the Python decode of the block codec on
this machine's CPU, as the JAX package's tool does.

--engine resident times the kernels the resident engine launches for
each decode group instead, on the card (--device cpu: their plain
PyTorch versions on the host's clock, for tests). Blocks sharing a
group's statics ("opt", b, E, 128), ("var", G, 128) or ("interp", W,
128) are laid end to end in one stream, replicated at distinct stream
copies up to `copies` rows (profile_decoding.cpp's 256 random-aligned
copies), with their field rows as the engine's tile walk fills them. The
group's kernel (ops/block_decode.py: K1 optpfor_decode for E = 0, K1s
optpfor_s16_decode for E > 0, K7 varint_decode, K2 interp_decode) then
decodes the (R, 128) rows in one launch, docs mode, N times and 2N times
back to back on the card's stream between CUDA events, queued behind a
spin kernel so that the events time the device's work and not the
host's enqueue (the host's clock on the CPU); the per-block time is (t(2N) - t(N)) /
N / R, which cancels what the two runs share, with N doubled until the
difference clears a tenth of t(N) (at most 4 times), each time the best
of 3 trials. No torch.compile and no CUDA graph: the time is the
kernels'. Each sampled block's record carries its group's per-block
time, in ns. The mode ends with one stats line on stdout: the groups
timed, by kernel, and each kernel's launches (counted on the card only).
"""

import argparse
import json
import sys
import time

import numpy as np

from ..codecs.interpolative import UNKNOWN_SUM
from ..codecs.mixed import BLOCK_TYPES, MixedBlock, compr_params
from ..codecs.time_prediction import FeatureVector, values_statistics
from ..utils import logger, stats_line
from .common import load_index


def measure_decode(block_type, param, values, sum_of_values, replays=64):
    fv = FeatureVector()
    values_statistics(values, fv)
    buf = MixedBlock.compression_stats(block_type, param, values, sum_of_values, len(values), fv)
    if buf is None:
        return None
    t0 = time.perf_counter_ns()
    for _ in range(replays):
        MixedBlock.decode(buf, 0, sum_of_values, len(values))
    elapsed = (time.perf_counter_ns() - t0) / replays
    rec = {"type": block_type, "time": elapsed}
    rec.update(fv.dump())
    return rec


class DeviceProfiler:
    """Times the resident engine's decode kernels per decode-group
    statics (the module docstring's protocol). add() queues a block and
    the record that takes its time; flush() measures every group."""

    def __init__(self, copies=256, reps=64, trials=3, device=None):
        self.copies = copies
        self.reps = reps
        self.trials = trials
        self.device = device
        # group statics -> (encoded blocks, sums of values, lengths, records)
        self._groups = {}
        self.timed = {}  # kernel -> groups timed
        self._spin = 1 << 22  # cycles of the spin kernel that holds the stream

    def add(self, block_type, param, values, sum_of_values, rec):
        """Queue one encoded block for device timing; `rec` gains "time"
        once its group is measured (flush())."""
        from ..engine.block_tiles import _full_stream
        from ..engine.tiles import N_FIELDS

        out = []
        MixedBlock.encode_type(block_type, param, values, sum_of_values, len(values), out)
        buf = np.concatenate([np.asarray(o, np.uint8) for o in out])
        # classify only: the field rows are walked again at the block's
        # offset in its group's stream (flush())
        row = np.zeros(N_FIELDS, dtype=np.int64)
        end, st = _full_stream(buf, 0, len(values), sum_of_values, MixedBlock, row)
        if end != len(buf):
            raise AssertionError(f"the tile walk ended a {st} block at byte {end} of {len(buf)}")
        st = st + (len(values),)
        g = self._groups.setdefault(st, ([], [], [], []))
        g[0].append(buf)
        g[1].append(int(sum_of_values))
        g[2].append(len(values))
        g[3].append(rec)

    def _group_rows(self, bufs, sovs, lens):
        """The group's stream, replicated, and its (copies, N_FIELDS) field
        rows, each row at its own copy."""
        from ..engine.block_tiles import BF_EX_W0, BF_W0, KIND_OPT, _full_stream
        from ..engine.tiles import F_BASE, F_KIND, N_FIELDS

        stream = np.concatenate(bufs)
        offs = np.concatenate([[0], np.cumsum([len(b) for b in bufs[:-1]])]).astype(np.int64)
        stream = np.concatenate([stream, np.zeros((-len(stream)) % 4 + 64, np.uint8)])
        swords = len(stream) // 4
        rows = []
        for pos, sov, n in zip(offs, sovs, lens):
            row = np.zeros(N_FIELDS, dtype=np.int64)
            _full_stream(stream, int(pos), n, sov, MixedBlock, row)
            row[F_BASE] = 1
            rows.append(row)
        fld = np.stack(rows)
        ncopy = max(1, -(-self.copies // len(bufs)))
        words = np.tile(stream, ncopy).view("<u4")
        base = np.repeat(np.arange(ncopy, dtype=np.int64) * swords, len(bufs))
        fldr = np.tile(fld, (ncopy, 1))
        fldr[:, BF_W0] += base
        # the exception cursor moves with its copy (interpolative rows
        # keep their sum of values in that column)
        fldr[:, BF_EX_W0] += np.where(fldr[:, F_KIND] == KIND_OPT, base, 0)
        # one row count for every group: R = copies
        fldr = np.resize(fldr, (self.copies, fldr.shape[1]))
        if len(words) >= 2**31 or np.abs(fldr).max() >= 2**31:
            raise ValueError("a group's replicated stream passes the int32 word cursors")
        return words, fldr

    def _time_launches(self, run, n):
        """Best of `trials` times, in ns, of n back-to-back runs. On the
        card a spin kernel holds the stream while the host enqueues the
        runs, so the events bracket the device's back-to-back work and not
        the host's enqueue; the spin doubles until it outlasts twice the
        enqueue."""
        import torch

        best = float("inf")
        for _ in range(self.trials):
            if self.device.type != "cuda":
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    run()
                best = min(best, time.perf_counter_ns() - t0)
                continue
            while True:
                s0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                s0.record()
                torch.cuda._sleep(self._spin)
                start.record()
                t0 = time.perf_counter()
                for _ in range(n):
                    run()
                enqueue_ms = (time.perf_counter() - t0) * 1e3
                end.record()
                end.synchronize()
                if s0.elapsed_time(start) > 2 * enqueue_ms:
                    break
                if self._spin >= 1 << 32:
                    raise RuntimeError(f"{n} launches take {enqueue_ms:.1f} ms to enqueue: "
                                       f"no spin holds the stream that long")
                self._spin *= 2
            best = min(best, start.elapsed_time(end) * 1e6)
        return best

    def flush(self):
        """Measure every queued group and write per-block times into the
        queued records. Returns the number of groups measured."""
        import torch

        from ..device import resolve_device
        from ..ops import block_decode

        self.device = resolve_device(self.device)
        dev = self.device
        for st, (bufs, sovs, lens, recs) in sorted(self._groups.items(), key=str):
            words, fldr = self._group_rows(bufs, sovs, lens)
            R = len(fldr)
            kernel = block_decode._kernel_of(st)
            wrapper = block_decode.WRAPPERS[kernel]
            layout = block_decode.PartLayout(((0, R, st),))
            launch = layout.launch(kernel, True, dev)
            w = torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)
            fld = torch.from_numpy(fldr.astype(np.int32)).to(dev)
            gtile = torch.arange(R, dtype=torch.int64, device=dev)
            out = torch.empty((layout.nb_d, block_decode.BLOCK), dtype=torch.int32, device=dev)

            def run():
                wrapper(launch, w, fld, gtile, "docs", 1 << 30, out)

            run()  # the first launch builds and loads the kernels
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            reps, per_block = self.reps, 0.0
            for _ in range(4):  # double reps until the difference clears noise
                t1 = self._time_launches(run, reps)
                t2 = self._time_launches(run, 2 * reps)
                per_block = (t2 - t1) / reps / R
                if t2 - t1 > 0.1 * t1:
                    break
                reps *= 2
            per_block = max(per_block, 0.0)
            for rec in recs:
                rec["time"] = per_block
            self.timed[kernel] = self.timed.get(kernel, 0) + 1
        return len(self._groups)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("type")
    ap.add_argument("index_file")
    ap.add_argument("fraction", type=float)
    ap.add_argument("--out")
    ap.add_argument("--replays", type=int, default=64)
    ap.add_argument("--engine", choices=("host", "resident"), default="host")
    ap.add_argument("--copies", type=int, default=256,
                    help="resident mode: replicated stream copies per group")
    ap.add_argument("--device", default=None,
                    help="resident mode: cuda (the default) or cpu (plain PyTorch, for tests)")
    args = ap.parse_args()

    index = load_index(args.index_file, args.type)
    rng = np.random.RandomState(1729)
    out = open(args.out, "w") if args.out else sys.stdout

    dev = (DeviceProfiler(copies=args.copies, reps=args.replays, device=args.device)
           if args.engine == "resident" else None)
    measured = 0
    records = []
    for l in range(index.size()):
        if index.list_length(l) < MixedBlock.block_size:
            continue
        if rng.rand() > args.fraction:
            continue
        for ib in index.get_blocks(l):
            if ib.size != MixedBlock.block_size:
                continue
            gaps, _ = index.codec.decode(ib.docs_bytes, 0, ib.doc_gaps_universe, ib.size)
            freqs, _ = index.codec.decode(ib.freqs_bytes, 0, UNKNOWN_SUM, ib.size)
            for values, sov in ((gaps, ib.doc_gaps_universe), (freqs, UNKNOWN_SUM)):
                for t in range(BLOCK_TYPES):
                    for param in range(compr_params(t)):
                        if dev is None:
                            rec = measure_decode(t, param, values, sov, args.replays)
                            if rec is not None:
                                out.write(json.dumps(rec) + "\n")
                                measured += 1
                            continue
                        fv = FeatureVector()
                        values_statistics(values, fv)
                        buf = MixedBlock.compression_stats(
                            t, param, values, sov, len(values), fv)
                        if buf is None:
                            continue
                        rec = {"type": t, "time": 0.0}
                        rec.update(fv.dump())
                        dev.add(t, param, values, sov, rec)
                        records.append(rec)
                        measured += 1
    if dev is not None:
        from ..ops import block_decode

        ngroups = dev.flush()
        launches = {w.__name__: w.launches for w in block_decode.WRAPPERS.values() if w.launches}
        logger(f"{ngroups} device decode groups timed on {dev.device}")
        stats_line(engine="resident", device=str(dev.device), groups=ngroups,
                   groups_by_kernel=dict(sorted(dev.timed.items())), launches=launches)
        for rec in records:
            out.write(json.dumps(rec) + "\n")
    logger(f"{measured} measurements")
    if args.out:
        out.close()


if __name__ == "__main__":
    main()
