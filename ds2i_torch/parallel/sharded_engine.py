"""Mesh-collective demonstration plane (dp x tp grid with a sum over tp):
the port of ds2i_tpu/parallel/sharded_engine.py.

SCOPE: as in the JAX package, this is the multi-device COLLECTIVE
fixture, not a serving path. It scatters into dense (B_local, num_docs)
score and count planes, which is O(B*D) memory and only sensible at small
num_docs. The scale-out serving path is parallel/doc_sharded.
DocShardedEngine (doc-range shards, each query's join local to a shard,
k scores merged), with ResidentEngine(devices=[...]) for query-batch
data parallelism over replicated state.

  - 'dp' axis: query batch rows (data parallel)
  - 'tp' axis: query terms: each shard scores its term slice on its own
    device; the tp shards' planes are summed in tp order on the first
    device of their dp row (the JAX package's psum over 'tp'), which
    then counts and takes the top-k.

A Mesh is a (dp, tp) grid of torch.devices. torch has a single CPU
device, so a CPU mesh repeats it (the tests' 8-way CPU mesh is
[torch.device("cpu")] * 8), and a card may stand in several places of a
grid (chip_smoke.py's (2, 2) grid of cuda:0); repeated devices are
allowed for that reason only: the shards then run one after another.

The plane's scatter-add and the top-k are plain PyTorch calls, as they
were XLA ops in the JAX plane (engine/executor.py:plane_counts_scores).
Counts are exact; scores sum in another order than XLA's psum, so they
agree within the reference's rtol 1e-3.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..engine.executor import plane_counts_scores


class Mesh:
    """A (dp, tp) grid of devices, axes ("dp", "tp")."""

    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2 or self.devices.size == 0:
            raise ValueError(f"a Mesh is a non-empty (dp, tp) grid of devices, got shape "
                             f"{self.devices.shape}")

    @property
    def shape(self):
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}


def make_mesh(devices=None, dp=None, tp=None):
    """A (dp, tp) Mesh over `devices` (default: every visible CUDA device;
    raises without one). tp defaults to 2 where the device count is even
    and above 1, dp to the rest."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if dp is None:
        dp = n // tp
    if dp * tp > n or dp < 1 or tp < 1:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} devices, {n} given")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices[: dp * tp]):
        grid[i // tp, i % tp] = d
    return Mesh(grid)


def _tensor(a, device, dtype):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def make_sharded_plane_step(mesh, num_docs, k):
    """Returns a step: (docs (B,T,L), freqs, qw (B,T), norm_lens (D,)) ->
    (and_counts, or_counts, topk_or, topk_and), B split over 'dp' and T
    over 'tp' (each must divide), the results on the mesh's first device."""
    grid = mesh.devices
    dp, tp = grid.shape

    def local_planes(docs, freqs, qw, norm_lens):
        """One shard's (count plane, score plane, AND target part)."""
        counts, scores = plane_counts_scores(docs, freqs, qw, norm_lens, num_docs)
        return counts, scores, (qw > 0).sum(dim=1, dtype=torch.int32)

    def step(docs, freqs, qw, norm_lens):
        B, T, L = docs.shape
        if B % dp or T % tp:
            raise ValueError(f"B={B} must divide over dp={dp} and T={T} over tp={tp}")
        bl, tl = B // dp, T // tp
        outs = []
        for i in range(dp):
            parts = []
            for j in range(tp):
                dev = grid[i, j]
                rs, ts = slice(i * bl, (i + 1) * bl), slice(j * tl, (j + 1) * tl)
                parts.append(local_planes(
                    _tensor(docs[rs, ts], dev, torch.int32),
                    _tensor(freqs[rs, ts], dev, torch.int32),
                    _tensor(qw[rs, ts], dev, torch.float32),
                    _tensor(norm_lens, dev, torch.float32)))
            # the sum over 'tp', in tp order, on the row's first device
            home = grid[i, 0]
            counts, scores, target = (p.to(home) for p in parts[0])
            for c, s, t in parts[1:]:
                counts = counts + c.to(home)
                scores = scores + s.to(home)
                target = target + t.to(home)
            and_counts = (counts == target[:, None]).sum(dim=1, dtype=torch.int32)
            or_counts = (counts > 0).sum(dim=1, dtype=torch.int32)
            topk_or = torch.topk(torch.where(counts > 0, scores, -torch.inf), k, dim=1).values
            topk_and = torch.topk(torch.where(counts == target[:, None], scores, -torch.inf), k,
                                  dim=1).values
            outs.append([t.to(grid[0, 0]) for t in (and_counts, or_counts, topk_or, topk_and)])
        return tuple(torch.cat(cols) for cols in zip(*outs))

    return step
