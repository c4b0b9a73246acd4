"""Block-max metadata pass: per 32-slot row, the max doc-term weight, the
max valid docid and the first docid (K5).

Port of the tail of ds2i_tpu/engine/resident.py:_decode_slots_step (dmax,
dmin) and of _slots_weight_step (the max weight and the weight plane),
which both of the JAX engine's metadata passes run. Two input forms:

  rows    docs32 and w32 as a part's docs launch wrote them (the decode
          pass, ResidentEngine._ensure_blockmax); w is masked by
          doc < num_docs here, since pair mode writes it unmasked
  planes  doc and raw-freq planes of the collection (ResidentEngine.
          build_blockmax) with the per-doc BM25 denominators norm_den:
          w = f / (f + norm_den[clamp(doc)]) where doc < num_docs, else 0,
          one f32 add and one f32 divide as the decode kernels compute it,
          so the block maxima equal the served weights bit for bit; the
          w plane is returned too

`blockmax_rows_torch` is the plain PyTorch version (the tests and
chip_smoke.py hold the kernel to it). The wrapper `blockmax_rows` takes it
for CPU tensors only; on CUDA tensors it launches csrc/blockmax.cu once
(counted in `blockmax_rows.launches`) or raises.
"""

import torch

from .. import kernels

BLOCK = 32


def blockmax_rows_torch(docs32, vals32, num_docs, norm_den=None):
    """(wmax f32 (rows,), dmax int32 (rows,), dmin int32 (rows,), w f32
    (rows, 32) or None) of (rows, 32) docs32 and vals32: w32 (rows form,
    norm_den None; no w returned) or raw freqs (planes form). dmax is -1
    and wmax 0 for a row with no doc < num_docs; dmin is slot 0's doc."""
    valid = docs32 < num_docs
    w = None
    if norm_den is None:
        wm = torch.where(valid, vals32, 0.0)
    else:
        den = norm_den[docs32.long().clamp(0, num_docs - 1)]
        w = wm = torch.where(valid, vals32 / (vals32 + den), 0.0)
    if not len(docs32):
        z = docs32.new_zeros(0)
        return vals32.new_zeros(0), z, z.clone(), w
    dmax = torch.where(valid, docs32, -1).amax(dim=1)
    return wm.amax(dim=1), dmax, docs32[:, 0].contiguous(), w


def blockmax_rows(docs32, vals32, num_docs, norm_den=None):
    """blockmax_rows_torch's contract. CPU tensors take that plain
    version; CUDA tensors launch csrc/blockmax.cu once (counted in
    blockmax_rows.launches) writing fresh outputs, or raise."""
    if docs32.device.type == "cpu":
        return blockmax_rows_torch(docs32, vals32, num_docs, norm_den)
    if docs32.device.type != "cuda":
        raise ValueError(f"blockmax_rows runs on cuda or cpu, not {docs32.device}")
    dev = docs32.device
    for name, t, dtype in (("docs32", docs32, torch.int32), ("vals32", vals32, torch.float32),
                           ("norm_den", norm_den, torch.float32)):
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if docs32.dim() != 2 or docs32.shape[1] != BLOCK or vals32.shape != docs32.shape:
        raise ValueError(f"docs32 and vals32 must be (rows, {BLOCK}) alike, got "
                         f"{tuple(docs32.shape)} and {tuple(vals32.shape)}")
    if norm_den is not None and (norm_den.dim() != 1 or norm_den.shape[0] != num_docs
                                 or num_docs < 1):
        raise ValueError(f"norm_den must be ({num_docs},) with num_docs >= 1, got "
                         f"{tuple(norm_den.shape)}")
    rows = docs32.shape[0]
    wmax = torch.empty(rows, dtype=torch.float32, device=dev)
    dmax = torch.empty(rows, dtype=torch.int32, device=dev)
    dmin = torch.empty(rows, dtype=torch.int32, device=dev)
    w = None if norm_den is None else torch.empty_like(vals32)
    if not rows:
        return wmax, dmax, dmin, w
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = kernels.lib("blockmax")
    rc = lib.ds2i_blockmax_rows(
        docs32.data_ptr(), vals32.data_ptr(), ptr(norm_den), rows, int(num_docs),
        wmax.data_ptr(), dmax.data_ptr(), dmin.data_ptr(), ptr(w),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(lib, rc, "blockmax launch")
    blockmax_rows.launches += 1
    return wmax, dmax, dmin, w


blockmax_rows.launches = 0
