"""Block-codec stream decode: OptPFor full blocks and interpolative tails.

Port of the two jnp device ops that decode block indexes in the JAX
engine's split mode:

  K1  ds2i_tpu/ops/optpfor_device.py:optpfor_decode, the b_static path
      with resident exception patches (ex_patch=True) or no exceptions
      (E = 0), plus the assembly of engine/resident.py:_decode_block_stream
      (docs base-1+cumsum(gap+1), freqs raw+1) -> csrc/optpfor_decode.cu
  K2  ds2i_tpu/ops/interp_device.py:interp_decode, the stack-machine
      DFS, plus the same assembly (docs base+cum+j, freqs cum diff + 1)
      -> csrc/interp_decode.cu

`optpfor_decode_torch` and `interp_decode_torch` transcribe the JAX ops'
raw outputs; `block_stream_torch` adds the assembly and the pad mask
(docs slots j >= n_vals -> num_docs, freqs -> 0), so its (R, T) int32
result is the kernels' contract. The wrappers `optpfor_decode` and
`interp_decode` take that plain version for CPU tensors only; on CUDA
tensors they launch their kernel (one launch, counted in `.launches`)
or raise. `block_stream` picks the wrapper by the group's statics.

Words are int32 tensors holding the uint32 words' bits; the plain
versions widen them to int64 masked with 0xFFFFFFFF, so every shift and
mask is the unsigned 32-bit one of the JAX ops, and int32 sums wrap as
they do there.
"""

import torch

from .. import kernels
from ..engine.block_tiles import (
    BF_BOFF, BF_EX_BASE, BF_EX_W0, BF_NEX, BF_W0,
    _E_BUCKETS, _NC_BUCKETS, _WIN_BUCKETS,
)
from ..engine.tiles import F_BASE, F_NVALS, N_FIELDS, TILE
from .pair_decode import _gather_words

_M32 = 0xFFFFFFFF
DEPTH = 8  # interp_device.DEPTH: DFS stack depth for <= 128 values
ITEM8 = (
    "ROADMAP queue 1 item 8 (the block_varint, block_qmx and block_mixed "
    "decode kernels)"
)


def _i32(x):
    """int64 tensor -> the same values wrapped to signed 32 bits."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def optpfor_decode_torch(words, slot_w0, slot_boff, n_ex, ex_base, WS, E, b_static, T=TILE):
    """optpfor_decode(..., b_static=b_static, ex_patch=True) in plain
    PyTorch: (R, T) int32 raw slot values (gaps for docs, freq-1 for
    freqs). ex_base is each row's first patch-pair word (BF_EX_BASE);
    E = 0 applies no patches."""
    R = slot_w0.shape[0]
    nw = words.shape[0]
    dev = words.device
    j = torch.arange(T, device=dev, dtype=torch.int64)[None, :]

    widx = slot_w0.long()[:, None] + torch.arange(WS + 1, device=dev, dtype=torch.int64)[None, :]
    win = _gather_words(words, widx)  # (R, WS+1)
    bs = min(b_static, 32)
    s0 = slot_boff.long()[:, None]
    nxt = torch.cat([win[:, 1:], torch.zeros((R, 1), dtype=torch.int64, device=dev)], dim=1)
    aligned = (win >> s0) | torch.where(s0 > 0, (nxt << (32 - s0)) & _M32, 0)
    if bs == 0:
        out = torch.zeros((R, T), dtype=torch.int64, device=dev)
    else:
        bit = torch.arange(T, device=dev, dtype=torch.int64) * bs
        lo = bit >> 5
        hi = (lo + 1).clamp(max=WS)
        sh = (bit & 31)[None, :]
        x = (aligned[:, lo] >> sh) | torch.where(sh > 0, (aligned[:, hi] << (32 - sh)) & _M32, 0)
        out = x & (_M32 if bs >= 32 else (1 << bs) - 1)

    if E > 0:
        # patch entry e of row r: words [ex_base + 2e] = slot position,
        # [+1] = high << b; a sum over the hits, as the JAX op takes it
        ee = torch.arange(E, device=dev, dtype=torch.int64)[None, :]
        pidx = (ex_base.long()[:, None] + 2 * ee).clamp(0, max(nw - 2, 0))
        pos = _i32(_gather_words(words, pidx))
        add = _gather_words(words, pidx + 1)
        evalid = ee < n_ex.long()[:, None]
        hit = (j[:, :, None] == pos[:, None, :]) & evalid[:, None, :]
        out = out | (torch.where(hit, add[:, None, :], 0).sum(dim=2) & _M32)
    return out.int()


def _lane(arr, idx):
    """arr (R, width) at per-row idx; 0 where idx is out of range (the JAX
    op's comparison-reduce)."""
    width = arr.shape[1]
    ok = (idx >= 0) & (idx < width)
    got = arr.gather(1, idx.clamp(0, width - 1)[:, None])[:, 0]
    return torch.where(ok, got, 0)


def _set_lane(arr, idx, val, mask):
    """arr with arr[r, idx[r]] = val[r] where mask[r] and idx[r] is in
    range (a write out of range is dropped, as in the JAX op)."""
    width = arr.shape[1]
    ok = mask & (idx >= 0) & (idx < width)
    ic = idx.clamp(0, width - 1)[:, None]
    cur = arr.gather(1, ic)[:, 0]
    return arr.scatter(1, ic, torch.where(ok, val, cur)[:, None])


def _read_bits(win, pos, width):
    """win (R, W) uint32 words in int64, LSB first; per-row bit pos and
    width (<= 31). A word index outside the window reads 0."""
    w0i = pos >> 5
    s = pos & 31
    w0 = _lane(win, w0i)
    w1 = _lane(win, w0i + 1)
    x = (w0 >> s) | torch.where(s > 0, (w1 << (32 - s)) & _M32, 0)
    mask = torch.where(width >= 32, _M32, (1 << width.clamp(0, 31)) - 1)
    return x & mask


def _msb(u):
    """floor(log2(u)) of int64 values in [1, 2^32)."""
    r = torch.zeros_like(u)
    x = u
    for s in (16, 8, 4, 2, 1):
        m = (x >> s) > 0
        r = r + torch.where(m, s, 0)
        x = torch.where(m, x >> s, x)
    return r


def interp_decode_torch(win, rel0, n, sums, NC, W, steps):
    """interp_decode in plain PyTorch: win (R, W) stream words (int32 bits
    or int64 uint32 values), rel0/n/sums (R,). Returns (R, NC) int32
    prefix sums cum[0..n-1] (cum[n-1] == sums; lanes >= n are 0)."""
    win = win.long() & _M32
    R = win.shape[0]
    dev = win.device
    VW = NC + 2  # vals: [global-low=0, cum[0..NC-1], pad]
    n = n.long()
    lanes = torch.arange(VW, device=dev, dtype=torch.int64)[None, :]
    vals = torch.where(lanes == n[:, None], sums.long()[:, None], 0)
    lo_s = torch.zeros((R, DEPTH), dtype=torch.int64, device=dev)
    hi_s = torch.zeros((R, DEPTH), dtype=torch.int64, device=dev)
    hi_s[:, 0] = n - 1
    sp = (n > 1).long()
    bitpos = rel0.long()

    for _ in range(steps):
        active = sp > 0
        idx = (sp - 1).clamp(min=0)
        lo = _lane(lo_s, idx)
        hi = _lane(hi_s, idx)
        sp1 = sp - active.long()

        h = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        low = _lane(vals, lo)  # vals[lo] == cum[lo-1] (lane shift)
        high = _lane(vals, hi + 1)  # vals[hi+1] == cum[hi]
        u = (high - low + 1) & _M32
        b = _msb(u.clamp(min=1))
        m = ((1 << (b + 1)) - u) & _M32  # b = 31: 0 - u, the u32 shift's 0

        x = _read_bits(win, bitpos, b)
        bp1 = bitpos + torch.where(active, b, 0)
        extra = _read_bits(win, bp1, torch.ones_like(b))
        wide = x >= m
        code = torch.where(wide, ((x << 1) + extra - m) & _M32, x)
        bp2 = bp1 + (active & wide).long()

        val = _i32(low + _i32(code))
        vals = _set_lane(vals, h + 1, val, active)

        # push right child (h+1, hi) then left (lo, h); left pops first
        push_r = active & (hi - h - 1 > 0)
        lo_s = _set_lane(lo_s, sp1, h + 1, push_r)
        hi_s = _set_lane(hi_s, sp1, hi, push_r)
        sp2 = sp1 + push_r.long()
        push_l = active & (h - lo > 0)
        lo_s = _set_lane(lo_s, sp2, lo, push_l)
        hi_s = _set_lane(hi_s, sp2, h, push_l)
        sp = sp2 + push_l.long()
        bitpos = bp2
    return vals[:, 1:NC + 1].int()


def block_stream_torch(words, fld, st, num_docs, is_docs):
    """One stream of one block group in plain PyTorch: (R, T) int32 docids
    (is_docs; pads -> num_docs) or freqs (pads -> 0). st is the group's
    statics: ("opt", b, 0, 128), ("optp", b, E, 128) or ("interp", W, T)
    (resident.py:_decode_block_stream and the pad mask of
    _decode_doc_group_blocks / _decode_freq_group_blocks)."""
    kind, T = st[0], st[-1]
    f = fld.long()
    dev = words.device
    j = torch.arange(T, device=dev, dtype=torch.int64)[None, :]
    col = lambda c: f[:, c, None]  # noqa: E731
    if kind in ("opt", "optp"):
        b, E = st[1], st[2]
        if kind == "opt" and E > 0:
            raise NotImplementedError(
                "the in-pass Simple16 exception decode is not ported; block "
                "indexes decode exceptions from resident patch words (\"optp\")")
        ws = (31 + T * min(b, 32)) // 32 + 1
        raw = optpfor_decode_torch(
            words, f[:, BF_W0], f[:, BF_BOFF], f[:, BF_NEX], f[:, BF_EX_BASE],
            ws, E, b, T).long()
        val = col(F_BASE) - 1 + torch.cumsum(raw + 1, dim=1) if is_docs else raw + 1
    elif kind == "interp":
        W = st[1]
        widx = col(BF_W0) + torch.arange(W, device=dev, dtype=torch.int64)[None, :]
        win = _gather_words(words, widx)
        cum = interp_decode_torch(
            win, f[:, BF_BOFF], f[:, F_NVALS], f[:, BF_EX_W0], NC=T, W=W, steps=T - 1).long()
        if is_docs:
            val = col(F_BASE) - 1 + cum + j + 1
        else:
            prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
            val = cum - prev + 1
    else:
        raise NotImplementedError(f"block stream kind {kind!r} waits for {ITEM8}")
    valid = j < col(F_NVALS)
    return torch.where(valid, _i32(val), num_docs if is_docs else 0).int()


def _check_cuda_args(words, fld):
    for name, t in (("words", words), ("fld", fld)):
        if t.device != words.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous int32 tensors on {words.device}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if words.dim() != 1 or words.numel() == 0:
        raise ValueError("words must be a non-empty 1-D word array")
    if fld.dim() != 2 or fld.shape[1] != N_FIELDS:
        raise ValueError(f"fld must be (R, {N_FIELDS}), got {tuple(fld.shape)}")


def _launch(wrapper, words, fld, T, num_docs, is_docs, p1, p2):
    """One launch of the kernel of csrc/<wrapper name>.cu: (R, T) int32
    on the current stream."""
    _check_cuda_args(words, fld)
    name = wrapper.__name__
    lib = kernels.lib(name)
    R = fld.shape[0]
    out = torch.empty((R, T), dtype=torch.int32, device=words.device)
    rc = getattr(lib, kernels.ENTRY_POINTS[name][0])(
        words.data_ptr(), words.numel(), fld.data_ptr(), R, p1, p2, T,
        int(bool(is_docs)), int(num_docs), out.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream,
    )
    kernels.check(lib, rc, f"{name} launch")
    wrapper.launches += 1
    return out


def optpfor_decode(words, fld, st, num_docs, is_docs):
    """block_stream_torch's contract for an ("opt", b, 0, 128) or ("optp",
    b, E, 128) group. CPU tensors take the plain version; CUDA tensors
    launch csrc/optpfor_decode.cu (counted in optpfor_decode.launches) or
    raise."""
    if words.device.type == "cpu":
        return block_stream_torch(words, fld, st, num_docs, is_docs)
    if words.device.type != "cuda":
        raise ValueError(f"optpfor_decode runs on cuda or cpu, not {words.device}")
    kind, b, E, T = st
    if kind not in ("opt", "optp") or T != TILE or not 0 <= b <= 32:
        raise ValueError(f"optpfor_decode takes (\"opt\"|\"optp\", b in 0..32, E, 128), got {st}")
    if E not in _E_BUCKETS or (kind == "opt" and E > 0):
        raise ValueError(f"E={E}: \"optp\" takes E in {_E_BUCKETS}, \"opt\" only E=0")
    return _launch(optpfor_decode, words, fld, T, num_docs, is_docs, b, E)


def interp_decode(words, fld, st, num_docs, is_docs):
    """block_stream_torch's contract for an ("interp", W, T) group. CPU
    tensors take the plain version; CUDA tensors launch
    csrc/interp_decode.cu (counted in interp_decode.launches) or raise."""
    if words.device.type == "cpu":
        return block_stream_torch(words, fld, st, num_docs, is_docs)
    if words.device.type != "cuda":
        raise ValueError(f"interp_decode runs on cuda or cpu, not {words.device}")
    kind, W, T = st
    if kind != "interp" or W not in _WIN_BUCKETS or T not in _NC_BUCKETS:
        raise ValueError(
            f"interp_decode takes (\"interp\", W in {_WIN_BUCKETS}, T in {_NC_BUCKETS}), got {st}")
    return _launch(interp_decode, words, fld, T, num_docs, is_docs, W, 0)


optpfor_decode.launches = 0
interp_decode.launches = 0


def block_stream(words, fld, st, num_docs, is_docs):
    """One stream of one block group through its kernel's wrapper (the
    JAX engine's resident.py:_decode_block_stream): (R, T) int32, pads
    masked."""
    if st[0] in ("opt", "optp"):
        return optpfor_decode(words, fld, st, num_docs, is_docs)
    if st[0] == "interp":
        return interp_decode(words, fld, st, num_docs, is_docs)
    raise NotImplementedError(f"block stream kind {st[0]!r} waits for {ITEM8}")
