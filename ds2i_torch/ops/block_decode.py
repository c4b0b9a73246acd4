"""Block-codec stream decode: OptPFor, Varint-G8IU and QMX full blocks,
interpolative full blocks and tails.

Port of the four jnp device ops that decode block indexes in the JAX
engine's split mode:

  K1  ds2i_tpu/ops/optpfor_device.py:optpfor_decode, the b_static path
      with resident exception patches (ex_patch=True) or no exceptions
      (E = 0), plus the assembly of engine/resident.py:_decode_block_stream
      (docs base-1+cumsum(gap+1), freqs raw+1) -> csrc/optpfor_decode.cu
  K1s the same op's in-pass Simple16 exception decode (ex_patch=False,
      E > 0: the engine's ("opt", b, E, 128) groups past the resident word
      limit), plus the same assembly -> csrc/optpfor_s16_decode.cu
  K7  ds2i_tpu/ops/varint_device.py:varint_decode, plus the same assembly
      -> csrc/varint_decode.cu
  K8  ds2i_tpu/ops/qmx_device.py:qmx_decode, plus the same assembly
      -> csrc/qmx_decode.cu
  K2  ds2i_tpu/ops/interp_device.py:interp_decode, the stack-machine
      DFS, plus its assembly (docs base+cum+j, freqs cum diff + 1)
      -> csrc/interp_decode.cu

`optpfor_decode_torch`, `optpfor_inpass_decode_torch`,
`varint_decode_torch`, `qmx_decode_torch` and `interp_decode_torch`
transcribe the JAX ops' raw outputs;
`block_stream_torch` adds the assembly and the pad mask (docs slots j >=
n_vals -> num_docs, freqs -> 0) for one group.

A part decodes in one launch per kernel and stream (freqs first, only
for BM25 weights; then docs), over every group of the part: the host
plan's PartLayout holds each launch's CTA table (cta_table), and the
kernels write 32-slot block rows straight into the part's tensors, the
narrow-tail pad, the freq realign (blkperm), the norm-cache den rows
and the weight w = f / (f + den) included (the JAX engine's
resident.py:_decode_weight_blocks split branch and _decode_part's pad).
`split_decode_part_torch` is that whole decode in plain PyTorch, from
the per-group block_stream_torch; `decode_launch_torch` is what one
launch writes. The wrappers `optpfor_decode`, `optpfor_s16_decode`,
`varint_decode`, `qmx_decode` and `interp_decode` (one launch each,
counted in `.launches`) and `split_decode_part` take those plain
versions for CPU tensors only; on CUDA tensors they launch the
kernels or raise. PartLayout and cta_table also lay out pair mode's
one launch a part (ops/pair_decode.py).

Words are int32 tensors holding the uint32 words' bits; the plain
versions widen them to int64 masked with 0xFFFFFFFF, so every shift and
mask is the unsigned 32-bit one of the JAX ops, and int32 sums wrap as
they do there.
"""

import numpy as np
import torch

from .. import kernels
from ..codecs.qmx import ADV_OF_TYPE, INTS_OF_TYPE, LANE_TABLE
from ..codecs.simple16 import S16_MODES
from ..engine.block_tiles import (
    BF_B, BF_BOFF, BF_EX_BASE, BF_EX_BOFF, BF_EX_W0, BF_NEX, BF_W0,
    _E_BUCKETS, _G_BUCKETS, _NC_BUCKETS, _NW_BUCKETS, _S_BUCKETS, _WIN_BUCKETS,
)
from ..engine.tiles import F_BASE, F_NVALS, N_FIELDS, TILE
from . import pair_decode  # its names are read at call time: engine imports this module

_M32 = 0xFFFFFFFF
DEPTH = 8  # interp_device.DEPTH: DFS stack depth for <= 128 values
QMX_TYPES = len(INTS_OF_TYPE)  # 15 width classes


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
    win = pair_decode._gather_words(words, widx)  # (R, WS+1)
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
        pos = _i32(pair_decode._gather_words(words, pidx))
        add = pair_decode._gather_words(words, pidx + 1)
        evalid = ee < n_ex.long()[:, None]
        hit = (j[:, :, None] == pos[:, None, :]) & evalid[:, None, :]
        out = out | (torch.where(hit, add[:, None, :], 0).sum(dim=2) & _M32)
    return out.int()


# Simple16's 16 selector modes as (16, 28) per-slot shift and width
# tables (0 past a mode's count) and the count of each mode
_S16_COUNT = torch.tensor([sum(c for c, _ in m) for m in S16_MODES], dtype=torch.int64)
_S16_WIDTH = torch.zeros((16, 28), dtype=torch.int64)
for _m, _mode in enumerate(S16_MODES):
    _ws = [bits for cnt, bits in _mode for _ in range(cnt)]
    _S16_WIDTH[_m, :len(_ws)] = torch.tensor(_ws)
_S16_SHIFT = torch.cumsum(_S16_WIDTH, dim=1) - _S16_WIDTH


def optpfor_inpass_decode_torch(words, slot_w0, slot_boff, b, n_ex, ex_w0, ex_boff, WS, E,
                                b_static, T=TILE):
    """optpfor_decode(..., b_static=b_static, ex_patch=False) in plain
    PyTorch: (R, T) int32 raw slot values, the exceptions decoded in the
    pass. Each row reads K = 2E Simple16 words at word ex_w0, bit ex_boff
    (< 32; stream indices clamped to the stream), unpacks every word by
    its selector's mode, and places value q of the stream at index
    base + q (base: the values of the words before it); indices >= K
    drop, indices no word reaches read 0. Positions are the int32 cumsum
    of (first, gaps + 1) over the first E values; exception e < n_ex
    takes the high at stream index n_ex + e (0 where that is >= K) plus
    1, shifted by clip(b, 0, 31) (the row's BF_B, not b_static), and the
    sum of those at each slot position is ORed into the slot."""
    out = optpfor_decode_torch(words, slot_w0, slot_boff, n_ex, ex_w0, WS, 0, b_static, T).long()
    out = out & _M32
    if E == 0:
        return _i32(out).int()
    R = slot_w0.shape[0]
    dev = words.device
    K = 2 * E
    w = pair_decode._gather_words(
        words, ex_w0.long()[:, None] + torch.arange(K + 1, device=dev, dtype=torch.int64)[None, :])
    s = ex_boff.long()[:, None]
    xw = (w[:, :K] >> s) | torch.where(s > 0, (w[:, 1:] << (32 - s)) & _M32, 0)
    sel = xw >> 28
    payload = xw & 0x0FFFFFFF
    cnt = _S16_COUNT.to(dev)[sel]  # (R, K)
    val = (payload[:, :, None] >> _S16_SHIFT.to(dev)[sel]) & ((1 << _S16_WIDTH.to(dev)[sel]) - 1)
    slot = torch.arange(28, device=dev, dtype=torch.int64)[None, None, :]
    sidx = (torch.cumsum(cnt, dim=1) - cnt)[:, :, None] + slot  # stream index of each value
    keep = (slot < cnt[:, :, None]) & (sidx < K)
    elem = torch.zeros((R, K + 1), dtype=torch.int64, device=dev)
    elem.scatter_add_(1, torch.where(keep, sidx, K).reshape(R, -1),
                      torch.where(keep, val, 0).reshape(R, -1))
    elem = elem[:, :K]

    steps = torch.cat([elem[:, :1], elem[:, 1:E] + 1], dim=1)
    pos = _i32(torch.cumsum(steps, dim=1))  # (R, E), int32 wrapping as in the JAX op
    ee = torch.arange(E, device=dev, dtype=torch.int64)[None, :]
    want = n_ex.long()[:, None] + ee
    high = torch.where((want >= 0) & (want < K), elem.gather(1, want.clamp(0, K - 1)), 0) + 1
    add = (high << b.long().clamp(0, 31)[:, None]) & _M32
    evalid = ee < n_ex.long()[:, None]
    j = torch.arange(T, device=dev, dtype=torch.int64)[None, :, None]
    hit = (j == pos[:, None, :]) & evalid[:, None, :]
    out = out | (torch.where(hit, add[:, None, :], 0).sum(dim=2) & _M32)
    return _i32(out).int()


def varint_decode_torch(words, w0, boff, ngroups, G, T=TILE):
    """varint_decode in plain PyTorch: (R, T) int32 raw values of full
    Varint-G8IU blocks (gaps for docs, freq-1 for freqs). Group g < G
    (and < ngroups) is one descriptor byte, whose bit i marks data byte i
    as an integer's last, and 8 data bytes, read from the (9G+7)//4 + 2
    words at w0 shifted down by boff bits. A byte adds data << 8*wpos
    (wpos: its place in its integer; 0 where 8*wpos >= 32, as XLA shifts)
    to output out_idx (the end markers before it) when its integer ends
    inside its group; slots no integer reaches stay 0."""
    R = w0.shape[0]
    dev = words.device
    WB = (G * 9 + 7) // 4 + 2
    win = pair_decode._gather_words(
        words, w0.long()[:, None] + torch.arange(WB, device=dev, dtype=torch.int64)[None, :])
    s = boff.long()[:, None]
    nxt = torch.cat([win[:, 1:], torch.zeros((R, 1), dtype=torch.int64, device=dev)], dim=1)
    aligned = (win >> s) | torch.where(s > 0, (nxt << (32 - s)) & _M32, 0)
    k = torch.arange(9 * G, device=dev, dtype=torch.int64)
    byte = ((aligned[:, k >> 2] >> (8 * (k & 3))[None, :]) & 0xFF).reshape(R, G, 9)
    desc, data = byte[:, :, 0], byte[:, :, 1:].reshape(R, 8 * G)
    gvalid = torch.arange(G, device=dev)[None, :] < ngroups.long()[:, None]
    bit = torch.arange(8, device=dev, dtype=torch.int64)
    ends = (((desc[:, :, None] >> bit) & 1) > 0) & gvalid[:, :, None]  # (R, G, 8)
    flat_ends = ends.reshape(R, 8 * G).long()
    cume = torch.cumsum(flat_ends, dim=1)
    out_idx = cume - flat_ends
    # byte place within its integer: bytes since the group's last end
    run = torch.zeros((R, G), dtype=torch.int64, device=dev)
    cols = []
    for i in range(8):
        cols.append(run)
        run = torch.where(ends[:, :, i], 0, run + 1)
    wpos = torch.stack(cols, dim=2).reshape(R, 8 * G)
    gend = cume.reshape(R, G, 8)[:, :, 7:].expand(R, G, 8).reshape(R, 8 * G)
    ok = (out_idx < gend) & (out_idx < T) & gvalid.repeat_interleave(8, dim=1)
    contrib = torch.where(ok & (wpos < 4), data << (8 * wpos.clamp(max=3)), 0)
    out = torch.zeros((R, T + 1), dtype=torch.int64, device=dev)
    out.scatter_add_(1, torch.where(ok, out_idx, T), contrib)
    return _i32(out[:, :T] & _M32).int()


_QMX_INTS = torch.tensor(INTS_OF_TYPE, dtype=torch.int64)
_QMX_ADV = torch.tensor(ADV_OF_TYPE, dtype=torch.int64)
_QMX_TAB = torch.from_numpy(LANE_TABLE.astype(np.int64))  # (15, 256, 4)


def _extract(words, w_base, bitoff, width):
    """qmx_device._extract: `width` bits at bit `bitoff` past word w_base
    (indices clamped to the stream), as uint32 values in int64; all 32
    bits for a width of 32 or more."""
    w0i = w_base + (bitoff >> 5)
    s = bitoff & 31
    lo = pair_decode._gather_words(words, w0i)
    hi = pair_decode._gather_words(words, w0i + 1)
    x = (lo >> s) | torch.where(s > 0, (hi << (32 - s)) & _M32, 0)
    return x & torch.where(width >= 32, _M32, (1 << width.clamp(0, 31)) - 1)


def qmx_decode_torch(words, pay_w0, pay_boff, ninst, sel_w0, sel_b, nsel, NI, S, T=TILE):
    """qmx_decode in plain PyTorch: (R, T) int32 raw values of full QMX
    blocks in the reference byte format. The first min(nsel, S) selector
    bytes, walking back from byte sel_b of word sel_w0, give (type, batch)
    runs; instance i < NI takes the type of the run covering it, and (for
    i < ninst) INTS_OF_TYPE outputs and ADV_OF_TYPE payload bytes. Slot v
    reads its instance's LANE_TABLE entry from the payload at (pay_w0,
    pay_boff); type 0 gives 1. A type index past the table clamps to its
    last class, as XLA's gather does."""
    R = pay_w0.shape[0]
    dev = words.device
    ints_of, adv_of, tab = _QMX_INTS.to(dev), _QMX_ADV.to(dev), _QMX_TAB.to(dev)
    bk = sel_b.long()[:, None] - torch.arange(S, device=dev, dtype=torch.int64)[None, :]
    wsel = pair_decode._gather_words(words, sel_w0.long()[:, None] + (bk >> 2))
    sel = (wsel >> ((bk & 3) * 8)) & 0xFF
    svalid = torch.arange(S, device=dev)[None, :] < nsel.long()[:, None]
    t_s = torch.where(svalid, sel >> 4, 0)
    batch_s = torch.where(svalid, 16 - (sel & 15), 0)

    cum = torch.cumsum(batch_s, dim=1)
    ii = torch.arange(NI, device=dev, dtype=torch.int64)[None, :, None]
    cover = (ii < cum[:, None, :]) & (ii >= (cum - batch_s)[:, None, :])
    t_i = torch.where(cover, t_s[:, None, :], 0).sum(dim=2)  # (R, NI)
    ivalid = torch.arange(NI, device=dev)[None, :] < ninst.long()[:, None]
    tc = t_i.clamp(0, QMX_TYPES - 1)
    ints_i = torch.where(ivalid, ints_of[tc], 0)
    adv_i = torch.where(ivalid, adv_of[tc], 0)
    out_base = torch.cumsum(ints_i, dim=1) - ints_i
    pay_byte = torch.cumsum(adv_i, dim=1) - adv_i

    v = torch.arange(T, device=dev, dtype=torch.int64)[None, :]
    le = (out_base[:, None, :] <= v[:, :, None]) & ivalid[:, None, :]  # (R, T, NI)
    inst = (le.sum(dim=2) - 1).clamp(0, NI - 1)
    t_v = t_i.gather(1, inst)
    b_v = out_base.gather(1, inst)
    p_v = pay_byte.gather(1, inst)
    j = (v - b_v).clamp(0, 255)
    lane = tab[t_v.clamp(0, QMX_TYPES - 1), j]  # (R, T, 4)
    ba, wa, bb, wb = lane.unbind(dim=2)
    base_bits = pay_boff.long()[:, None] + p_v * 8
    wbase = pay_w0.long()[:, None]
    a = _extract(words, wbase, base_bits + ba, wa)
    b = torch.where(wb > 0, _extract(words, wbase, base_bits + bb, wb), 0)
    val = a | ((b << wa.clamp(0, 31)) & _M32)
    return torch.where(t_v == 0, 1, _i32(val)).int()


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
    statics: ("opt", b, E, 128) (E > 0: the exceptions decoded in the
    pass), ("optp", b, E, 128), ("var", G, 128),
    ("qmx", NI, S, 128) or ("interp", W, T) (resident.py:
    _decode_block_stream and the pad mask of _decode_doc_group_blocks /
    _decode_freq_group_blocks)."""
    kind, T = st[0], st[-1]
    f = fld.long()
    dev = words.device
    j = torch.arange(T, device=dev, dtype=torch.int64)[None, :]
    col = lambda c: f[:, c, None]  # noqa: E731
    if kind in ("opt", "optp", "var", "qmx"):
        if kind == "var":
            raw = varint_decode_torch(words, f[:, BF_W0], f[:, BF_BOFF], f[:, BF_B], st[1], T)
        elif kind == "qmx":
            raw = qmx_decode_torch(words, f[:, BF_W0], f[:, BF_BOFF], f[:, BF_B], f[:, BF_EX_W0],
                                   f[:, BF_EX_BOFF], f[:, BF_NEX], st[1], st[2], T)
        else:
            b, E = st[1], st[2]
            ws = (31 + T * min(b, 32)) // 32 + 1
            if kind == "opt" and E > 0:
                raw = optpfor_inpass_decode_torch(
                    words, f[:, BF_W0], f[:, BF_BOFF], f[:, BF_B], f[:, BF_NEX], f[:, BF_EX_W0],
                    f[:, BF_EX_BOFF], ws, E, b, T)
            else:
                raw = optpfor_decode_torch(
                    words, f[:, BF_W0], f[:, BF_BOFF], f[:, BF_NEX], f[:, BF_EX_BASE],
                    ws, E, b, T)
        raw = raw.long()
        val = col(F_BASE) - 1 + torch.cumsum(raw + 1, dim=1) if is_docs else raw + 1
    elif kind == "interp":
        W = st[1]
        widx = col(BF_W0) + torch.arange(W, device=dev, dtype=torch.int64)[None, :]
        win = pair_decode._gather_words(words, widx)
        cum = interp_decode_torch(
            win, f[:, BF_BOFF], f[:, F_NVALS], f[:, BF_EX_W0], NC=T, W=W, steps=T - 1).long()
        if is_docs:
            val = col(F_BASE) - 1 + cum + j + 1
        else:
            prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
            val = cum - prev + 1
    else:
        raise ValueError(f"unknown block stream kind {kind!r}")
    valid = j < col(F_NVALS)
    return torch.where(valid, _i32(val), num_docs if is_docs else 0).int()


# -- the part-level decode ---------------------------------------------------
#
# One launch of each kernel per stream of a part (csrc/common.cuh; pair
# mode: one launch of pair_decode for both streams): a CTA table lists
# every CTA's rows, each inside one group, and the kernels write 32-slot
# block rows straight into the part's tensors, pads, the freq realign, the
# den rows and the weights included.

BLOCK = 32
PAIR_ROWS = 16  # rows per pair_decode CTA, two a warp (csrc/pair_decode.cu kRows)
K1_ROWS = 8  # rows per K1 CTA, one warp each (csrc/optpfor_decode.cu kWarps)
K1S_ROWS = 8  # rows per K1s CTA, one warp each (csrc/optpfor_s16_decode.cu kWarps)
K2_ROWS = 32  # rows per K2 CTA, one thread each (csrc/interp_decode.cu kRows)
K7_ROWS = 8  # rows per K7 CTA, one warp each (csrc/varint_decode.cu kWarps)
K8_ROWS = 8  # rows per K8 CTA, one warp each (csrc/qmx_decode.cu kWarps)
ROWS_PER_CTA = {"pair": PAIR_ROWS, "optpfor": K1_ROWS, "optpfor_s16": K1S_ROWS,
                "varint": K7_ROWS, "qmx": K8_ROWS, "interp": K2_ROWS}
CTA_FIELDS = 6  # [p1, p2, T, row0, nrows, blk0]
MODES = {"freqs": 0, "docs": 1, "presence": 2, "bm25": 3}  # csrc/common.cuh Mode
# the split-mode kernels, in launch order
KERNELS = ("optpfor", "optpfor_s16", "varint", "qmx", "interp")
PAIR_MAX_W = 1024  # W and WL of a pair group (csrc/pair_decode.cu kMaxW)


def _kernel_of(st):
    """Which kernel decodes a group of statics st."""
    if st[0] == "ef":
        if (st[-1] not in (32, 64, 128) or not 1 <= st[1] <= PAIR_MAX_W
                or not 0 <= st[2] <= PAIR_MAX_W):
            raise ValueError(f"pair_decode takes (\"ef\", W in 1..{PAIR_MAX_W}, WL in "
                             f"0..{PAIR_MAX_W}, T in (32, 64, 128)), got {st}")
        return "pair"
    if st[0] in ("opt", "optp"):
        if len(st) != 4 or st[-1] != TILE or not 0 <= st[1] <= 32 or st[2] not in _E_BUCKETS:
            raise ValueError(f"optpfor_decode takes (\"opt\"|\"optp\", b in 0..32, E in "
                             f"{_E_BUCKETS}, 128), got {st}")
        # exceptions decoded in the pass: K1s; from resident patches or none: K1
        return "optpfor_s16" if st[0] == "opt" and st[2] > 0 else "optpfor"
    if st[0] == "var":
        if len(st) != 3 or st[-1] != TILE or st[1] not in _G_BUCKETS:
            raise ValueError(f"varint_decode takes (\"var\", G in {_G_BUCKETS}, 128), got {st}")
        return "varint"
    if st[0] == "qmx":
        if len(st) != 4 or st[-1] != TILE or st[1] not in _NW_BUCKETS or st[2] not in _S_BUCKETS:
            raise ValueError(f"qmx_decode takes (\"qmx\", NI in {_NW_BUCKETS}, S in "
                             f"{_S_BUCKETS}, 128), got {st}")
        return "qmx"
    if st[0] == "interp":
        if st[1] not in _WIN_BUCKETS or st[2] not in _NC_BUCKETS:
            raise ValueError(f"interp_decode takes (\"interp\", W in {_WIN_BUCKETS}, T in "
                             f"{_NC_BUCKETS}), got {st}")
        return "interp"
    raise ValueError(f"unknown group statics {st}")


def cta_table(groups, kernel):
    """The CTA table of one kernel over one stream's groups ((off, R, st)
    in group-major row order, as _order_groups lays them out): int32
    (n, CTA_FIELDS) rows [p1, p2, T, row0, nrows, blk0], each CTA's rows
    inside one group; the CTAs of the longest rows first (stable): K2's
    by T, pair_decode's by T, then W + WL. Returns (table, total blocks
    of the stream)."""
    rows_per = ROWS_PER_CTA[kernel]
    ents, blk = [], 0
    for off, R, st in groups:
        T = st[-1]
        bpt = max(T // BLOCK, 1)
        if _kernel_of(st) == kernel:
            # EF pair (W, WL), OptPFor (b, E), QMX (NI, S); Varint-G8IU (G, 0),
            # interpolative (W, 0)
            p1, p2 = (st[1], st[2]) if st[0] in ("ef", "opt", "optp", "qmx") else (st[1], 0)
            ents += [(p1, p2, T, off + r0, min(rows_per, R - r0), blk + r0 * bpt)
                     for r0 in range(0, R, rows_per)]
        blk += R * bpt
    tab = np.array(ents, dtype=np.int64).reshape(-1, CTA_FIELDS)
    if kernel == "interp":
        tab = tab[np.argsort(-tab[:, 2], kind="stable")]
    elif kernel == "pair":
        tab = tab[np.lexsort((-(tab[:, 0] + tab[:, 1]), -tab[:, 2]))]
    if tab.size and tab.max() >= 2**31:
        raise ValueError("a part's rows or blocks pass 2^31")
    return tab.astype(np.int32), blk


class Launch:
    """One kernel's launch over one stream of a part: its CTA table on the
    host, its copy on one device, and the launch sizes (max_w: K2's
    largest window, pair_decode's largest W + WL + 1 staged words and T
    slots of a stream; 0 and 128 for the full-block kernels)."""

    def __init__(self, kernel, host, dev):
        self.kernel, self.host, self.dev = kernel, host, dev
        self.n_cta = len(host)
        h = host.astype(np.int64)
        # the blocks the launch writes end before end_blk
        ends = h[:, 5] + h[:, 4] * np.maximum(h[:, 2] // BLOCK, 1)
        self.end_blk = int(ends.max()) if self.n_cta else 0
        if kernel in ("optpfor", "optpfor_s16", "varint", "qmx"):  # full 128-slot blocks
            self.max_w, self.max_t = 0, TILE
        elif kernel == "pair":
            self.max_w = int((h[:, 0] + h[:, 1] + 1 + h[:, 2]).max()) if self.n_cta else 0
            self.max_t = int(h[:, 2].max()) if self.n_cta else BLOCK
        else:
            self.max_w = int(host[:, 0].max()) if self.n_cta else 1
            self.max_t = int(host[:, 2].max()) if self.n_cta else 1


class PartLayout:
    """One part's decode: the docs- and freqs-order groups and the CTA
    table of each kernel and stream, built once on the host with the plan
    and uploaded once per device. An EF-family part (pair mode: statics
    ("ef", W, WL, T), no freqs-order groups) has one table, pair_decode's
    over both streams; a block part (split mode) one per kernel and
    stream."""

    def __init__(self, groups, groups_f=()):
        self.groups, self.groups_f = tuple(groups), tuple(groups_f)
        kinds = {_kernel_of(st) for _, _, st in self.groups + self.groups_f}
        self.pair = "pair" in kinds
        if self.pair and (len(kinds) > 1 or self.groups_f):
            raise ValueError("a part is either EF pair groups alone or block groups")
        self.tables = {}
        for is_docs, grp in ((True, self.groups), (False, self.groups_f)):
            for kernel in ("pair",) + KERNELS:
                if kernel == "pair" and not is_docs:
                    continue
                self.tables[kernel, is_docs], nb = cta_table(grp, kernel)
            if is_docs:
                self.nb_d = nb
            else:
                self.nb_f = nb
        self._launches = {}

    def upload(self, device):
        """Every non-empty CTA table to `device` (once; later calls find
        them). Returns the bytes this call copied."""
        nbytes = 0
        for (kernel, is_docs), host in self.tables.items():
            if len(host) and (kernel, is_docs, str(device)) not in self._launches:
                self.launch(kernel, is_docs, device)
                nbytes += host.nbytes
        return nbytes

    def launch(self, kernel, is_docs, device):
        key = (kernel, is_docs, str(device))
        if key not in self._launches:
            host = self.tables[kernel, is_docs]
            self._launches[key] = Launch(kernel, host, torch.from_numpy(host).to(device))
        return self._launches[key]


def den_rows(den_blocks, tile_gblk0, ids, T):
    """BM25-denominator rows of one group from the norm cache (the JAX
    engine's resident.py:_cached_den_rows): rows of tile t live at
    [tile_gblk0[t], +bpt) in den_blocks."""
    bpt = max(T // BLOCK, 1)
    idx = tile_gblk0[ids][:, None] + torch.arange(bpt, device=ids.device)[None, :]
    return den_blocks[idx.reshape(-1)]


def _group_blocks(words, fld, st, num_docs, is_docs):
    """One group's stream as masked 32-slot block rows; narrow tails
    (T < 32) pad to one block with num_docs (docs) or 0 (freqs)."""
    v = block_stream_torch(words, fld, st, num_docs, is_docs)
    if st[-1] < BLOCK:
        v = torch.nn.functional.pad(v, (0, BLOCK - st[-1]), value=num_docs if is_docs else 0)
    return v.reshape(-1, BLOCK)


def _weights(docs32, num_docs, weights, freq32=None, den=None):
    if weights == "presence":
        return torch.where(docs32 < num_docs, 1.0, 0.0)
    # one f32 add + one f32 divide (IEEE, rounded to nearest)
    return torch.where(docs32 < num_docs, freq32 / (freq32 + den), 0.0)


def split_decode_part_torch(words, tiles_docs, tiles_freqs, gtile_ids, gtile_f, blkperm,
                            layout, num_docs, weights, den_blocks=None, tile_gblk0=None,
                            out_rows=None):
    """The whole split decode of a part in plain PyTorch (the JAX engine's
    resident.py:_decode_weight_blocks split branch and _decode_part's
    pad): (docs32 int32, w32 f32 or None), (out_rows, 32) each, from the
    per-group block_stream_torch, the narrow-tail pad, the blkperm freq
    gather and the weight. weights: None (docs only, the norm cache),
    "presence" (1.0 where doc < num_docs) or "bm25" (f / (f + den) there,
    den from the norm cache). Rows past the part's blocks carry num_docs
    and weight 0."""
    docs32 = torch.cat([
        _group_blocks(words, tiles_docs[gtile_ids[off:off + R]], st, num_docs, True)
        for off, R, st in layout.groups])
    w32 = None
    if weights == "bm25":
        freq32 = torch.cat([
            _group_blocks(words, tiles_freqs[gtile_f[off:off + R]], st, num_docs, False)
            for off, R, st in layout.groups_f])[blkperm].float()
        den = torch.cat([den_rows(den_blocks, tile_gblk0, gtile_ids[off:off + R], st[-1])
                         for off, R, st in layout.groups])
        w32 = _weights(docs32, num_docs, weights, freq32, den)
    elif weights is not None:
        w32 = _weights(docs32, num_docs, weights)
    extra = (out_rows or len(docs32)) - len(docs32)
    if extra > 0:
        docs32 = torch.nn.functional.pad(docs32, (0, 0, 0, extra), value=num_docs)
        w32 = None if w32 is None else torch.nn.functional.pad(w32, (0, 0, 0, extra))
    return docs32, w32


def decode_launch_torch(launch, words, fld, gtile, mode, num_docs, out, w=None, freq=None,
                        blkperm=None, den_blocks=None, tile_gblk0=None):
    """What one launch of a part-level kernel writes, in plain PyTorch: for
    every CTA-table row of `launch`, its rows' blocks of out (and of w in
    the weighted docs modes), as block_stream_torch, the pad and the
    weight give them. Consecutive rows that continue one group decode in
    one call."""
    is_docs = mode != "freqs"
    host = launch.host
    i = 0
    while i < len(host):
        p1, p2, T, row0, n, blk0 = (int(x) for x in host[i])
        bpt = max(T // BLOCK, 1)
        j = i + 1
        while (j < len(host) and tuple(int(x) for x in host[j, :3]) == (p1, p2, T)
               and host[j, 3] == row0 + n and host[j, 5] == blk0 + n * bpt):
            n += int(host[j, 4])
            j += 1
        if launch.kernel == "optpfor":
            st = ("optp" if p2 > 0 else "opt", p1, p2, T)
        elif launch.kernel == "optpfor_s16":
            st = ("opt", p1, p2, T)
        elif launch.kernel == "varint":
            st = ("var", p1, T)
        elif launch.kernel == "qmx":
            st = ("qmx", p1, p2, T)
        else:
            st = ("interp", p1, T)
        ids = gtile[row0:row0 + n]
        d = _group_blocks(words, fld[ids], st, num_docs, is_docs)
        out[blk0:blk0 + n * bpt] = d
        if mode in ("presence", "bm25"):
            if mode == "bm25":
                f = freq[blkperm[blk0:blk0 + n * bpt]].float()
                w[blk0:blk0 + n * bpt] = _weights(
                    d, num_docs, mode, f, den_rows(den_blocks, tile_gblk0, ids, T))
            else:
                w[blk0:blk0 + n * bpt] = _weights(d, num_docs, mode)
        i = j
    return out, w


def _check_launch_args(launch, words, named):
    """The kernels take contiguous tensors of one dtype each, all on the
    words' device."""
    dev = words.device
    if launch.dev.device != dev:
        raise ValueError(f"the CTA table lies on {launch.dev.device}, the words on {dev}")
    for name, t, dtype in named:
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes a contiguous {dtype} tensor on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        if name in ("out", "w") and (t.dim() != 2 or t.shape[1] != BLOCK
                                     or t.shape[0] < launch.end_blk):
            raise ValueError(f"{name}: the launch writes blocks [0, {launch.end_blk}) of "
                             f"{BLOCK} slots, got {tuple(t.shape)}")
    if words.dim() != 1 or words.numel() == 0:
        raise ValueError("words must be a non-empty 1-D word array")


def _decode_launch(wrapper, launch, words, fld, gtile, mode, num_docs, out, w, freq, blkperm,
                   den_blocks, tile_gblk0):
    """One launch of csrc/<wrapper name>.cu on the current stream; CPU
    tensors take decode_launch_torch and count nothing."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if words.device.type == "cpu":
        return decode_launch_torch(launch, words, fld, gtile, mode, num_docs, out, w, freq,
                                   blkperm, den_blocks, tile_gblk0)
    if words.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cuda or cpu, not {words.device}")
    if launch.kernel != wrapper.__name__[:-len("_decode")]:
        raise ValueError(f"{wrapper.__name__} got a CTA table of the {launch.kernel} kernel")
    bm25 = mode == "bm25"
    _check_launch_args(launch, words, [
        ("words", words, torch.int32), ("fld", fld, torch.int32), ("gtile", gtile, torch.int64),
        ("out", out, torch.int32), ("w", w, torch.float32),
        ("freq", freq if bm25 else None, torch.int32),
        ("blkperm", blkperm if bm25 else None, torch.int64),
        ("den_blocks", den_blocks if bm25 else None, torch.float32),
        ("tile_gblk0", tile_gblk0 if bm25 else None, torch.int64),
    ])
    if fld.dim() != 2 or fld.shape[1] != N_FIELDS:
        raise ValueError(f"fld must be (rows, {N_FIELDS}), got {tuple(fld.shape)}")
    if mode in ("presence", "bm25") and w is None:
        raise ValueError(f"mode {mode!r} writes weights: w must be given")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    name = wrapper.__name__
    lib = kernels.lib(name)
    extra = (qmx_lane_table(words.device).data_ptr(),) if name == "qmx_decode" else ()
    rc = getattr(lib, kernels.ENTRY_POINTS[name][0])(
        words.data_ptr(), words.numel(), fld.data_ptr(), gtile.data_ptr(), launch.dev.data_ptr(),
        launch.n_cta, launch.max_w, launch.max_t, MODES[mode], int(num_docs), out.data_ptr(),
        ptr(w), ptr(freq) if bm25 else None, ptr(blkperm) if bm25 else None,
        ptr(den_blocks) if bm25 else None, ptr(tile_gblk0) if bm25 else None,
        *extra, torch.cuda.current_stream(words.device).cuda_stream,
    )
    kernels.check(lib, rc, f"{name} launch")
    wrapper.launches += 1
    return out, w


def optpfor_decode(launch, words, fld, gtile, mode, num_docs, out, w=None, freq=None,
                   blkperm=None, den_blocks=None, tile_gblk0=None):
    """K1 over one stream of a part: every ("opt", b, 0, 128) and ("optp",
    b, E, 128) group that `launch` (PartLayout.launch) lists, written into
    out (and w) as decode_launch_torch writes them. CPU tensors take that plain version;
    CUDA tensors launch csrc/optpfor_decode.cu once (counted in
    optpfor_decode.launches) or raise."""
    return _decode_launch(optpfor_decode, launch, words, fld, gtile, mode, num_docs, out, w,
                          freq, blkperm, den_blocks, tile_gblk0)


def optpfor_s16_decode(launch, words, fld, gtile, mode, num_docs, out, w=None, freq=None,
                       blkperm=None, den_blocks=None, tile_gblk0=None):
    """K1s over one stream of a part: every ("opt", b, E > 0, 128) group
    that `launch` lists (exceptions decoded in the pass), as
    optpfor_decode; CUDA tensors launch csrc/optpfor_s16_decode.cu once
    (counted in optpfor_s16_decode.launches) or raise."""
    return _decode_launch(optpfor_s16_decode, launch, words, fld, gtile, mode, num_docs, out, w,
                          freq, blkperm, den_blocks, tile_gblk0)


def varint_decode(launch, words, fld, gtile, mode, num_docs, out, w=None, freq=None,
                  blkperm=None, den_blocks=None, tile_gblk0=None):
    """K7 over one stream of a part: every ("var", G, 128) group that
    `launch` lists, as optpfor_decode; CUDA tensors launch
    csrc/varint_decode.cu once (counted in varint_decode.launches) or
    raise."""
    return _decode_launch(varint_decode, launch, words, fld, gtile, mode, num_docs, out, w,
                          freq, blkperm, den_blocks, tile_gblk0)


def qmx_decode(launch, words, fld, gtile, mode, num_docs, out, w=None, freq=None,
               blkperm=None, den_blocks=None, tile_gblk0=None):
    """K8 over one stream of a part: every ("qmx", NI, S, 128) group that
    `launch` lists, as optpfor_decode; CUDA tensors launch
    csrc/qmx_decode.cu once (counted in qmx_decode.launches), with the
    device's lane table (qmx_lane_table), or raise."""
    return _decode_launch(qmx_decode, launch, words, fld, gtile, mode, num_docs, out, w,
                          freq, blkperm, den_blocks, tile_gblk0)


def qmx_lane_words():
    """csrc/qmx_decode.cu's table, from codecs/qmx.py, as int32 bits: word
    256 t + j packs LANE_TABLE[t, j] = (bitoff_a, width_a, bitoff_b,
    width_b) one byte each, low byte first; word 256 * 15 + t packs
    INTS_OF_TYPE[t] | ADV_OF_TYPE[t] << 16."""
    tab = LANE_TABLE.astype(np.uint32)
    if tab.max() > 255 or max(INTS_OF_TYPE) > 0xFFFF:
        raise ValueError("the QMX lane table's fields do not fit their bytes")
    if any(n <= 0 or n % 4 for n in INTS_OF_TYPE):  # a kernel lane's 4 slots share one instance
        raise ValueError("csrc/qmx_decode.cu needs every INTS_OF_TYPE a positive multiple of 4")
    lane = tab[..., 0] | tab[..., 1] << 8 | tab[..., 2] << 16 | tab[..., 3] << 24
    meta = np.asarray(INTS_OF_TYPE, np.uint32) | np.asarray(ADV_OF_TYPE, np.uint32) << 16
    return np.concatenate([lane.reshape(-1), meta]).view(np.int32)


_QMX_LANES = {}


def qmx_lane_table(device):
    """qmx_lane_words on `device`, uploaded once per device."""
    key = str(device)
    if key not in _QMX_LANES:
        _QMX_LANES[key] = torch.from_numpy(qmx_lane_words()).to(device)
    return _QMX_LANES[key]


def interp_decode(launch, words, fld, gtile, mode, num_docs, out, w=None, freq=None,
                  blkperm=None, den_blocks=None, tile_gblk0=None):
    """K2 over one stream of a part: every ("interp", W, T) group that
    `launch` lists, as optpfor_decode; CUDA tensors launch
    csrc/interp_decode.cu once (counted in interp_decode.launches) or
    raise."""
    return _decode_launch(interp_decode, launch, words, fld, gtile, mode, num_docs, out, w,
                          freq, blkperm, den_blocks, tile_gblk0)


optpfor_decode.launches = 0
optpfor_s16_decode.launches = 0
varint_decode.launches = 0
qmx_decode.launches = 0
interp_decode.launches = 0
WRAPPERS = {"optpfor": optpfor_decode, "optpfor_s16": optpfor_s16_decode,
            "varint": varint_decode, "qmx": qmx_decode, "interp": interp_decode}


def split_decode_part(words, tiles_docs, tiles_freqs, gtile_ids, gtile_f, blkperm, layout,
                      num_docs, weights, den_blocks=None, tile_gblk0=None, out_rows=None):
    """split_decode_part_torch's contract. CPU tensors take that plain
    version; CUDA tensors run at most one launch of each kernel (K1, K1s,
    K7, K8, K2) per stream (freqs first, only for "bm25"; then docs, with the
    weights), each
    writing straight into the part's tensors, or raise."""
    if words.device.type == "cpu":
        return split_decode_part_torch(words, tiles_docs, tiles_freqs, gtile_ids, gtile_f,
                                       blkperm, layout, num_docs, weights, den_blocks,
                                       tile_gblk0, out_rows)
    if words.device.type != "cuda":
        raise ValueError(f"split_decode_part runs on cuda or cpu, not {words.device}")
    return _split_decode_launches(words, tiles_docs, tiles_freqs, gtile_ids, gtile_f, blkperm,
                                  layout, num_docs, weights, den_blocks, tile_gblk0, out_rows)


def _split_decode_launches(words, tiles_docs, tiles_freqs, gtile_ids, gtile_f, blkperm, layout,
                           num_docs, weights, den_blocks, tile_gblk0, out_rows):
    """split_decode_part's launches through the kernels' wrappers."""
    if weights not in (None, "presence", "bm25"):
        raise ValueError(f"weights must be None, 'presence' or 'bm25', got {weights!r}")
    dev = words.device
    rows = max(out_rows or layout.nb_d, layout.nb_d)
    docs32 = torch.empty((rows, BLOCK), dtype=torch.int32, device=dev)
    w32 = None if weights is None else torch.empty((rows, BLOCK), dtype=torch.float32, device=dev)
    if rows > layout.nb_d:
        docs32[layout.nb_d:].fill_(num_docs)
        if w32 is not None:
            w32[layout.nb_d:].zero_()
    freq = None
    if weights == "bm25":
        freq = torch.empty((layout.nb_f, BLOCK), dtype=torch.int32, device=dev)
        for kernel in KERNELS:
            launch = layout.launch(kernel, False, dev)
            if launch.n_cta:
                WRAPPERS[kernel](launch, words, tiles_freqs, gtile_f, "freqs", num_docs, freq)
    mode = "docs" if weights is None else weights
    for kernel in KERNELS:
        launch = layout.launch(kernel, True, dev)
        if launch.n_cta:
            WRAPPERS[kernel](launch, words, tiles_docs, gtile_ids, mode, num_docs, docs32, w32,
                             freq, blkperm, den_blocks, tile_gblk0)
    return docs32, w32
