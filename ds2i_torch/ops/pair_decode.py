"""EF-family pair decode: both streams of a part in one launch.

Port of ds2i_tpu/ops/pallas_decode.py:decode_pair (the Pallas kernel
_pair_kernel / _decode_stream / _gather_windows) and its bit-identical
XLA twin ds2i_tpu/engine/tile_executor.py:_decode_group, together with
the JAX engine's pair branch around them (resident.py:
_decode_weight_blocks and _decode_part's pad): the field-row gathers,
the norm-cache den rows and the weight w = f / (f + den).

`decode_pair_torch` is the per-group plain building block; the CPU
tests hold it to the Pallas kernel in interpret mode. A part decodes in
one launch of csrc/pair_decode.cu over every group of the part, from
the pair CTA table of the plan's PartLayout (ops/block_decode.py), and
writes its docs32 and w32 block rows straight into the part's tensors.
`pair_decode_part_torch` is that whole decode in plain PyTorch and
`decode_pair_launch_torch` what one launch writes; both are used by the
tests and chip_smoke.py, never by the CUDA path. The wrapper
`decode_pair` (one launch, counted in `decode_pair.launches`) and
`pair_decode_part` take those plain versions for CPU tensors only; on
CUDA tensors they launch the kernel or raise.

`decode_group` is the one-stream decode of one tile group that the JAX
package's TileQueryEngine runs (tile_executor._decode_group): its plain
version is `_decode_stream`, its kernel csrc/tile_decode.cu (K6g), a
source and library of its own beside pair_decode.cu.

Words are int32 tensors holding the uint32 words' bits. The plain
version widens them to int64 masked with 0xFFFFFFFF, so every shift and
mask is the unsigned 32-bit one of the TPU kernel.
"""

import torch

from .. import kernels
from ..engine.tiles import (
    F_BASE, F_KIND, F_LB_BITOFF, F_LB_WORD0, F_LOWER_BITS, F_NVALS,
    F_PREV_CUM, F_SEL_ADJ, F_WIN_BITOFF, F_WIN_LEN, F_WIN_WORD0, N_FIELDS,
)
from .segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB
from . import block_decode  # its names are read at call time: it imports this module

_M32 = 0xFFFFFFFF
# the most words csrc/tile_decode.cu stages a row (its 4 warps' W + WL + 1
# words each within a block's 227 KB of shared memory)
TILE_STAGE_WORDS = 232448 // 16


def popcount32(x):
    """SWAR population count of int64 tensors holding 32-bit values
    (torch has no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _low_mask(h):
    """(1 << h) - 1 for h clipped to [0, 32], as int64."""
    return (torch.ones_like(h) << h.clamp(0, 32)) - 1


def _gather_words(words, idx):
    """words[clip(idx, 0, nw - 1)] as uint32 values in int64 (the pad
    tile reads word 0, a window past the stream's end its last word)."""
    return words[idx.clamp(0, words.shape[0] - 1)].long() & _M32


def _decode_stream(words, fld, W, WL, T):
    """One stream: (R, N_FIELDS) field rows -> (R, T) int64 values
    (slots j >= n_vals undefined; the caller masks them)."""
    f = fld.long()
    R = f.shape[0]
    dev = words.device
    j = torch.arange(T, device=dev, dtype=torch.int64)[None, :]
    col = lambda c: f[:, c, None]  # noqa: E731
    bitoff = col(F_WIN_BITOFF)

    # select window: W words masked to [win_bitoff, win_bitoff + win_len)
    wbit0 = torch.arange(W, device=dev, dtype=torch.int64)[None, :] * 32
    win = _gather_words(words, col(F_WIN_WORD0) + wbit0 // 32)
    win = win & (_low_mask(bitoff + col(F_WIN_LEN) - wbit0) & ~_low_mask(bitoff - wbit0))
    cum = popcount32(win).cumsum(dim=1)  # (R, W) inclusive

    # word holding the (j+1)-th one, its preceding rank, and its value
    word_idx = torch.searchsorted(cum, j.expand(R, T).contiguous(), right=True)
    rank_before = torch.where(
        word_idx > 0, cum.gather(1, (word_idx - 1).clamp(min=0)), 0)
    widx_c = word_idx.clamp(max=W - 1)
    target = win.gather(1, widx_c)

    # branchless in-word select of the (rem+1)-th set bit
    rem = j - rank_before
    pos = torch.zeros_like(rem)
    for width in (16, 8, 4, 2, 1):
        c = popcount32(target & (((1 << width) - 1) << pos))
        right = rem >= c
        rem = rem - torch.where(right, c, 0)
        pos = pos + torch.where(right, width, 0)
    sel = widx_c * 32 + pos - bitoff

    # low bits: the l-bit field at lb_bitoff + j*l; a word index past the
    # (WL+1)-word window reads as 0, as in the TPU kernel's one-hot select
    l = col(F_LOWER_BITS)
    bit_off = col(F_LB_BITOFF) + j * l
    w0i = (bit_off >> 5).clamp(0, WL)
    s = bit_off & 31
    lb0 = col(F_LB_WORD0)
    w0 = _gather_words(words, lb0 + w0i)
    w1 = torch.where(w0i + 1 <= WL, _gather_words(words, lb0 + w0i + 1), 0)
    # s == 0 shifts w1 by 32, which the 32-bit mask clears
    low = ((w0 >> s) | ((w1 << (32 - s)) & _M32)) & _low_mask(l)

    kind = col(F_KIND)
    adj = col(F_SEL_ADJ)
    # the clamp touches only slots j >= n_vals (masked): it keeps the
    # shifted operand non-negative
    ef_val = ((sel + adj - j).clamp(min=0) << l) | low
    val = torch.where(kind == SEG_EF, ef_val, 0)
    val = torch.where(kind == SEG_EF_STRICT, ef_val + j, val)
    val = torch.where(kind == SEG_RB, sel + adj, val)
    val = torch.where(kind == SEG_AO, j, val)
    return val + col(F_BASE)


def decode_group(words, fields, W, WL, T=128, out=None):
    """One stream of one (W, WL, T) tile group, the JAX package's
    tile_executor._decode_group: field rows (R, N_FIELDS) int32 -> (R, T)
    int32 values; slots j >= n_vals are undefined (the caller masks
    them). CPU tensors take the plain version _decode_stream; CUDA tensors
    make one launch of csrc/tile_decode.cu (K6g, counted in
    decode_group.launches) or raise. The kernel writes a row's slots
    j < n_vals and nothing else: the other slots, a pad row's all, are
    left as they were. `out`, an int32 (R, T) tensor on the words' device,
    takes the slots j < n_vals in place of a new tensor (tests pass a
    buffer filled with a pattern to see what was written); on the CPU
    those slots are copied into it."""
    if words.device.type == "cpu":
        vals = _decode_stream(words, fields, W, WL, T).to(torch.int32)
        if out is None:
            return vals
        valid = torch.arange(T)[None, :] < fields[:, F_NVALS, None]
        out[valid] = vals[valid]
        return out
    if words.device.type != "cuda":
        raise ValueError(f"decode_group runs on cuda or cpu, not {words.device}")
    if words.dtype != torch.int32 or words.dim() != 1 or words.numel() == 0:
        raise ValueError("words must be a non-empty 1-D int32 tensor (the uint32 words' bits)")
    if (fields.dtype != torch.int32 or fields.dim() != 2 or fields.shape[1] != N_FIELDS
            or fields.device != words.device):
        raise ValueError(f"fields must be int32 (R, {N_FIELDS}) on {words.device}, got "
                         f"{fields.dtype} {tuple(fields.shape)} on {fields.device}")
    if W < 1 or WL < 0 or not 1 <= T <= 128:
        raise ValueError(f"decode_group takes W >= 1, WL >= 0 and 1 <= T <= 128, got {W}, {WL}, "
                         f"{T}")
    if W + WL + 1 > TILE_STAGE_WORDS:
        raise ValueError(f"decode_group stages W + WL + 1 <= {TILE_STAGE_WORDS} words a row, got "
                         f"{W + WL + 1}")
    R = fields.shape[0]
    if out is None:
        out = torch.empty((R, T), dtype=torch.int32, device=words.device)
    elif (out.dtype != torch.int32 or out.shape != (R, T) or out.device != words.device
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 ({R}, {T}) tensor on {words.device}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if R == 0:
        return out
    lib = kernels.lib("tile_decode")
    rc = lib.ds2i_tile_decode_group(
        words.data_ptr(), words.numel(), fields.contiguous().data_ptr(), R, int(W), int(WL),
        int(T), out.data_ptr(), torch.cuda.current_stream(words.device).cuda_stream)
    kernels.check(lib, rc, "tile_decode launch")
    decode_group.launches += 1
    return out


decode_group.launches = 0


def decode_pair_torch(docs_words, freqs_words, dfld, ffld, W, WL, T, num_docs):
    """Plain PyTorch decode of one (W, WL, T) tile group: returns
    (doc (R, T) int32 with pads -> num_docs, freq (R, T) int32 tile-local
    frequencies with pads -> 0). freqs_words=None decodes the docs stream
    only and returns (doc, None)."""
    j = torch.arange(T, device=dfld.device)[None, :]
    valid = j < dfld[:, F_NVALS, None].long()
    doc = torch.where(valid, _decode_stream(docs_words, dfld, W, WL, T), num_docs)
    if freqs_words is None:
        return doc.int(), None
    fv = _decode_stream(freqs_words, ffld, W, WL, T)
    # tile-local freq: cum diff, slot 0 uses the table's prev_cum
    prev = torch.cat([ffld[:, F_PREV_CUM, None].long(), fv[:, :-1]], dim=1)
    return doc.int(), torch.where(valid, fv - prev, 0).int()


BLOCK = 32
WEIGHTS = (None, "presence", "bm25")  # what a part's decode writes beside the docids


def _pair_blocks(docs_words, freqs_words, tiles_docs, tiles_freqs, ids, st, num_docs, weights,
                 den_blocks, tile_gblk0):
    """One group's (docs, w) as 32-slot block rows, the JAX pair branch:
    docids with pads -> num_docs, and w None (weights None), presence
    flags, or f / (f + den) with den the norm cache's rows, one f32 add and
    one f32 divide, unmasked (a pad slot gives 0 / (0 + den))."""
    _, W, WL, T = st
    bm25 = weights == "bm25"
    doc, freq = decode_pair_torch(
        docs_words, freqs_words if bm25 else None, tiles_docs[ids],
        tiles_freqs[ids] if bm25 else None, W, WL, T, num_docs)
    doc = doc.reshape(-1, BLOCK)
    if weights is None:
        return doc, None
    if weights == "presence":
        return doc, torch.where(doc < num_docs, 1.0, 0.0)
    f = freq.float().reshape(-1, BLOCK)
    return doc, f / (f + block_decode.den_rows(den_blocks, tile_gblk0, ids, T))


def _check_weights(weights):
    if weights not in WEIGHTS:
        raise ValueError(f"weights must be None, 'presence' or 'bm25', got {weights!r}")


def pair_decode_part_torch(docs_words, freqs_words, tiles_docs, tiles_freqs, gtile_ids, layout,
                           num_docs, weights, den_blocks=None, tile_gblk0=None, out_rows=None):
    """The whole pair decode of a part in plain PyTorch (the JAX engine's
    resident.py:_decode_weight_blocks pair branch and _decode_part's pad):
    (docs32 int32, w32 f32 or None), (out_rows, 32) each, group by group
    of layout.groups from decode_pair_torch. weights: None (docs only,
    the norm cache), "presence" (1.0 where doc < num_docs) or "bm25"
    (f / (f + den), den from the norm cache). Rows past the part's blocks
    carry num_docs and weight 0."""
    _check_weights(weights)
    blocks = [_pair_blocks(docs_words, freqs_words, tiles_docs, tiles_freqs,
                           gtile_ids[off:off + R], st, num_docs, weights, den_blocks, tile_gblk0)
              for off, R, st in layout.groups]
    docs32 = torch.cat([d for d, _ in blocks])
    w32 = None if weights is None else torch.cat([w for _, w in blocks])
    extra = (out_rows or len(docs32)) - len(docs32)
    if extra > 0:
        docs32 = torch.nn.functional.pad(docs32, (0, 0, 0, extra), value=num_docs)
        w32 = None if w32 is None else torch.nn.functional.pad(w32, (0, 0, 0, extra))
    return docs32, w32


def decode_pair_launch_torch(launch, docs_words, freqs_words, tiles_docs, tiles_freqs, gtile, mode,
                             num_docs, out, w=None, den_blocks=None, tile_gblk0=None):
    """What one pair_decode launch writes, in plain PyTorch: for every
    CTA-table row of `launch`, its rows' blocks of out (and of w in the
    weighted modes "presence" and "bm25"), as pair_decode_part_torch's
    groups give them. Consecutive rows that continue one group decode in
    one call."""
    weights = None if mode == "docs" else mode
    host = launch.host
    i = 0
    while i < len(host):
        W, WL, T, row0, n, blk0 = (int(x) for x in host[i])
        bpt = T // BLOCK
        j = i + 1
        while (j < len(host) and tuple(int(x) for x in host[j, :3]) == (W, WL, T)
               and host[j, 3] == row0 + n and host[j, 5] == blk0 + n * bpt):
            n += int(host[j, 4])
            j += 1
        d, wv = _pair_blocks(docs_words, freqs_words, tiles_docs, tiles_freqs,
                             gtile[row0:row0 + n], ("ef", W, WL, T), num_docs, weights,
                             den_blocks, tile_gblk0)
        out[blk0:blk0 + n * bpt] = d
        if wv is not None:
            w[blk0:blk0 + n * bpt] = wv
        i = j
    return out, w


def decode_pair(launch, docs_words, freqs_words, tiles_docs, tiles_freqs, gtile, mode, num_docs,
                out, w=None, den_blocks=None, tile_gblk0=None):
    """One launch over a part: every ("ef", W, WL, T) group that `launch`
    (PartLayout.launch("pair", True, device)) lists, written into out
    (and w) as decode_pair_launch_torch writes them. mode: "docs",
    "presence" or "bm25" (which also reads freqs_words, tiles_freqs,
    den_blocks and tile_gblk0). CPU tensors take that plain version; CUDA
    tensors launch csrc/pair_decode.cu once (counted in
    decode_pair.launches) or raise."""
    if mode not in ("docs", "presence", "bm25"):
        raise ValueError(f"mode must be 'docs', 'presence' or 'bm25', got {mode!r}")
    if docs_words.device.type == "cpu":
        return decode_pair_launch_torch(launch, docs_words, freqs_words, tiles_docs, tiles_freqs,
                                        gtile, mode, num_docs, out, w, den_blocks, tile_gblk0)
    if docs_words.device.type != "cuda":
        raise ValueError(f"decode_pair runs on cuda or cpu, not {docs_words.device}")
    if launch.kernel != "pair":
        raise ValueError(f"decode_pair got a CTA table of the {launch.kernel} kernel")
    bm25 = mode == "bm25"
    if bm25 and any(t is None for t in (freqs_words, tiles_freqs, den_blocks, tile_gblk0)):
        raise ValueError("mode 'bm25' reads freqs_words, tiles_freqs, den_blocks and tile_gblk0")
    if mode != "docs" and w is None:
        raise ValueError(f"mode {mode!r} writes weights: w must be given")
    block_decode._check_launch_args(launch, docs_words, [
        ("docs_words", docs_words, torch.int32),
        ("tiles_docs", tiles_docs, torch.int32), ("gtile", gtile, torch.int64),
        ("out", out, torch.int32), ("w", w if mode != "docs" else None, torch.float32),
        ("freqs_words", freqs_words if bm25 else None, torch.int32),
        ("tiles_freqs", tiles_freqs if bm25 else None, torch.int32),
        ("den_blocks", den_blocks if bm25 else None, torch.float32),
        ("tile_gblk0", tile_gblk0 if bm25 else None, torch.int64),
    ])
    for name, t in (("tiles_docs", tiles_docs), ("tiles_freqs", tiles_freqs if bm25 else None)):
        if t is not None and (t.dim() != 2 or t.shape[1] != N_FIELDS):
            raise ValueError(f"{name} must be (rows, {N_FIELDS}), got {tuple(t.shape)}")
    if bm25 and (freqs_words.dim() != 1 or freqs_words.numel() == 0):
        raise ValueError("freqs_words must be a non-empty 1-D word array")
    if not launch.n_cta:
        return out, w
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = kernels.lib("pair_decode")
    rc = lib.ds2i_pair_decode_part(
        docs_words.data_ptr(), docs_words.numel(), tiles_docs.data_ptr(), gtile.data_ptr(),
        launch.dev.data_ptr(), launch.n_cta, launch.max_w, launch.max_t,
        block_decode.MODES[mode], int(num_docs), out.data_ptr(), ptr(w) if mode != "docs" else None,
        ptr(freqs_words) if bm25 else None, freqs_words.numel() if bm25 else 0,
        ptr(tiles_freqs) if bm25 else None, ptr(den_blocks) if bm25 else None,
        ptr(tile_gblk0) if bm25 else None,
        torch.cuda.current_stream(docs_words.device).cuda_stream,
    )
    kernels.check(lib, rc, "pair_decode launch")
    decode_pair.launches += 1
    return out, w


decode_pair.launches = 0


def pair_decode_part(docs_words, freqs_words, tiles_docs, tiles_freqs, gtile_ids, layout, num_docs,
                     weights, den_blocks=None, tile_gblk0=None, out_rows=None):
    """pair_decode_part_torch's contract. CPU tensors take that plain
    version; CUDA tensors make one decode_pair launch writing straight
    into the part's tensors (rows past the part's blocks filled with
    num_docs and weight 0 beforehand), or raise."""
    _check_weights(weights)
    if not layout.pair:
        raise ValueError("pair_decode_part takes the layout of an EF-family (pair-mode) part")
    if docs_words.device.type == "cpu":
        return pair_decode_part_torch(docs_words, freqs_words, tiles_docs, tiles_freqs, gtile_ids,
                                      layout, num_docs, weights, den_blocks, tile_gblk0, out_rows)
    if docs_words.device.type != "cuda":
        raise ValueError(f"pair_decode_part runs on cuda or cpu, not {docs_words.device}")
    dev = docs_words.device
    rows = max(out_rows or layout.nb_d, layout.nb_d)
    docs32 = torch.empty((rows, BLOCK), dtype=torch.int32, device=dev)
    w32 = None if weights is None else torch.empty((rows, BLOCK), dtype=torch.float32, device=dev)
    if rows > layout.nb_d:
        docs32[layout.nb_d:].fill_(num_docs)
        if w32 is not None:
            w32[layout.nb_d:].zero_()
    decode_pair(layout.launch("pair", True, dev), docs_words, freqs_words, tiles_docs, tiles_freqs,
                gtile_ids, weights or "docs", num_docs, docs32, w32, den_blocks, tile_gblk0)
    return docs32, w32
