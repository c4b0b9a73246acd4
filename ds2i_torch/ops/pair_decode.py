"""EF-family tile decode, both streams of a tile group in one call.

Port of ds2i_tpu/ops/pallas_decode.py:decode_pair (the Pallas kernel
_pair_kernel / _decode_stream / _gather_windows) and its bit-identical
XLA twin ds2i_tpu/engine/tile_executor.py:_decode_group.

`decode_pair_torch` is the plain PyTorch version: the CPU tests run it,
and chip_smoke.py holds the CUDA kernel against it on the card.
`decode_pair` is the wrapper the engine calls: a CPU tensor takes the
plain version, a CUDA tensor launches csrc/pair_decode.cu (or raises).

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

_M32 = 0xFFFFFFFF


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


def _check_cuda_args(docs_words, freqs_words, dfld, ffld, W, WL, T):
    dev = docs_words.device
    tensors = [("docs_words", docs_words), ("dfld", dfld)]
    if freqs_words is not None:
        tensors += [("freqs_words", freqs_words), ("ffld", ffld)]
    for name, t in tensors:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous int32 tensors on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    for name, w in (("docs_words", docs_words), ("freqs_words", freqs_words)):
        if w is not None and (w.dim() != 1 or w.numel() == 0):
            raise ValueError(f"{name} must be a non-empty 1-D word array")
    if dfld.dim() != 2 or dfld.shape[1] != N_FIELDS:
        raise ValueError(f"dfld must be (R, {N_FIELDS}), got {tuple(dfld.shape)}")
    if freqs_words is not None and ffld.shape != dfld.shape:
        raise ValueError(f"ffld {tuple(ffld.shape)} != dfld {tuple(dfld.shape)}")
    if T not in (32, 64, 128):
        raise ValueError(f"T must be 32, 64 or 128, got {T}")
    if not (1 <= W <= 1023 and 0 <= WL <= 1023):
        raise ValueError(f"W={W}, WL={WL} outside the group statics' range")


def decode_pair(docs_words, freqs_words, dfld, ffld, W, WL, T, num_docs):
    """decode_pair_torch's contract. CPU tensors take the plain version;
    CUDA tensors launch the hand-written kernel on the current stream
    (one launch, counted in decode_pair.launches) or raise."""
    if docs_words.device.type == "cpu":
        return decode_pair_torch(docs_words, freqs_words, dfld, ffld, W, WL, T, num_docs)
    if docs_words.device.type != "cuda":
        raise ValueError(f"decode_pair runs on cuda or cpu, not {docs_words.device}")
    _check_cuda_args(docs_words, freqs_words, dfld, ffld, W, WL, T)
    lib = kernels.lib("pair_decode")
    R = dfld.shape[0]
    doc = torch.empty((R, T), dtype=torch.int32, device=docs_words.device)
    freq = None if freqs_words is None else torch.empty_like(doc)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.ds2i_pair_decode(
        docs_words.data_ptr(), docs_words.numel(),
        ptr(freqs_words), 0 if freqs_words is None else freqs_words.numel(),
        dfld.data_ptr(), ptr(ffld),
        R, W, WL, T, int(num_docs),
        doc.data_ptr(), ptr(freq),
        torch.cuda.current_stream(docs_words.device).cuda_stream,
    )
    kernels.check(lib, rc, "pair_decode launch")
    decode_pair.launches += 1
    return doc, freq


decode_pair.launches = 0
