"""Batched segment decode: the port of ds2i_tpu/ops/decode.py.

`decode_rows` decodes R segments of the EF family at once (the segment
kinds of ops/segments.py) from the compressed words and assembles them
into (rows, L_out) int32 output rows:

  1. window gather: W words per segment from `words`
  2. the bits of the window inside [sel_start, sel_start + sel_len)
  3. rank = running count of the ones (a one of rank > Lseg is dropped)
  4. sel[j] = window bit of the j-th one (0 where the window has fewer
     ones than slots)
  5. the l-bit low part at lb_start + j*l (a two-word funnel read) and
     the value by segment kind: SEG_EF ((sel-j-1) << l) | low,
     SEG_EF_STRICT the same + j, SEG_RB sel, SEG_AO j, any other kind 0;
     then + base
  6. out[list_row, out_begin + j] = value for j < min(n_vals, Lseg), the
     rest the sentinel, and the sentinel at every column >= list_n of
     its row.

`decode_rows_torch` is the plain PyTorch version, a direct copy of the
JAX op, int32 arithmetic included: words are int32 tensors holding the
uint32 words' bits, widened to int64 and masked to 32 bits; a shift by
32 or more gives 0 and the l >= 32 mask all ones, as XLA's do; the
scatter drops a write outside the output and takes a negative index from
the end, as JAX's does. `decode_rows` is the wrapper: CPU tensors take
the plain version, CUDA tensors launch csrc/segment_decode.cu (K9) once
(counted in `decode_rows.launches`) or raise. `decode_segments_device`
is the JAX package's name for the same call (there it is decode_rows
under jit). `decode_segments_numpy` is the host copy the tests hold both
to.

Bit offsets are int32, as in the JAX op, so a stream's bits past 2^31
cannot be addressed. The JAX op takes the wrapped offsets and decodes
wrong values there; the port refuses: `check_bit_offsets` raises
ValueError on the host fields before they are narrowed to int32
(DeviceIndex and the engines call it), and `decode_rows` calls it on
int64 fields.
"""

import numpy as np
import torch

from .. import kernels
from .segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB

_M32 = 0xFFFFFFFF
_I32_LIMIT = 1 << 31
# the most window words csrc/segment_decode.cu takes (32 * W bits fit in
# 32 bits); the JAX op's bit planes would need R * W * 32 bits far sooner
SEGMENT_MAX_W = 1 << 25
FIELDS = ("kind", "sel_start", "sel_len", "lb_start", "lower_bits", "n_vals", "base",
          "out_begin", "list_row")


def check_bit_offsets(sel_start, sel_len, lb_start, lower_bits, n_vals):
    """Raise ValueError where a segment's bits lie at or past bit 2^31 of
    its stream (the select window's end sel_start + sel_len, or the low
    bits' end lb_start + n_vals * lower_bits), which int32 offsets cannot
    address. Takes numpy arrays or tensors of any integer type."""
    a = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, dtype=np.int64)
         for x in (sel_start, sel_len, lb_start, lower_bits, n_vals)]
    sel_start, sel_len, lb_start, lower_bits, n_vals = a
    ends = np.concatenate([sel_start + np.maximum(sel_len, 0),
                           lb_start + np.maximum(n_vals, 0) * np.maximum(lower_bits, 0)])
    if ends.size and int(ends.max()) >= _I32_LIMIT:
        raise ValueError(
            f"a segment's bits reach bit {int(ends.max())} of its stream: int32 bit offsets "
            f"address only the first 2^31 bits (256 MiB) of a stream")


def _wrap32(v):
    """int64 values -> the int32 of their low 32 bits (two's complement)."""
    return (((v & _M32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _normalize(idx, size):
    """JAX's index normalization: a negative index counts from the end."""
    return torch.where(idx < 0, idx + size, idx)


def decode_rows_torch(words, kind, sel_start, sel_len, lb_start, lower_bits, n_vals, base,
                      out_begin, list_row, list_n, W=64, Lseg=128, rows=1, L_out=128,
                      sentinel=0):
    """Plain PyTorch decode of R segments into (rows, L_out) int32 (see the
    module docstring); words int32 (the uint32 bits), the nine fields
    int32[R], list_n int32[rows]."""
    dev = words.device
    nw = words.shape[0]
    kind, sel_start, sel_len, lb_start, lower_bits, n_vals, base, out_begin, list_row = (
        t.long() for t in (kind, sel_start, sel_len, lb_start, lower_bits, n_vals, base,
                           out_begin, list_row))
    R = kind.shape[0]
    j = torch.arange(Lseg, device=dev, dtype=torch.int64)[None, :]

    # 1-2: window gather, the window's bits
    word0 = sel_start >> 5
    widx = word0[:, None] + torch.arange(W, device=dev)[None, :]
    wv = words[widx.clamp(0, nw - 1)].long() & _M32  # (R, W)
    bits = ((wv[:, :, None] >> torch.arange(32, device=dev)) & 1).reshape(R, W * 32)
    rel = (word0[:, None] << 5) + torch.arange(W * 32, device=dev)[None, :] - sel_start[:, None]
    bits = torch.where((rel >= 0) & (rel < sel_len[:, None]), bits, 0)

    # 3-4: rank, then the j-th one's window bit at column j
    rank = bits.cumsum(dim=1)
    col = torch.where((bits == 1) & (rank <= Lseg), rank - 1, Lseg)
    sel = torch.zeros((R, Lseg + 1), dtype=torch.int64, device=dev).scatter_(1, col, rel)
    sel = sel[:, :Lseg]

    # 5: low bits and the value by kind, in uint32 arithmetic
    l = lower_bits[:, None]
    bit_off = lb_start[:, None] + j * l
    w0i = bit_off >> 5
    s = bit_off & 31
    w0 = words[w0i.clamp(0, nw - 1)].long() & _M32
    w1 = words[(w0i + 1).clamp(0, nw - 1)].long() & _M32
    low = (w0 >> s) | ((w1 << (32 - s)) & _M32)  # s == 0: the shift by 32 leaves no bit
    wide = (l >= 32) | (l < 0)
    low = low & torch.where(wide, _M32, (1 << l.clamp(0, 31)) - 1)
    ef_val = torch.where(wide, 0, (((sel - j - 1) & _M32) << l.clamp(0, 31)) & _M32) | low
    val = torch.where(kind[:, None] == SEG_EF, ef_val, 0)
    val = torch.where(kind[:, None] == SEG_EF_STRICT, ef_val + j, val)
    val = torch.where(kind[:, None] == SEG_RB, sel, val)
    val = torch.where(kind[:, None] == SEG_AO, j, val)
    val = _wrap32(val + base[:, None])

    # 6: assemble into the output rows; a write outside them is dropped
    out_col = _normalize(torch.where(j < n_vals[:, None], out_begin[:, None] + j, L_out), L_out + 1)
    out_row = _normalize(list_row[:, None].expand(R, Lseg), rows)
    keep = (out_row >= 0) & (out_row < rows) & (out_col >= 0) & (out_col <= L_out)
    out = torch.full((rows, L_out + 1), sentinel, dtype=torch.int32, device=dev)
    out[out_row[keep], out_col[keep]] = val[keep]
    out = out[:, :L_out]
    pos = torch.arange(L_out, device=dev)[None, :]
    return torch.where(pos < list_n.long()[:, None], out, sentinel).to(torch.int32)


def decode_rows(words, kind, sel_start, sel_len, lb_start, lower_bits, n_vals, base, out_begin,
                list_row, list_n, W=64, Lseg=128, rows=1, L_out=128, sentinel=0):
    """decode_rows_torch's contract. Int64 fields are checked by
    check_bit_offsets, then narrowed to int32. CPU tensors take the plain
    version; CUDA tensors make one launch of csrc/segment_decode.cu
    (counted in decode_rows.launches) into an output filled with the
    sentinel, or raise."""
    fields = [kind, sel_start, sel_len, lb_start, lower_bits, n_vals, base, out_begin, list_row]
    if any(f.dtype == torch.int64 for f in fields):
        check_bit_offsets(sel_start, sel_len, lb_start, lower_bits, n_vals)
        fields = [f.to(torch.int32) for f in fields]
    if words.device.type == "cpu":
        return decode_rows_torch(words, *fields, list_n, W=W, Lseg=Lseg, rows=rows, L_out=L_out,
                                 sentinel=sentinel)
    if words.device.type != "cuda":
        raise ValueError(f"decode_rows runs on cuda or cpu, not {words.device}")
    R = fields[0].shape[0]
    if words.dtype != torch.int32 or words.dim() != 1 or words.numel() == 0:
        raise ValueError("words must be a non-empty 1-D int32 tensor (the uint32 words' bits)")
    for name, t in (*zip(FIELDS, fields), ("list_n", list_n)):
        n = rows if name == "list_n" else R
        if t.dtype != torch.int32 or t.shape != (n,) or t.device != words.device:
            raise ValueError(f"{name} must be int32[{n}] on {words.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if min(W, Lseg, rows, L_out) < 1:
        raise ValueError(f"W, Lseg, rows and L_out must be positive, got {W}, {Lseg}, {rows}, "
                         f"{L_out}")
    if W > SEGMENT_MAX_W:
        raise ValueError(f"decode_rows on the card takes W <= {SEGMENT_MAX_W} window words, "
                         f"got {W}")
    out = torch.full((rows, L_out), sentinel, dtype=torch.int32, device=words.device)
    if R == 0:
        return out
    fields = [f.contiguous() for f in fields]
    lib = kernels.lib("segment_decode")
    rc = lib.ds2i_segment_decode(
        words.data_ptr(), words.numel(), R, *(f.data_ptr() for f in fields),
        list_n.contiguous().data_ptr(), int(W), int(Lseg), int(rows), int(L_out), out.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream)
    kernels.check(lib, rc, "segment_decode launch")
    decode_rows.launches += 1
    return out


decode_rows.launches = 0

# the JAX package's name for the call (jit-compiled there)
decode_segments_device = decode_rows


def decode_segments_numpy(words_u32, seg_arrays, rows, L_out, sentinel):
    """Host reference implementation (bit-exact vs the device kernel)."""
    out = np.full((rows, L_out), sentinel, dtype=np.int64)
    bits_all = np.unpackbits(words_u32.view(np.uint8), bitorder="little")
    k = seg_arrays["kind"]
    for r in range(len(k)):
        n = int(seg_arrays["n_vals"][r])
        j = np.arange(n, dtype=np.int64)
        kind = int(k[r])
        basev = int(seg_arrays["base"][r])
        if kind == SEG_AO:
            vals = j + basev
        else:
            s0 = int(seg_arrays["sel_start"][r])
            slen = int(seg_arrays["sel_len"][r])
            ones = np.nonzero(bits_all[s0 : s0 + slen])[0][:n]
            if kind == SEG_RB:
                vals = ones + basev
            else:
                l = int(seg_arrays["lower_bits"][r])
                lb = int(seg_arrays["lb_start"][r])
                low = np.zeros(n, dtype=np.int64)
                if l:
                    for i in range(n):
                        off = lb + i * l
                        w = off >> 5
                        sh = off & 31
                        v = int(words_u32[w]) >> sh
                        if sh + l > 32:
                            v |= int(words_u32[w + 1]) << (32 - sh)
                        low[i] = v & ((1 << l) - 1)
                vals = ((ones - j - 1) << l) | low
                if kind == SEG_EF_STRICT:
                    vals = vals + j
                vals = vals + basev
        row = int(seg_arrays["list_row"][r]) if "list_row" in seg_arrays else int(seg_arrays["list_id"][r])
        ob = int(seg_arrays["out_begin"][r])
        out[row, ob : ob + n] = vals
    return out
