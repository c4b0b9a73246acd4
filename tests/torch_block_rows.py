"""Seeded full-block rows for the QMX (K8), Varint-G8IU (K7) and in-pass
OptPFor (K1s) decode tests, in numpy and the port alone (the card's machine has no jax): well
formed blocks encoded by the port's codecs and laid at random byte
offsets of one word stream, with their field rows as the engine's tile
walk fills them, plus the rows a kernel must read outside its block for
(bucketed NI, S or G past the block's own counts, the stream's last
block, malformed fields), and a part laid over them as the engine lays
one (PartLayout, tiles, blkperm, den rows). Used by
tests/test_torch_qmx_stage.py (a numpy model of csrc/qmx_decode.cu's row
prologue against qmx_decode_torch on the CPU), tests/test_torch_ex_inpass.py
(the in-pass rows against the JAX op and a numpy model of
csrc/optpfor_s16_decode.cu) and tests/test_torch_cuda.py (the kernels
against decode_launch_torch on the card)."""

import numpy as np
import torch

from ds2i_torch.codecs.optpfor import OptPForBlock
from ds2i_torch.codecs.qmx import QMXBlock
from ds2i_torch.codecs.simple16 import simple16_encode
from ds2i_torch.codecs.varint import VarintG8IUBlock
from ds2i_torch.engine.block_tiles import (
    BF_B, BF_BOFF, BF_EX_BOFF, BF_EX_W0, BF_NEX, BF_W0, _E_BUCKETS, _G_BUCKETS, _NW_BUCKETS,
    _S_BUCKETS, _bucket, _opt_stream, _qmx_stream, _var_stream,
)
from ds2i_torch.engine.tiles import F_BASE, F_NVALS, N_FIELDS
from ds2i_torch.ops.block_decode import BLOCK, PartLayout

TILE = 128


def _encode(codec, values):
    chunk = []
    codec.encode(values, int(values.sum()), TILE, chunk)
    return np.concatenate([np.asarray(c, np.uint8).reshape(-1) for c in chunk])


def _lay(streams, rng, max_pad=5):
    """The streams end to end at random byte offsets, the last one ending
    the stream (its bytes padded only to the word): (bytes, offsets)."""
    offs, parts, cur = [], [], 0
    for s in streams:
        pad = int(rng.randint(0, max_pad + 1))
        parts += [np.zeros(pad, np.uint8), s]
        offs.append(cur + pad)
        cur += pad + len(s)
    buf = np.concatenate(parts)
    return np.concatenate([buf, np.zeros((-len(buf)) % 4, np.uint8)]), offs


def _qmx_values(rng, kind):
    """128 values whose QMX block has the named shape."""
    if kind == "wide":  # 32 instances of 32-bit values
        return rng.randint(1 << 31, 1 << 32, size=TILE, dtype=np.uint64)
    if kind == "alternating":  # 4 values of 32 bits, 8 of 16: 20+ instances and selectors
        v = np.zeros(TILE, np.uint64)
        for i in range(0, TILE, 12):
            v[i:i + 4] = rng.randint(1 << 31, 1 << 32, size=len(v[i:i + 4]), dtype=np.uint64)
            v[i + 4:i + 12] = rng.randint(1 << 12, 1 << 16, size=len(v[i + 4:i + 12]))
        return v
    if kind == "ones":  # a run of the value 1 (type 0) among small values
        v = rng.randint(0, 1 << 5, size=TILE).astype(np.uint64)
        v[:96] = 1
        return v
    if kind == "ones_last":  # the block's last instance of type 0
        v = rng.randint(0, 1 << 9, size=TILE).astype(np.uint64)
        v[32:] = 1
        return v
    mag = int(rng.choice([1, 3, 7, 12, 20, 31]))
    v = rng.randint(0, 1 << mag, size=TILE).astype(np.uint64)
    v[rng.choice(TILE, 10, replace=False)] = rng.randint(0, 1 << 31, 10)
    return v


def qmx_rows(seed=0):
    """(words uint32, [(NI, S, fields int32 (N_FIELDS,), kind)]): each
    well formed block under its own buckets ("fit") and under NI = S = 32
    ("bucketed": ninst < NI, nsel < S); blocks with runs of the value 1
    (type 0: "ones", and "ones_last", whose last instance has type 0), of
    20+ instances and selectors ("alternating", NI and S at 32) and of 32
    instances ("wide"); the stream's last block, whose staged word after its last
    selector byte lies past the stream ("stream_end"); and malformed rows
    (random cursors and counts, selectors before the payload, past the
    stream or before its start: "malformed")."""
    rng = np.random.RandomState(seed)
    kinds = ["fit"] * 6 + ["ones", "ones_last", "wide", "alternating", "alternating"]
    streams = [_encode(QMXBlock, _qmx_values(rng, k)) for k in kinds]
    data, offs = _lay(streams, rng)
    words = data.view("<u4")
    rows = []
    for i, (k, off) in enumerate(zip(kinds, offs)):
        f = np.zeros(N_FIELDS, np.int64)
        _qmx_stream(data, off, TILE, f)
        f[F_BASE] = rng.randint(0, 1000)
        ninst, nsel = int(f[BF_B]), int(f[BF_NEX])
        NI, S = _bucket(ninst, _NW_BUCKETS), _bucket(nsel, _S_BUCKETS)
        kind = "stream_end" if i == len(kinds) - 1 else k
        rows.append((NI, S, f.copy(), kind))
        if NI < 32 or S < 32:
            rows.append((32, 32, f.copy(), "bucketed"))
    nw = len(words)
    for _ in range(12):
        f = np.zeros(N_FIELDS, np.int64)
        f[BF_W0] = rng.randint(-3, nw + 4)
        f[BF_BOFF] = 8 * rng.randint(0, 4)
        f[BF_B] = rng.randint(0, 41)
        f[BF_NEX] = rng.randint(0, 41)
        f[BF_EX_W0] = f[BF_W0] + rng.randint(-4, 300)
        f[BF_EX_BOFF] = rng.randint(0, 4)
        f[F_BASE] = rng.randint(0, 1000)
        f[F_NVALS] = rng.randint(0, TILE + 1)
        rows.append((int(rng.choice(_NW_BUCKETS)), int(rng.choice(_S_BUCKETS)), f, "malformed"))
    # cursors at and past the stream's two ends
    for w0, sel_w0 in ((nw - 2, nw + 5), (-2, 40), (-9, -3), (nw + 3, nw - 1), (60, 50)):
        f = rows[-1][2].copy()
        f[BF_W0], f[BF_EX_W0], f[BF_B], f[BF_NEX] = w0, sel_w0, 32, 32
        rows.append((32, 32, f, "malformed"))
    return words, [(NI, S, f.astype(np.int32), kind) for NI, S, f, kind in rows]


def varint_rows(seed=0):
    """(words uint32, [(G, fields int32 (N_FIELDS,), kind)]): each well
    formed block under its own bucket ("fit") and under G = 64 (ngroups <
    G: "bucketed"); blocks of more groups than a smaller G reads
    ("over_g"); the stream's last block ("stream_end"); malformed rows
    (random cursors and group counts, some past the stream or negative:
    "malformed")."""
    rng = np.random.RandomState(seed)
    vals = []
    for mag in (6, 8, 14, 22, 30, 32, 7, 16):
        v = rng.randint(0, 2 ** mag, size=TILE, dtype=np.uint64).astype(np.uint32)
        vals.append(v)
    streams = [_encode(VarintG8IUBlock, v) for v in vals]
    data, offs = _lay(streams, rng)
    words = data.view("<u4")
    rows = []
    for i, off in enumerate(offs):
        f = np.zeros(N_FIELDS, np.int64)
        _var_stream(data, off, TILE, f)
        f[F_BASE] = rng.randint(0, 1000)
        G = _bucket(int(f[BF_B]), _G_BUCKETS)
        kind = "stream_end" if i == len(offs) - 1 else "fit"
        rows.append((G, f.copy(), kind))
        if G < 64:
            rows.append((64, f.copy(), "bucketed"))
        if f[BF_B] > 24:
            rows.append((24, f.copy(), "over_g"))
    nw = len(words)
    for _ in range(8):
        f = np.zeros(N_FIELDS, np.int64)
        f[BF_W0] = rng.randint(-3, nw + 4)
        f[BF_BOFF] = 8 * rng.randint(0, 4)
        f[BF_B] = rng.randint(-2, 80)
        f[F_BASE] = rng.randint(0, 1000)
        f[F_NVALS] = rng.randint(0, TILE + 1)
        rows.append((int(rng.choice(_G_BUCKETS)), f, "malformed"))
    for w0 in (nw - 1, nw - 20, -2, -200):  # windows at and past the stream's two ends
        f = rows[-1][1].copy()
        f[BF_W0], f[BF_B] = w0, 64
        rows.append((64, f, "malformed"))
    return words, [(G, f.astype(np.int32), kind) for G, f, kind in rows]


def _opt_values(rng, kind):
    """128 values whose OptPFor block has the named shape: a few
    exceptions ("light"), many ("heavy"), none, or 31-bit values (b = 32)."""
    if kind == "b32":
        return rng.randint(0, 2 ** 31, size=TILE).astype(np.uint32)
    base = rng.randint(1, 60)
    v = rng.randint(0, base, size=TILE).astype(np.uint32)
    n = {"light": rng.randint(1, 6), "heavy": rng.randint(20, 60), "none": 0}[kind]
    if n:
        v[rng.choice(TILE, size=n, replace=False)] = rng.randint(base, base * 5000, size=n)
    return v


def _opt_block(b, slots, stream):
    """An OptPFor block's bytes built by hand (codecs/optpfor.py layout):
    b, n_ex = the stream's positions (half its values), the slot words,
    then the Simple16 words of `stream`."""
    sw = (TILE * min(b, 32) + 31) // 32
    slot_words = np.asarray(slots, np.uint32)[:sw]
    ex = np.asarray(simple16_encode(stream), np.uint32)
    return np.concatenate([np.array([b, len(stream) // 2], np.uint8),
                           slot_words.astype("<u4").view(np.uint8), ex.astype("<u4").view(np.uint8)])


def s16_rows(seed=0):
    """(words uint32, [(b, E, fields int32 (N_FIELDS,), kind)]) for the
    in-pass exception decode, ("opt", b, E, 128) statics with E > 0:
    well formed blocks with exceptions under their own E bucket ("fit")
    and under E = 128 ("bucketed"), one under an E below its n_ex
    ("over_e": positions past E ignored, highs at n_ex + e reading past
    K as 0), a heavy one under every E bucket ("every_e"); blocks without exceptions and b = 32 blocks under E > 0;
    hand-built blocks whose positions repeat (int32 wrap of the position
    prefix sum: "repeat") and whose b is 32 with exceptions (the high
    shift clips to 31: "b32_ex"); the stream's last block, whose
    exception window clamps ("stream_end"); and malformed rows (random
    cursors, bit offsets, counts, BF_B outside 0..31, windows before and
    past the stream: "malformed")."""
    rng = np.random.RandomState(seed)
    kinds = ["light", "light", "heavy", "heavy", "none", "b32", "light"]
    streams = [_encode(OptPForBlock, _opt_values(rng, k)) for k in kinds]
    slots = rng.randint(0, 2 ** 32, size=TILE, dtype=np.uint64).astype(np.uint32)
    p = int(rng.randint(0, TILE))
    rep = [p] + [(1 << 28) - 1] * 16  # 16 steps of 2^28 wrap back to p
    rep += list(rng.randint(0, 1 << 20, size=len(rep)))
    b32 = [5, 40, 30] + list(rng.randint(0, 1 << 27, size=3))
    hand = [_opt_block(7, slots, rep), _opt_block(32, slots, b32)]
    order = [*streams[:-1], *hand, streams[-1]]
    names = [*kinds[:-1], "repeat", "b32_ex", "stream_end"]
    data, offs = _lay(order, rng)
    words = data.view("<u4")
    rows = []
    for k, off in zip(names, offs):
        f = np.zeros(N_FIELDS, np.int64)
        _opt_stream(data, off, TILE, f)
        f[F_BASE] = rng.randint(0, 1000)
        b, nex = int(f[BF_B]), int(f[BF_NEX])
        E = _bucket(max(nex, 1), _E_BUCKETS)
        rows.append((b, E, f.copy(), k))
        if E < 128:
            rows.append((b, 128, f.copy(), "bucketed"))
        if nex > 4:
            rows.append((b, _E_BUCKETS[max(_E_BUCKETS.index(E) - 1, 1)], f.copy(), "over_e"))
        if k == "heavy" and not any(r[3] == "every_e" for r in rows):
            rows += [(b, e, f.copy(), "every_e") for e in _E_BUCKETS[1:]]
    nw = len(words)
    for _ in range(16):
        f = np.zeros(N_FIELDS, np.int64)
        f[BF_W0] = rng.randint(-3, nw + 4)
        f[BF_BOFF] = 8 * rng.randint(0, 4)
        f[BF_B] = rng.randint(-3, 41)
        f[BF_NEX] = rng.randint(-3, 260)
        f[BF_EX_W0] = rng.randint(-10, nw + 10)
        f[BF_EX_BOFF] = rng.randint(0, 32)
        f[F_BASE] = rng.randint(0, 1000)
        f[F_NVALS] = rng.randint(0, TILE + 1)
        rows.append((int(rng.randint(0, 33)), int(rng.choice(_E_BUCKETS[1:])), f, "malformed"))
    for xw0 in (nw - 1, nw - 30, -2, -300):  # exception windows at and past the stream's ends
        f = rows[-1][2].copy()
        f[BF_EX_W0], f[BF_NEX] = xw0, 128
        rows.append((rows[-1][0], 128, f, "malformed"))
    return words, [(b, E, f.astype(np.int32), kind) for b, E, f, kind in rows]


def s16_more_rows(seed=0):
    """(words uint32, [(b, E, fields int32 (N_FIELDS,), kind)]): in-pass
    rows of their own stream, hand-built to reach the rounds of
    csrc/optpfor_s16_decode.cu: "long" blocks of one 28-bit value a
    Simple16 word and n_ex 64..128 (the values the op reads span 4 to 8
    rounds of 32 words, up to all K; the position gaps 2^28 - 1 wrap so
    that every 16th exception lands on one slot; the last block ends the
    stream, so its last word's neighbour clamps); "mid_word" blocks whose
    last value read lies inside a word of 28 1-bit or 14 2-bit values;
    "nex_le0" rows (one of those blocks with n_ex 0 or -3 under E > 0:
    no exception is valid); and malformed rows, the last "long" block's
    fields with n_ex 128 under E = 128, whose exception window starts at
    the stream's last word or 40 words before it (all K words read, the
    rounds past the end clamped to its last word)."""
    rng = np.random.RandomState(1000 + seed)
    slots = rng.randint(0, 2 ** 32, size=TILE, dtype=np.uint64).astype(np.uint32)
    b, streams, kinds = 7, [], []
    for bits, nex in ((1, 20), (2, 10)):  # need = 2 n_ex ends inside a word of 28 or 14
        streams.append(list(rng.randint(0, 1 << bits, size=2 * nex)))
        kinds.append("mid_word")
    for nex in (int(rng.randint(64, 128)), 128):
        gaps = [int(rng.randint(0, TILE))] + [(1 << 28) - 1] * (nex - 1)
        streams.append(gaps + list(rng.randint(1 << 14, 1 << 28, size=nex)))
        kinds.append("long")
    data, offs = _lay([_opt_block(b, slots, s) for s in streams], rng)
    words = data.view("<u4")
    rows = []
    for k, off in zip(kinds, offs):
        f = np.zeros(N_FIELDS, np.int64)
        _opt_stream(data, off, TILE, f)
        f[F_BASE] = rng.randint(0, 1000)
        E = _bucket(int(f[BF_NEX]), _E_BUCKETS)
        for e in sorted({E, 128} | ({64} if k == "long" else set())):  # long: n_ex > E = 64 too
            rows.append((b, e, f.copy(), k))
    for nex, E in ((0, 8), (-3, 128)):
        f = rows[0][2].copy()
        f[BF_NEX] = nex
        rows.append((b, E, f, "nex_le0"))
    nw, last = len(words), next(r[2] for r in rows[::-1] if r[3] == "long")
    for xw0 in (nw - 1, nw - 40):  # exception windows from the stream's last words
        f = last.copy()
        f[BF_EX_W0], f[BF_NEX] = xw0, 128
        rows.append((b, 128, f, "malformed"))
    return words, [(b, E, f.astype(np.int32), kind) for b, E, f, kind in rows]


def block_part(statics, fields, seed=0, num_docs=5000):
    """A split-mode part over the given rows, laid as the engine lays one:
    one group per distinct statics (its rows in the given order, split
    into CTAs of 8 rows by the layout), the field table
    (one tile a row and a pad tile), the row-to-tile maps of both
    streams, and the BM25 inputs of a docs launch (freqs-order blocks,
    blkperm, den_blocks, tile_gblk0), all seeded. Returns a dict of CPU
    tensors and the PartLayout."""
    rng = np.random.RandomState(seed)
    order = sorted(range(len(statics)), key=lambda i: (statics[i], i))
    groups, off = [], 0
    for st in sorted(set(statics)):
        n = sum(1 for i in order if statics[i] == st)
        groups.append((off, n, st))
        off += n
    R = len(order)
    fld = np.zeros((R + 1, N_FIELDS), np.int32)  # the pad tile last, all zeros
    fld[:R] = np.stack(fields)
    gtile = np.asarray(order, np.int64)
    lay = PartLayout(groups, groups)
    nb = lay.nb_d
    tile_gblk0 = np.concatenate([rng.permutation(R) * 4, [4 * R]]).astype(np.int64)
    return lay, {
        "fld": torch.from_numpy(fld),
        "gtile": torch.from_numpy(gtile),
        "freq": torch.from_numpy(rng.randint(1, 60, size=(nb, BLOCK)).astype(np.int32)),
        "blkperm": torch.from_numpy(rng.permutation(nb).astype(np.int64)),
        "den_blocks": torch.from_numpy(
            rng.uniform(0.5, 3.0, size=(4 * R + 4, BLOCK)).astype(np.float32)),
        "tile_gblk0": torch.from_numpy(tile_gblk0),
        "num_docs": num_docs,
    }
