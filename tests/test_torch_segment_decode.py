"""ds2i_torch.ops.decode (the batched segment decode, K9's plain version),
ops.pair_decode.decode_group (K6g's) and parallel.sharded_engine against
the JAX package:

  - decode_rows_torch bit-equal to the JAX decode_rows (jit) and to both
    packages' decode_segments_numpy over every segment of both streams of
    the four EF-family index types, and the port's segment tables equal
    to the JAX DeviceIndex's;
  - the same on the seeded edge rows of tests/torch_segment_rows.py;
  - a numpy model of csrc/segment_decode.cu's warp, lane by lane (the
    fields, then the window, the low words staged a word a lane up to 32
    of them and list_n in one round; the window walked 32 words a step,
    each step's ones taken 32 ranks a round, a lane a rank; the slots past
    the window's ones with sel = 0), equal to decode_rows_torch on those
    rows and on every segment of `ef` and `opt`;
  - decode_group's plain path against the JAX tile_executor._decode_group
    on every group of every EF-family index's tile tables, both streams,
    the n_vals slots;
  - a numpy model of csrc/tile_decode.cu's warp, lane by lane (the row's
    fields in one round, its window and low words staged in one round,
    the lane-a-rank select, writes only where j < n_vals), equal to
    _decode_stream on the n_vals slots of every group of the four types'
    tile layouts and of tests/torch_tile_rows.py's seeded edge rows, and
    writing nothing else (two patterned fills); decode_group(out=) on the
    CPU;
  - ValueError where a segment's bits lie past bit 2^31 of its stream;
  - make_sharded_plane_step against the JAX one on the 8-device CPU mesh
    (dp x tp = 4 x 2 and 2 x 4) on seeded batches.

All inputs come from numpy seeds. Serial time ~40 s on the CPU (the
models' tests ~10 s of it)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices
from ds2i_tpu.engine import DeviceIndex as JaxDeviceIndex
from ds2i_tpu.engine.tile_executor import _decode_group as jax_decode_group
from ds2i_tpu.io import generate_collection
from ds2i_tpu.ops.decode import decode_segments_device as jax_decode_rows
from ds2i_tpu.ops.decode import decode_segments_numpy as jax_decode_numpy
from ds2i_tpu.parallel.sharded_engine import make_mesh as jax_make_mesh
from ds2i_tpu.parallel.sharded_engine import make_sharded_plane_step as jax_plane_step

from ds2i_torch.engine import DeviceIndex, QueryEngine, TileQueryEngine
from ds2i_torch.engine.tiles import F_NVALS, N_FIELDS
from ds2i_torch.ops import decode
from ds2i_torch.ops.decode import FIELDS, decode_rows, decode_rows_torch, decode_segments_numpy
from ds2i_torch.ops.pair_decode import _decode_stream, decode_group
from ds2i_torch.ops.segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB
from ds2i_torch.parallel.sharded_engine import make_mesh, make_sharded_plane_step

from test_torch_host_copy import build_index
from torch_segment_rows import segment_rows
from torch_tile_rows import CASES as TILE_CASES
from torch_tile_rows import tile_rows

EF_TYPES = ["ef", "single", "uniform", "opt"]
_jax_group = jax.jit(jax_decode_group, static_argnums=(2, 3))


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release the JAX executables each test compiled before the next one
    (the fixture of tests/test_wand_device.py)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=600, num_terms=900, postings_target=20_000,
                        num_queries=40, max_query_len=4)
    return base


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pow2(x, lo=1):
    v = lo
    while v < x:
        v *= 2
    return v


def stream_call(dindex, stream):
    """One decode over every segment of a stream, each list its own output
    row (DeviceIndex.decode_lists over all lists, pads included): (words
    uint32, fields {name: int32[R]}, list_n int32[rows], statics)."""
    segs = dindex.docs_segs if stream == "docs" else dindex.freqs_segs
    bv = (dindex.index.docs_sequences if stream == "docs" else dindex.index.freqs_sequences).bits_bv
    words = np.ascontiguousarray(bv.words).view(np.uint32)
    R = len(segs["kind"])
    Rp = _pow2(R, lo=8)
    nl = dindex.num_lists
    fields = {}
    for k in FIELDS:
        a = np.full(Rp, {"kind": -1, "list_row": nl}.get(k, 0), dtype=np.int32)
        a[:R] = segs["list_id" if k == "list_row" else k]
        fields[k] = a
    list_n = np.concatenate([dindex.list_n, [0]]).astype(np.int32)
    W = _pow2(int(np.max(((segs["sel_start"] & 31) + segs["sel_len"] + 31) // 32)), lo=4)
    statics = dict(W=W, Lseg=_pow2(int(segs["n_vals"].max()), lo=32), rows=nl + 1,
                   L_out=_pow2(int(dindex.list_n.max()), lo=32),
                   sentinel=dindex.num_docs if stream == "docs" else 0)
    return words, fields, list_n, statics


def plain(words, fields, list_n, statics):
    return decode_rows_torch(_t(words.view(np.int32)), *(_t(fields[k]) for k in FIELDS),
                             _t(list_n), **statics).numpy()


def jax_call(words, fields, list_n, statics):
    return np.asarray(jax_decode_rows(jnp.asarray(words), *(jnp.asarray(fields[k]) for k in FIELDS),
                                      jnp.asarray(list_n), **statics))


# -- numpy models of csrc/segment_decode.cu and csrc/tile_decode.cu ----------
#
# Each models the kernel's warps lane by lane: a warp a segment (K9) or a
# row (K6g), every warp of the launch at once (axis 0), its 32 lanes on
# axis 1; a shuffle is a gather along the lane axis, and a loop whose trip
# count is warp-uniform runs to the largest count with the warps past
# theirs masked off.

_M32 = 0xFFFFFFFF
LANES = np.arange(32)


def _low_mask(h):
    """(1 << h) - 1 for h clipped to [0, 32], elementwise."""
    h = np.asarray(h, dtype=np.int64)
    return np.where(h >= 32, _M32, (np.int64(1) << np.clip(h, 0, 31)) - 1)


def _shfl(x, src):
    """__shfl_sync: each lane reads lane src & 31 of its warp's x."""
    return np.take_along_axis(x, np.broadcast_to(src, x.shape) & 31, axis=1)


def _scan(pc):
    return np.cumsum(pc, axis=1)


def _select_in_word(x, rem):
    """The 5-step popcount search for the (rem+1)-th one of x (31 past its
    ones), elementwise."""
    pos = np.zeros_like(rem)
    for width in (16, 8, 4, 2, 1):
        c = np.bitwise_count((x & (((1 << width) - 1) << pos)).astype(np.uint64)).astype(np.int64)
        right = rem >= c
        rem = rem - np.where(right, c, 0)
        pos = pos + np.where(right, width, 0)
    return pos


def _lane_rank_rounds(v, before, end, c):
    """One walk step's select, a lane a rank: for each round of 32 ranks r0
    (warp-uniform, r0 from `before` while below `end`), each lane's rank,
    the step's word holding it (5-step binary search over the inclusive
    scan), and its window bit. Yields (j, sel, active) per round, (R, 32)
    each."""
    pc = np.bitwise_count(v.astype(np.uint64)).astype(np.int64)
    inc = _scan(pc)
    r0 = before.copy()
    while (r0 < end).any():
        live = (r0 < end)[:, None]
        t = r0[:, None] + LANES - before[:, None]
        wi = np.zeros_like(t)
        for d in (16, 8, 4, 2, 1):
            wi = wi + np.where(_shfl(inc, wi + d - 1) <= t, d, 0)
        word = _shfl(v, wi)
        excl = _shfl(inc - pc, wi)
        sel = (c + wi) * 32 + _select_in_word(word, t - excl)
        j = r0[:, None] + LANES
        yield j, sel, live & (j < end[:, None])
        r0 = r0 + 32


def k9_model(words, fields, list_n, W, Lseg, rows, L_out, sentinel):
    """What segment_rows_kernel writes into an output filled with the
    sentinel: round 1 the nine fields; round 2 together the window's first
    32 words (a word a lane), the low words where the segment's n*l bits
    span at most 32 (a word a lane) and list_n[row]; the walk, 32 words a
    step, each step's ones taken 32 ranks a round, a lane a rank (its word
    by binary search over the scan, its bit by the popcount search, its two
    low words by shuffle from the staged ones, else from device memory);
    then the slots past the window's ones, sel = 0, a lane a slot."""
    words = np.asarray(words, dtype=np.int64)
    nw = len(words)
    out = np.full((rows, L_out), sentinel, dtype=np.int64)

    def load(i):
        return words[np.clip(i, 0, nw - 1)]

    f = {k: fields[k].astype(np.int64) for k in FIELDS}
    kind, l, lb, ob, base = f["kind"], f["lower_bits"], f["lb_start"], f["out_begin"], f["base"]
    n = np.minimum(f["n_vals"], Lseg)
    row = np.where(f["list_row"] < 0, f["list_row"] + rows, f["list_row"])
    live = (n > 0) & (row >= 0) & (row < rows)
    ef = (kind == SEG_EF) | (kind == SEG_EF_STRICT)
    windowed = ef | (kind == SEG_RB)
    word0, off, slen = f["sel_start"] >> 5, f["sel_start"] & 31, f["sel_len"]
    nwin = np.minimum(np.where(windowed & (slen > 0), (off + slen + 31) >> 5, 0), W)
    lbw0 = lb >> 5
    nlw = np.where(ef & (l >= 0), ((lb & 31) + n * l + 31) >> 5, 0)
    staged = ef & (l >= 0) & (nlw <= 32)
    # round 2
    win = np.where(LANES < nwin[:, None], load(word0[:, None] + LANES), 0)
    lw = np.where(staged[:, None] & (LANES < nlw[:, None]), load(lbw0[:, None] + LANES), 0)
    lim = np.minimum(L_out, list_n[np.clip(row, 0, rows - 1)].astype(np.int64))
    live &= lim > 0

    def store(j, sel, active):
        bit_off = lb[:, None] + j * l[:, None]
        sh = bit_off & 31
        rel = (bit_off >> 5) - lbw0[:, None]
        w0 = np.where(staged[:, None], _shfl(lw, rel), load(bit_off >> 5))
        w1 = np.where(staged[:, None], np.where(rel + 1 >= 32, 0, _shfl(lw, rel + 1)),
                      load((bit_off >> 5) + 1))
        col = ob[:, None] + j
        col = np.where(col < 0, col + L_out + 1, col)
        active = active & live[:, None] & (col >= 0) & (col < lim[:, None])
        wide = ((l >= 32) | (l < 0))[:, None]
        lc = np.clip(l, 0, 31)[:, None]
        low = ((w0 >> sh) | np.where(sh > 0, (w1 << (32 - sh)) & _M32, 0)) & \
            np.where(wide, _M32, (np.int64(1) << lc) - 1)
        efv = np.where(wide, 0, (((sel - j - 1) & _M32) << lc) & _M32) | low
        k = kind[:, None]
        val = np.where(k == SEG_EF, efv, 0)
        val = np.where(k == SEG_EF_STRICT, (efv + j) & _M32, val)
        val = np.where(k == SEG_RB, sel & _M32, val)
        val = np.where(k == SEG_AO, j & _M32, val)
        v = (val + (base[:, None] & _M32)) & _M32
        v = np.where(v >= 1 << 31, v - (1 << 32), v)
        rr = np.broadcast_to(row[:, None], j.shape)
        out[rr[active], col[active]] = v[active]

    before = np.zeros(len(n), dtype=np.int64)
    for c in range(0, int(nwin.max(initial=0)), 32):
        walk = live & (c < nwin) & (before < n)
        if not walk.any():
            break
        k = c + LANES
        nxt = np.where(k + 32 < nwin[:, None], load(word0[:, None] + k + 32), 0)
        v = win & (_low_mask(off[:, None] + slen[:, None] - 32 * k)
                   & ~_low_mask(off[:, None] - 32 * k) & _M32)
        v = np.where(walk[:, None], v, 0)
        tot = _scan(np.bitwise_count(v.astype(np.uint64)).astype(np.int64))[:, 31]
        end = np.where(walk, np.minimum(before + tot, n), before)
        for j, sel, active in _lane_rank_rounds(v, before, end, c):
            store(j, sel - off[:, None], active)
        before = np.where(walk, before + tot, before)
        win = nxt
    j0 = before.copy()
    while (live & (j0 < n)).any():
        j = j0[:, None] + LANES
        store(j, np.zeros_like(j), j < n[:, None])
        j0 = j0 + 32
    return out


def k6g_model(words, fld, W, WL, T, canary):
    """What tile_group_kernel writes into an (R, T) output filled with
    `canary`: round 1 lanes 0-10 load the row's field words (a shuffle
    broadcasts each), a pad row (n_vals <= 0) stops; round 2 the window
    words that hold the row's bits and the low words its slots read, a
    word a lane, into the warp's staging (a word never staged is never
    read: asserted); the walk, 32 staged words a step, a lane a rank;
    the slots past the window's ones select in word W-1; kinds without a
    window a lane a slot. Only slots j < min(n_vals, T) are written."""
    from ds2i_torch.engine.tiles import (
        F_BASE, F_KIND, F_LB_BITOFF, F_LB_WORD0, F_LOWER_BITS, F_SEL_ADJ, F_WIN_BITOFF,
        F_WIN_LEN, F_WIN_WORD0,
    )

    words = np.asarray(words, dtype=np.int64)
    nw = len(words)
    R = len(fld)
    out = np.full((R, T), canary, dtype=np.int64)
    # round 1: lane i < N_FIELDS holds field word i; broadcasts by shuffle
    mine = np.where(LANES < N_FIELDS, fld.astype(np.int64)[:, np.minimum(LANES, N_FIELDS - 1)], 0)
    g = {c: _shfl(mine, np.full((R, 32), c))[:, 0] for c in range(N_FIELDS)}
    n = np.minimum(g[F_NVALS], T)
    live = n > 0
    kind, bitoff, wlen, adj, l = (g[c] for c in (F_KIND, F_WIN_BITOFF, F_WIN_LEN, F_SEL_ADJ,
                                                 F_LOWER_BITS))
    lbo, base = g[F_LB_BITOFF], g[F_BASE]
    ef = (kind == SEG_EF) | (kind == SEG_EF_STRICT)
    windowed = ef | (kind == SEG_RB)
    hi_bit = bitoff + wlen
    nwin = np.minimum(np.where(windowed & (wlen > 0), (hi_bit + 31) >> 5, 0), W)
    a = np.clip(lbo >> 5, 0, WL)
    b = np.clip((lbo + (np.maximum(n, 1) - 1) * l) >> 5, 0, WL)
    nlw = np.where(ef, np.minimum(np.maximum(a, b) + 1, WL) + 1, 0)
    # round 2: the warp's staging, W window words then WL + 1 low words
    stage = np.zeros((R, W + WL + 1), dtype=np.int64)
    staged = np.zeros((R, W + WL + 1), dtype=bool)
    k = np.arange(W)
    m = live[:, None] & (k < nwin[:, None])
    stage[:, :W] = np.where(m, words[np.clip(g[F_WIN_WORD0][:, None] + k, 0, nw - 1)], 0)
    staged[:, :W] = m
    k = np.arange(WL + 1)
    m = live[:, None] & (k < nlw[:, None])
    stage[:, W:] = np.where(m, words[np.clip(g[F_LB_WORD0][:, None] + k, 0, nw - 1)], 0)
    staged[:, W:] = m
    rows = np.arange(R)[:, None]

    def read(idx, active):
        assert staged[rows, idx][active].all(), "read a staging word that was never copied"
        return stage[rows, idx]

    def winmask(kk):
        return _low_mask(hi_bit[:, None] - 32 * kk) & ~_low_mask(bitoff[:, None] - 32 * kk) & _M32

    def write(j, sel, active):
        active = active & live[:, None]
        bit_off = lbo[:, None] + j * l[:, None]
        w0i = np.clip(bit_off >> 5, 0, WL)
        s = bit_off & 31
        isef = ef[:, None] & active
        lw0 = np.where(isef, read(W + w0i, isef), 0)
        has1 = isef & (w0i + 1 <= WL)
        lw1 = np.where(has1, read(W + np.minimum(w0i + 1, WL), has1), 0)
        lowv = ((lw0 >> s) | np.where(s > 0, (lw1 << (32 - s)) & _M32, 0)) & _low_mask(l)[:, None]
        high = np.maximum(sel + adj[:, None] - j, 0)
        efv = np.where(l[:, None] >= 32, 0, (high << np.clip(l, 0, 31)[:, None]) & _M32) | lowv
        kk = kind[:, None]
        val = np.where(kk == SEG_EF, efv, 0)
        val = np.where(kk == SEG_EF_STRICT, efv + j, val)
        val = np.where(kk == SEG_RB, sel + adj[:, None], val)
        val = np.where(kk == SEG_AO, j, val)
        v = (val + base[:, None]) & _M32
        v = np.where(v >= 1 << 31, v - (1 << 32), v)
        jj = np.clip(j, 0, T - 1)
        out[np.broadcast_to(rows, j.shape)[active], jj[active]] = v[active]

    # kinds without a window: a lane a slot
    flat = live & ~windowed
    for j0 in range(0, T, 32):
        j = j0 + LANES[None, :].repeat(R, 0)
        write(j, np.zeros_like(j), flat[:, None] & (j < n[:, None]))
    walkers = live & windowed
    before = np.zeros(R, dtype=np.int64)
    for c in range(0, W, 32):
        walk = walkers & (c < nwin) & (before < n)
        if not walk.any():
            break
        kk = c + LANES[None, :].repeat(R, 0)
        inw = walk[:, None] & (kk < nwin[:, None])
        v = np.where(inw, read(np.minimum(kk, W - 1), inw) & winmask(kk), 0)
        tot = _scan(np.bitwise_count(v.astype(np.uint64)).astype(np.int64))[:, 31]
        end = np.where(walk, np.minimum(before + tot, n), before)
        for j, sel, active in _lane_rank_rounds(v, before, end, c):
            write(j, sel - bitoff[:, None], active)
        before = np.where(walk, before + tot, before)
    tail = walkers & (before < n)
    full = tail & (nwin == W)
    last = np.where(full, read(np.full((R, 1), W - 1), full[:, None])[:, 0]
                    & winmask(np.full((R, 1), W - 1))[:, 0], 0)
    for q in range(0, T, 32):
        j = before[:, None] + q + LANES
        rem = j - before[:, None]
        sel = (W - 1) * 32 + _select_in_word(last[:, None] + 0 * j, rem) - bitoff[:, None]
        write(j, sel, tail[:, None] & (j < n[:, None]))
    return out


# -- tests --------------------------------------------------------------------

@pytest.mark.parametrize("name", EF_TYPES)
def test_plain_decode_matches_jax_and_numpy_on_every_segment(coll, name):
    port = build_index(coll, name, "port")
    ref = build_index(coll, name, "ref")
    dindex = DeviceIndex(port, device="cpu")
    jindex = JaxDeviceIndex(ref)
    for key in ("docs_segs", "freqs_segs"):
        for k, v in getattr(jindex, key).items():
            np.testing.assert_array_equal(getattr(dindex, key)[k], v, err_msg=f"{key}.{k}")
    np.testing.assert_array_equal(dindex.list_n, jindex.list_n)
    for stream in ("docs", "freqs"):
        words, fields, list_n, st = stream_call(dindex, stream)
        got = plain(words, fields, list_n, st)
        np.testing.assert_array_equal(got, jax_call(words, fields, list_n, st))
        segs = {k: v for k, v in fields.items()}
        exp = decode_segments_numpy(words, segs, st["rows"], st["L_out"], st["sentinel"])
        np.testing.assert_array_equal(jax_decode_numpy(words, segs, st["rows"], st["L_out"],
                                                       st["sentinel"]), exp)
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_decode_on_seeded_edge_rows(seed):
    words, fields, list_n, st = segment_rows(seed)
    got = plain(words, fields, list_n, st)
    np.testing.assert_array_equal(got, jax_call(words, fields, list_n, st))
    assert (got != st["sentinel"]).sum() > 10_000


@pytest.mark.parametrize("seed", [0, 1])
def test_k9_model_matches_plain_on_seeded_edge_rows(seed):
    words, fields, list_n, st = segment_rows(seed)
    np.testing.assert_array_equal(k9_model(words, fields, list_n, **st),
                                  plain(words, fields, list_n, st))


@pytest.mark.parametrize("name", ["ef", "opt"])
def test_k9_model_matches_plain_on_every_segment(coll, name):
    dindex = DeviceIndex(build_index(coll, name, "port"), device="cpu")
    for stream in ("docs", "freqs"):
        words, fields, list_n, st = stream_call(dindex, stream)
        np.testing.assert_array_equal(k9_model(words, fields, list_n, **st),
                                      plain(words, fields, list_n, st))


@pytest.mark.parametrize("name", EF_TYPES)
def test_decode_group_plain_matches_jax_per_group(coll, name):
    """Every group of the tile engine's layout over every list (each list a
    one-term query), both streams: the slots j < n_vals equal JAX's."""
    eng = TileQueryEngine(build_index(coll, name, "port"), device="cpu")
    nl = eng.dindex.num_lists
    groups, gfields = eng._build_batch(np.arange(nl), np.ones(nl, np.float32),
                                       np.ones(nl, np.int64))[:2]
    assert groups
    for stream, words in (("docs", eng.dindex.docs_words), ("freqs", eng.dindex.freqs_words)):
        jw = jnp.asarray(words.numpy().view(np.uint32))
        for off, R, W, WL in groups:
            fld = gfields[off:off + R, (0 if stream == "docs" else N_FIELDS):][:, :N_FIELDS]
            fld = np.ascontiguousarray(fld)
            n0 = decode_group.launches
            got = decode_group(words, _t(fld), W, WL).numpy()
            assert decode_group.launches == n0 and got.dtype == np.int32
            exp = np.asarray(_jax_group(jw, jnp.asarray(fld), W, WL))
            valid = np.arange(got.shape[1])[None, :] < fld[:, F_NVALS, None]
            assert valid.any()
            np.testing.assert_array_equal(got[valid], exp[valid], err_msg=f"{stream} {W} {WL}")


CANARIES = (-0x5EED, 0x7EEDBEEF)  # two fills: a slot written reads a value other than both


def _k6g_check(words_u32, fld, W, WL, T, what):
    """k6g_model over one group against _decode_stream on the slots
    j < n_vals, and no slot past them (nor of a pad row) written."""
    exp = _decode_stream(_t(words_u32.view(np.int32)), _t(fld), W, WL, T).to(torch.int32).numpy()
    valid = np.arange(T)[None, :] < fld[:, F_NVALS, None]
    for canary in CANARIES:
        got = k6g_model(words_u32, fld, W, WL, T, canary)
        np.testing.assert_array_equal(got[valid], exp[valid], err_msg=what)
        assert (got[~valid] == canary).all(), f"{what}: a slot past n_vals was written"
    return int(valid.sum())


@pytest.mark.parametrize("name", EF_TYPES)
def test_k6g_model_matches_plain_per_group(coll, name):
    """k6g_model on every group of the tile engine's layout over every list,
    both streams: the n_vals slots equal _decode_stream's, nothing else
    written."""
    eng = TileQueryEngine(build_index(coll, name, "port"), device="cpu")
    nl = eng.dindex.num_lists
    groups, gfields = eng._build_batch(np.arange(nl), np.ones(nl, np.float32),
                                       np.ones(nl, np.int64))[:2]
    slots = 0
    for stream, words in (("docs", eng.dindex.docs_words), ("freqs", eng.dindex.freqs_words)):
        w = words.numpy().view(np.uint32)
        for off, R, W, WL in groups:
            fld = gfields[off:off + R, (0 if stream == "docs" else N_FIELDS):][:, :N_FIELDS]
            slots += _k6g_check(w, np.ascontiguousarray(fld), W, WL, 128,
                                f"{name} {stream} ({W}, {WL})")
    assert slots > 10_000


@pytest.mark.parametrize("seed", [0, 1])
def test_k6g_model_matches_plain_on_seeded_edge_rows(seed):
    """k6g_model on tests/torch_tile_rows.py's groups: W = WL = 64, l 0, 31
    and 32, every kind, windows and low words past the stream's end, n_vals
    0, 1, 128, above T and negative, few-ones windows, T = 32, W = 256."""
    words, groups = tile_rows(seed)
    assert [g[0] for g in groups] == list(TILE_CASES)
    for case, fld, W, WL, T in groups:
        assert _k6g_check(words, fld, W, WL, T, case) > 0


def test_decode_group_out_keyword_on_cpu():
    """decode_group(out=) on the CPU writes the slots j < n_vals into the
    given buffer and leaves the rest as they were."""
    words, groups = tile_rows(2)
    case, fld, W, WL, T = groups[0]
    t_words = _t(words.view(np.int32))
    buf = torch.full((len(fld), T), CANARIES[0], dtype=torch.int32)
    got = decode_group(t_words, _t(fld), W, WL, T, out=buf)
    assert got is buf
    valid = torch.arange(T)[None, :] < _t(fld)[:, F_NVALS, None]
    exp = decode_group(t_words, _t(fld), W, WL, T)
    assert torch.equal(got[valid], exp[valid])
    assert bool((got[~valid] == CANARIES[0]).all()) and bool((~valid).any())


def test_cpu_wrapper_takes_plain_version_without_counting():
    words, fields, list_n, st = segment_rows(3)
    n0 = decode_rows.launches
    got = decode_rows(_t(words.view(np.int32)), *(_t(fields[k]) for k in FIELDS), _t(list_n), **st)
    assert decode_rows.launches == n0
    np.testing.assert_array_equal(got.numpy(), plain(words, fields, list_n, st))
    assert decode.decode_segments_device is decode_rows


def test_offsets_past_2_31_bits_raise(coll):
    words, fields, list_n, st = segment_rows(0)
    wide = {k: v.astype(np.int64) for k, v in fields.items()}
    args = lambda f: [_t(f[k]) for k in FIELDS]  # noqa: E731
    # int64 fields inside 2^31 bits decode as the int32 ones do
    got = decode_rows(_t(words.view(np.int32)), *args(wide), _t(list_n), **st)
    np.testing.assert_array_equal(got.numpy(), plain(words, fields, list_n, st))
    for field, at in (("sel_start", (1 << 31) - 100), ("lb_start", (1 << 31) - 64)):
        bad = dict(wide)
        bad[field] = bad[field].copy()
        bad[field][0] = at
        with pytest.raises(ValueError, match="2\\^31"):
            decode_rows(_t(words.view(np.int32)), *args(bad), _t(list_n), **st)
    # the host tables of a DeviceIndex, and an engine's packed chunk
    dindex = DeviceIndex(build_index(coll, "opt", "port"), device="cpu")
    li = int(np.argmax(dindex.list_n))
    s0 = dindex.d_ranges[li, 0]
    dindex.docs_segs["sel_start"] = dindex.docs_segs["sel_start"].copy()
    dindex.docs_segs["sel_start"][s0] += 1 << 31
    with pytest.raises(ValueError, match="2\\^31"):
        dindex.decode_docs([li], 1 << 12)
    with pytest.raises(ValueError, match="2\\^31"):
        QueryEngine(dindex).and_counts([[li]])
    dindex.decode_freq_cums([li], 1 << 12)  # the freqs stream is untouched


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_sharded_plane_matches_jax(dp, tp):
    rng = np.random.RandomState(dp * 10 + tp)
    num_docs, B, T, L, k = 300, 8, 8, 32, 10
    docs = np.full((B, T, L), num_docs, dtype=np.int32)
    freqs = np.zeros((B, T, L), dtype=np.int32)
    qw = rng.uniform(0.5, 3.0, size=(B, T)).astype(np.float32)
    qw[rng.rand(B, T) < 0.3] = 0.0
    for b in range(B):
        for t in range(T):
            n = rng.randint(0, L + 1)  # from pools that overlap, so some docs hold every term
            docs[b, t, :n] = np.sort(rng.choice(40 + 8 * t, n, replace=False))
            freqs[b, t, :n] = rng.randint(1, 9, n)
    norm_lens = rng.uniform(0.3, 2.5, num_docs).astype(np.float32)
    jmesh = jax_make_mesh(cpu_devices(8), dp=dp, tp=tp)
    exp = [np.asarray(x) for x in jax_plane_step(jmesh, num_docs, k)(
        jnp.asarray(docs), jnp.asarray(freqs), jnp.asarray(qw), jnp.asarray(norm_lens))]
    mesh = make_mesh([torch.device("cpu")] * 8, dp=dp, tp=tp)
    assert mesh.shape == dict(jmesh.shape)
    got = [x.numpy() for x in make_sharded_plane_step(mesh, num_docs, k)(docs, freqs, qw,
                                                                         norm_lens)]
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert (got[0] > 0).any() and (got[1] > got[0]).any()
    for g, e in zip(got[2:], exp[2:]):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(e))
        np.testing.assert_allclose(g[np.isfinite(g)], e[np.isfinite(e)], rtol=1e-3)
    # the default mesh shape matches the JAX package's over 8 devices
    assert make_mesh([torch.device("cpu")] * 8).shape == dict(jax_make_mesh(cpu_devices(8)).shape)
