"""The plain PyTorch block decoders of ds2i_torch.ops.block_decode against
the JAX device ops, bit for bit, on inputs made from a seed with numpy:
optpfor_decode_torch against optpfor_decode(b_static=b, ex_patch=True),
interp_decode_torch against interp_decode and interp_decode_np."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu.codecs.interpolative import BitWriter32
from ds2i_tpu.ops.interp_device import interp_decode, interp_decode_np
from ds2i_tpu.ops.optpfor_device import optpfor_decode

from ds2i_torch.ops.block_decode import interp_decode_torch, optpfor_decode_torch

T = 128


def _optpfor_inputs(rng, b, E, R=24):
    """A random word stream, R rows of slot cursors, and per row n_ex in
    0..E resident patch pairs (distinct positions, high << b) appended to
    the stream. The last two rows start their slot section and their
    patch pairs at the stream's end, so the gathers clamp."""
    bs = min(b, 32)
    ws = (31 + T * bs) // 32 + 1
    nslot = 4 * ws + 64
    words = [rng.randint(0, 1 << 32, size=nslot, dtype=np.uint64).astype(np.uint32)]
    slot_w0 = rng.randint(0, nslot - ws, size=R)
    slot_boff = rng.choice([0, 8, 16, 24], size=R)
    n_ex = np.array([rng.randint(0, E + 1) for _ in range(R)])
    n_ex[:3] = [0, E, min(1, E)]
    ex_base = np.zeros(R, np.int64)
    nw = nslot
    for r in range(R):
        pos = rng.choice(T, size=n_ex[r], replace=False)
        high = rng.randint(1, 1 << 20, size=n_ex[r]).astype(np.uint64)
        pairs = np.empty(2 * n_ex[r], np.uint32)
        pairs[0::2] = pos
        pairs[1::2] = (high << np.uint64(min(b, 31))) & np.uint64(0xFFFFFFFF)
        ex_base[r] = nw
        words.append(pairs)
        nw += len(pairs)
    words = np.concatenate(words)
    slot_w0[-2:] = [nw - 3, nw - 1]
    slot_boff[-1] = 24
    ex_base[-2:] = [nw - 3, nw - 1]
    n_ex[-2:] = [E, E]
    return words, slot_w0, slot_boff, n_ex, ex_base, ws


@pytest.mark.parametrize("E", [0, 4, 128])
@pytest.mark.parametrize("b", [0, 1, 7, 16, 31, 32])
def test_optpfor_decode_matches_jax(b, E):
    rng = np.random.RandomState(1000 + 7 * b + E)
    words, slot_w0, slot_boff, n_ex, ex_base, ws = _optpfor_inputs(rng, b, E)
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    exp = np.asarray(optpfor_decode(
        jnp.asarray(words), i32(slot_w0), i32(slot_boff), i32(np.full(len(n_ex), b)),
        i32(n_ex), i32(ex_base), i32(np.zeros(len(n_ex))), WS=ws, E=E, T=T,
        b_static=b, ex_patch=True,
    ))
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    got = optpfor_decode_torch(
        torch.from_numpy(words.view(np.int32)), t(slot_w0), t(slot_boff), t(n_ex),
        t(ex_base), ws, E, b, T).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, exp)
    if E and b < 32:
        # the patches did land: some row differs from its unpatched slots
        plain = optpfor_decode_torch(
            torch.from_numpy(words.view(np.int32)), t(slot_w0), t(slot_boff), t(n_ex),
            t(ex_base), ws, 0, b, T).numpy()
        assert (plain != got).any()


def _interp_rows(rng, NC, W, R=12):
    """Interpolative blocks with n in {0, 1, 2, 127, 128} (those <= NC)
    and random n, each placed at a random bit offset of a W-word window.
    Returns the windows and, per row, the true values when the code fits
    the window (None otherwise)."""
    ns = [n for n in (0, 1, 2, 127, 128) if n <= NC]
    ns += [int(rng.randint(1, NC + 1)) for _ in range(R - len(ns))]
    win = np.zeros((len(ns), W), np.uint32)
    rel0, sums, expect = [], [], []
    for r, n in enumerate(ns):
        universe = int(rng.choice([n + 4, 1000, 1 << 20, 1 << 30]))
        vals = np.sort(rng.randint(0, universe, size=n)).astype(np.int64)
        s = int(vals[-1]) if n else 0
        bw = BitWriter32()
        if n > 1:
            bw.write_interpolative(vals, 0, n - 1, 0, s)
        words = np.asarray(bw.words, dtype=np.uint64)
        off = int(rng.randint(0, 32))
        shifted = np.zeros(len(words) + 1, dtype=np.uint64)
        shifted[: len(words)] |= (words << np.uint64(off)) & np.uint64(0xFFFFFFFF)
        if off:
            shifted[1: len(words) + 1] |= words >> np.uint64(32 - off)
        fits = len(shifted) <= W
        k = min(W, len(shifted))
        win[r, :k] = shifted[:k].astype(np.uint32)
        rel0.append(off)
        sums.append(s)
        expect.append(vals if fits else None)
    return win, np.array(rel0), np.array(ns), np.array(sums), expect


@pytest.mark.parametrize("W", [4, 16, 64, 180])
@pytest.mark.parametrize("NC", [8, 16, 32, 64, 128])
def test_interp_decode_matches_jax(NC, W):
    rng = np.random.RandomState(100 * NC + W)
    win, rel0, n, sums, expect = _interp_rows(rng, NC, W)
    exp = np.asarray(interp_decode(
        jnp.asarray(win), jnp.asarray(rel0, jnp.int32), jnp.asarray(n, jnp.int32),
        jnp.asarray(sums, jnp.int32), NC=NC, W=W, steps=NC - 1))
    exp_np = interp_decode_np(win, rel0, n, sums, NC=NC, W=W, steps=NC - 1)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    got = interp_decode_torch(
        torch.from_numpy(win.view(np.int32)), t(rel0), t(n), t(sums), NC=NC, W=W,
        steps=NC - 1).numpy()
    assert got.dtype == np.int32 and got.shape == (len(n), NC)
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, exp_np)
    for r, vals in enumerate(expect):
        if vals is not None:
            np.testing.assert_array_equal(got[r, : n[r]], vals, err_msg=f"row {r} n={n[r]}")
        assert not got[r, n[r]:].any()
    assert sum(v is not None and len(v) >= 2 for v in expect) > 0  # decoded, not just pads
