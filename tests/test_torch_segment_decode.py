"""ds2i_torch.ops.decode (the batched segment decode, K9's plain version),
ops.pair_decode.decode_group (K6g's) and parallel.sharded_engine against
the JAX package:

  - decode_rows_torch bit-equal to the JAX decode_rows (jit) and to both
    packages' decode_segments_numpy over every segment of both streams of
    the four EF-family index types, and the port's segment tables equal
    to the JAX DeviceIndex's;
  - the same on the seeded edge rows of tests/torch_segment_rows.py;
  - a numpy model of csrc/segment_decode.cu's warp, lane by lane (the
    window walked 32 words a step, each lane storing its word's ones at
    their ranks, the slots past the window's ones with sel = 0), equal to
    decode_rows_torch on those rows and on every segment of `ef` and
    `opt`;
  - decode_group's plain path against the JAX tile_executor._decode_group
    on every group of every EF-family index's tile tables, both streams,
    the n_vals slots;
  - ValueError where a segment's bits lie past bit 2^31 of its stream;
  - make_sharded_plane_step against the JAX one on the 8-device CPU mesh
    (dp x tp = 4 x 2 and 2 x 4) on seeded batches.

All inputs come from numpy seeds. Serial time ~25 s on the CPU."""

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
from ds2i_torch.ops.pair_decode import decode_group
from ds2i_torch.ops.segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB
from ds2i_torch.parallel.sharded_engine import make_mesh, make_sharded_plane_step

from test_torch_host_copy import build_index
from torch_segment_rows import segment_rows

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


# -- a numpy model of csrc/segment_decode.cu, lane by lane -------------------

_M32 = 0xFFFFFFFF


def _low_mask(h):
    return _M32 if h >= 32 else (0 if h <= 0 else (1 << h) - 1)


def k9_model(words, fields, list_n, W, Lseg, rows, L_out, sentinel):
    """What segment_rows_kernel writes, a warp a segment: the window walked
    32 words a step (lane w masks word w; an inclusive scan of the
    popcounts; each lane stores its word's ones at their ranks while
    rank < n), the walk ending at the last needed word or at n ones, then
    slot j = before + lane + 32 t with sel = 0."""
    nw = len(words)
    out = np.full((rows, L_out), sentinel, dtype=np.int64)

    def load(i):
        return int(words[min(max(i, 0), nw - 1)])

    f = {k: fields[k].astype(np.int64) for k in FIELDS}
    for r in range(len(f["kind"])):
        n = min(int(f["n_vals"][r]), Lseg)
        row = int(f["list_row"][r])
        row = row + rows if row < 0 else row
        if n <= 0 or not 0 <= row < rows:
            continue
        lim = min(L_out, int(list_n[row]))
        if lim <= 0:
            continue
        kind, l = int(f["kind"][r]), int(f["lower_bits"][r])
        lb, ob, base = int(f["lb_start"][r]), int(f["out_begin"][r]), int(f["base"][r]) & _M32

        def store(j, sel):
            col = ob + j
            if col < 0:
                col += L_out + 1
            if not 0 <= col < lim:
                return
            wide = l >= 32 or l < 0
            val = 0
            if kind in (SEG_EF, SEG_EF_STRICT):
                bit_off = lb + j * l
                w0i, sh = bit_off >> 5, bit_off & 31
                w0, w1 = load(w0i), load(w0i + 1)
                low = ((w0 >> sh) | ((w1 << (32 - sh)) & _M32 if sh else 0)) & \
                    (_M32 if wide else (1 << l) - 1)
                val = (0 if wide else (((sel - j - 1) & _M32) << l) & _M32) | low
                if kind == SEG_EF_STRICT:
                    val = (val + j) & _M32
            elif kind == SEG_RB:
                val = sel & _M32
            elif kind == SEG_AO:
                val = j & _M32
            v = (val + base) & _M32
            out[row, col] = v - (1 << 32) if v >= 1 << 31 else v

        start, slen = int(f["sel_start"][r]), int(f["sel_len"][r])
        word0, off = start >> 5, start & 31
        needed = (off + slen + 31) >> 5 if slen > 0 else 0
        nwin = min(needed, W)
        before, c = 0, 0
        while c < nwin and before < n:
            v = [load(word0 + c + lane) & (_low_mask(off + slen - 32 * (c + lane))
                                           & ~_low_mask(off - 32 * (c + lane)) & _M32)
                 if c + lane < nwin else 0 for lane in range(32)]
            pc = [bin(x).count("1") for x in v]
            inc = np.cumsum(pc)
            for lane in range(32):
                rank, x = before + int(inc[lane]) - pc[lane], v[lane]
                while x and rank < n:
                    b = (x & -x).bit_length() - 1
                    x &= x - 1
                    store(rank, (c + lane) * 32 + b - off)
                    rank += 1
            before += int(inc[31])
            c += 32
        for j in range(before, n):
            store(j, 0)
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
