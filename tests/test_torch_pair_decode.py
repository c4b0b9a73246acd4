"""ds2i_torch.ops.pair_decode against the JAX package: the plain PyTorch
decode must equal the Pallas kernel (interpret mode) and its XLA twin
(tile_executor._decode_group via resident._decode_pair_blocks) bit for
bit, over every tile group of all four EF-family index types, plus
hand-picked edge rows. All inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu.engine import resident as jax_resident
from ds2i_tpu.io import generate_collection
from ds2i_tpu.ops import pallas_decode

from ds2i_torch.engine import ResidentEngine
from ds2i_torch.engine.tiles import (
    F_KIND, F_LB_BITOFF, F_LB_WORD0, F_LOWER_BITS, F_NVALS, F_WIN_BITOFF,
    F_WIN_LEN, F_WIN_WORD0, N_FIELDS,
)
from ds2i_torch.ops import pair_decode
from ds2i_torch.ops.pair_decode import decode_pair, decode_pair_torch, popcount32
from ds2i_torch.ops.segments import SEG_AO, SEG_EF, SEG_EF_STRICT, SEG_RB

from test_torch_host_copy import build_index

_jax_pair_blocks = jax.jit(
    jax_resident._decode_pair_blocks, static_argnames=("st", "R", "num_docs"))
# groups are decoded in chunks of CHUNK rows and the word streams padded
# with zeros to NW words, so the JAX compiles are keyed on the (W, WL, T)
# statics alone and shared by all four index types (no valid slot reads
# past its tile's own words)
CHUNK = 512
NW = 1 << 15


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


def build(coll_base, name):
    """The port's own index (its words equal the JAX package's:
    test_torch_host_copy.py)."""
    return build_index(coll_base, name, "port")


def _words(index, pad=True):
    out = []
    for seq in (index.docs_sequences, index.freqs_sequences):
        w = seq.bits_bv.words.view(np.uint32)
        if pad:
            assert len(w) <= NW
            w = np.concatenate([w, np.zeros(NW - len(w), np.uint32)])
        out.append(w)
    return out


def _decode_three(dw, fw, df, ff, W, WL, T, num_docs):
    """(port, pallas interpret, XLA twin) decodes of one group, as numpy:
    each a (doc (R, T), freq (R, T)) pair."""
    R = df.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    pd, pf = decode_pair_torch(t(dw), t(fw), t(df), t(ff), W, WL, T, num_docs)
    jd, jf = pallas_decode.decode_group_pair(
        jnp.asarray(dw), jnp.asarray(fw), jnp.asarray(df), jnp.asarray(ff),
        W=W, WL=WL, T=T, num_docs=num_docs, interpret=True)
    xd, xf = _jax_pair_blocks(
        jnp.asarray(dw), jnp.asarray(fw), jnp.asarray(df), jnp.asarray(ff),
        st=("ef", W, WL, T), R=R, num_docs=num_docs)
    return (
        (pd.numpy(), pf.numpy()),
        (np.asarray(jd), np.asarray(jf)),
        (np.asarray(xd).reshape(R, T), np.asarray(xf).reshape(R, T)),
    )


def _assert_same(port, pallas, xla):
    np.testing.assert_array_equal(port[0], pallas[0])
    np.testing.assert_array_equal(port[1], pallas[1])
    np.testing.assert_array_equal(port[0], xla[0])
    np.testing.assert_array_equal(port[1].astype(np.float32), xla[1])


def test_popcount32_matches_numpy():
    rng = np.random.RandomState(7)
    x = rng.randint(0, 2**32, size=20_000, dtype=np.uint64)
    x[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    got = popcount32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(x))


@pytest.mark.parametrize("name", ["ef", "single", "uniform", "opt"])
def test_all_groups_match_pallas_and_xla(coll, name):
    index = build(coll, name)
    eng = ResidentEngine(index, device="cpu")
    dw, fw = _words(index)
    nt = eng.pad_tile
    groups, gids, _, _, _ = eng._order_groups(np.arange(nt), eng.tile_gid, eng.group_statics)
    td, tf = eng._with_pad(eng.tiles.docs), eng._with_pad(eng.tiles.freqs)
    seen = 0
    for off, R, (_, W, WL, T) in groups:
        ids = gids[off:off + R]
        ids = np.concatenate([ids, np.full(-R % CHUNK, nt, ids.dtype)])
        for c in range(0, len(ids), CHUNK):
            chunk = ids[c:c + CHUNK]
            _assert_same(*_decode_three(dw, fw, td[chunk], tf[chunk], W, WL, T, eng.num_docs))
        seen += int(np.sum(ids < nt))
    assert seen == nt


def _pow4(x):
    v = 4
    while v < x:
        v *= 4
    return v


def _edge_rows(index):
    """Docs field rows of each edge category, with the matching freqs
    rows: AO, RB, l = 0, s = 0 (low bits start on a word boundary)."""
    eng = ResidentEngine(index, device="cpu")
    d, f = eng.tiles.docs, eng.tiles.freqs
    ef = np.isin(d[:, F_KIND], (SEG_EF, SEG_EF_STRICT))
    cats = {
        "ao": d[:, F_KIND] == SEG_AO,
        "rb": d[:, F_KIND] == SEG_RB,
        "l0": ef & (d[:, F_LOWER_BITS] == 0),
        "s0": ef & (d[:, F_LOWER_BITS] > 0) & (d[:, F_LB_BITOFF] == 0),
        "f_l0": np.isin(f[:, F_KIND], (SEG_EF, SEG_EF_STRICT)) & (f[:, F_LOWER_BITS] == 0),
    }
    return eng, d, f, cats


def test_edge_rows_match_pallas_and_xla(coll):
    rng = np.random.RandomState(3)
    covered = set()
    for name in ("opt", "ef"):
        index = build(coll, name)
        eng, d, f, cats = _edge_rows(index)
        rows = []
        for cat, m in cats.items():
            idx = np.flatnonzero(m)
            if len(idx):
                covered.add(cat)
                rows.extend(rng.choice(idx, size=min(4, len(idx)), replace=False))
        dw, fw = _words(index)
        pad = np.zeros((1, N_FIELDS), np.int32)
        pad[0, F_KIND] = -1  # the engine's pad tile
        df = np.concatenate([d[rows], pad])
        ff = np.concatenate([f[rows], pad])
        df = np.concatenate([df, np.repeat(pad, CHUNK - len(df), axis=0)])
        ff = np.concatenate([ff, np.repeat(pad, CHUNK - len(ff), axis=0)])
        # the engine's pow4 buckets of the rows' window words
        W = _pow4(eng.tiles.win_words[rows].max())
        WL = _pow4(eng.tiles.lb_words[rows].max())
        out = _decode_three(dw, fw, df, ff, W, WL, 128, eng.num_docs)
        _assert_same(*out)
        assert np.all(out[0][0][len(rows):] == eng.num_docs)
        assert np.all(out[0][1][len(rows):] == 0)
    assert covered == {"ao", "rb", "l0", "s0", "f_l0"}, covered


def test_window_at_stream_end_clamps(coll):
    """A tile whose select and low-bit words end at the stream's last
    word: the W-word window reads past the end and clamps, and every
    valid slot still equals the decode over the full stream."""
    index = build(coll, "ef")
    eng = ResidentEngine(index, device="cpu")
    dw, fw = _words(index, pad=False)
    d, f = eng.tiles.docs, eng.tiles.freqs
    r = len(d) - 1  # the last list's last tile
    end_win = d[r, F_WIN_WORD0] + (d[r, F_WIN_BITOFF] + d[r, F_WIN_LEN] + 31) // 32
    end_lb = d[r, F_LB_WORD0] + (d[r, F_LB_BITOFF] + d[r, F_NVALS] * d[r, F_LOWER_BITS] + 31) // 32
    cut = int(max(end_win, end_lb))
    short = dw[:cut]
    df = np.repeat(d[r:r + 1], 8, axis=0)
    ff = np.repeat(f[r:r + 1], 8, axis=0)
    _, W, WL, T = eng.group_statics[eng.tile_gid[r]]
    # the select or the (WL+1)-word low-bit window does run past the end
    assert d[r, F_WIN_WORD0] + W > cut or d[r, F_LB_WORD0] + WL + 1 > cut
    trunc = _decode_three(short, fw, df, ff, W, WL, T, eng.num_docs)
    _assert_same(*trunc)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    full = decode_pair_torch(t(dw), t(fw), t(df), t(ff), W, WL, T, eng.num_docs)
    np.testing.assert_array_equal(trunc[0][0], full[0].numpy())
    np.testing.assert_array_equal(trunc[0][1], full[1].numpy())
    hd, _ = index.decode_list(int(eng.tiles.tile_list[r]))
    n = int(d[r, F_NVALS])
    np.testing.assert_array_equal(trunc[0][0][0, :n], hd[-n:])
    assert np.all(trunc[0][0][:, n:] == eng.num_docs)


def test_cpu_wrapper_takes_plain_version_without_counting(coll):
    """On CPU tensors the part-level wrapper decode_pair (one launch over
    a part on the card) writes what decode_pair_launch_torch writes, which
    is decode_pair_torch's decode of each group, and counts nothing."""
    index = build(coll, "opt")
    eng = ResidentEngine(index, device="cpu")
    eng._ensure_norm_cache()
    s, nd = eng.state, eng.num_docs
    part = eng.all_tiles_part()
    lay = part.layout
    launch = lay.launch("pair", True, "cpu")
    before = pair_decode.decode_pair.launches
    outs = {}
    for mode in ("docs", "presence", "bm25"):
        out = torch.full((lay.nb_d, 32), -7, dtype=torch.int32)
        w = torch.full((lay.nb_d, 32), -7.0)
        got = decode_pair(launch, s.docs_words, s.freqs_words, s.tiles_docs, s.tiles_freqs,
                          part.gtile_ids, mode, nd, out, w, s.den_blocks, s.tile_gblk0)
        assert got[0] is out and got[1] is w
        outs[mode] = (out, w)
    assert pair_decode.decode_pair.launches == before
    for off, R, (_, W, WL, T) in lay.groups:
        ids = part.gtile_ids[off:off + R]
        doc, freq = decode_pair_torch(s.docs_words, s.freqs_words, s.tiles_docs[ids],
                                      s.tiles_freqs[ids], W, WL, T, nd)
        blk = slice(sum(Rg * sg[-1] // 32 for o, Rg, sg in lay.groups if o < off), None)
        d = outs["docs"][0][blk][:R * T // 32].reshape(R, T)
        torch.testing.assert_close(d, doc, rtol=0, atol=0)
        torch.testing.assert_close(outs["bm25"][0][blk][:R * T // 32].reshape(R, T), doc,
                                   rtol=0, atol=0)
        f = freq.float()
        den = s.den_blocks[s.tile_gblk0[ids][:, None] + torch.arange(T // 32)].reshape(R, T)
        torch.testing.assert_close(outs["bm25"][1][blk][:R * T // 32].reshape(R, T),
                                   f / (f + den), rtol=0, atol=0)
        torch.testing.assert_close(outs["presence"][1][blk][:R * T // 32].reshape(R, T),
                                   torch.where(doc < nd, 1.0, 0.0), rtol=0, atol=0)
    assert (outs["docs"][1] == -7.0).all(), "docs mode writes no weights"
