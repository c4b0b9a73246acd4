"""Numpy models of the row prologues of csrc/qmx_decode.cu (K8) and
csrc/varint_decode.cu (K7), lane by lane, against the plain decoders
(qmx_decode_torch, varint_decode_torch) bit for bit on the CPU:

  - K8 stages a block's words in one round, from its payload's first
    word (BF_W0) through the word after its last selector byte
    (BF_EX_W0), indices clamped to the stream and the count capped by
    the group's NI and S; the selectors and the extracts read that
    stage, and any word outside it comes from the stream (clamped). A
    lane decodes four consecutive slots of one instance, found, as each
    instance's selector is, by counting the bits of a warp-wide mask;
    the model checks both counts against the plain op's searches slot by
    slot. Over every full QMX block of a small block_qmx
    index no read leaves the stage; over the seeded edge rows of
    tests/torch_block_rows.py (ninst < NI, nsel < S, NI and S at 32,
    the stream's last block, malformed cursors) some do, and the model
    counts them.
  - K7 stages only the words its min(ngroups, G) groups reach; the model
    checks that every byte the decode reads lies in them.

The edge rows also go through the JAX package's qmx_decode and
varint_decode, which the plain decoders equal. About 20 s serially on
the build host's CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu.ops.qmx_device import qmx_decode as jax_qmx_decode
from ds2i_tpu.ops.varint_device import varint_decode as jax_varint_decode

from ds2i_torch.engine import ResidentEngine
from ds2i_torch.engine.block_tiles import BF_B, BF_BOFF, BF_EX_BOFF, BF_EX_W0, BF_NEX, BF_W0
from ds2i_torch.host import BinaryFreqCollection, GlobalParameters, generate_collection
from ds2i_torch.host import make_index_type
from ds2i_torch.ops.block_decode import qmx_decode_torch, qmx_lane_words, varint_decode_torch

from torch_block_rows import qmx_rows, varint_rows

M32 = 0xFFFFFFFF
TYPES, LANES = 15, 256  # csrc/qmx_decode.cu kTypes, kLanes
LANE_WORDS = qmx_lane_words().view(np.uint32).astype(np.int64)


def stage_words(ni, s):
    """csrc/qmx_decode.cu stage_words: the words of a block of ni
    instances and s selectors, from its payload's first word through the
    word after its last selector byte."""
    return (2 + 32 * ni + s) // 4 + 2


def _search(keys, n, x):
    """The kernels' binary search: how many of keys[:n] are <= x (keys
    ascending)."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        lo, hi = (mid + 1, hi) if keys[mid] <= x else (lo, mid)
    return lo


def k8_row(words, f, NI, S):
    """One row of the K8 kernel, as its warp computes it: (the 128 raw
    values, uint32 in int64; the reads of words outside the stage; whether
    every lane took the staged path, whose extracts read the stage
    unchecked)."""
    nw = len(words)
    NI, S = max(1, min(NI, 32)), max(0, min(S, 32))
    pay_w0, pay_boff, ninst = int(f[BF_W0]), int(f[BF_BOFF]), int(f[BF_B])
    nsel, sel_w0, sel_b = int(f[BF_NEX]), int(f[BF_EX_W0]), int(f[BF_EX_BOFF])
    nstage = max(0, min(stage_words(NI, S), sel_w0 - pay_w0 + 2))
    stage = words[np.clip(pay_w0 + np.arange(nstage), 0, nw - 1)]
    outside = 0

    def word_at(k):
        nonlocal outside
        if 0 <= k < nstage:
            return int(stage[k])
        outside += 1
        return int(words[min(max(pay_w0 + k, 0), nw - 1)])

    stype, batch = [0] * 32, [0] * 32
    for lane in range(max(0, min(S, nsel))):
        bk = sel_b - lane
        sel = (word_at(sel_w0 - pay_w0 + (bk >> 2)) >> ((bk & 3) * 8)) & 0xFF
        stype[lane], batch[lane] = sel >> 4, 16 - (sel & 15)
    cover = np.cumsum(batch)
    cover_bits = sum(1 << int(c) for c, b in zip(cover, batch) if b > 0 and c < 32)
    itype, ints, adv = [0] * 32, [0] * 32, [0] * 32
    for lane in range(32):
        sel_of = bin(cover_bits & ((2 << lane) - 1)).count("1")
        itype[lane] = stype[sel_of & 31] if lane < NI and sel_of < S else 0
        s = _search(cover, S, lane)  # the plain op's rule: the first s < S with cover[s] > i
        assert itype[lane] == (stype[s] if lane < NI and s < S else 0)
        if lane < NI and lane < ninst:
            meta = int(LANE_WORDS[TYPES * LANES + min(itype[lane], TYPES - 1)])
            ints[lane], adv[lane] = meta & 0xFFFF, meta >> 16
    base = np.cumsum(ints) - ints
    pbyte = np.cumsum(adv) - adv
    start_bits = sum(1 << (int(b) >> 2) for i, b in enumerate(base)
                     if i < NI and i < ninst and b < 128)
    nvalid = max(0, min(ninst, NI))
    staged_lanes = 0

    def extract(bitoff, width, staged):
        k, sh = bitoff >> 5, bitoff & 31
        if staged:
            assert 0 <= k and k + 1 < nstage, "a staged lane's extract reads past the stage"
        lo, hi = word_at(k), word_at(k + 1)
        x = ((lo >> sh) | ((hi << (32 - sh)) & M32 if sh else 0)) & M32
        return x if width >= 32 else x & ((1 << width) - 1)

    out = np.zeros(128, np.int64)
    for lane in range(32):
        slot = 4 * lane
        inst = max(bin(start_bits & ((2 << lane) - 1)).count("1") - 1, 0)
        for k in range(4):  # the plain op's rule, slot by slot: the lane's four share inst
            assert max(_search(base, nvalid, slot + k) - 1, 0) == inst
        t = itype[inst]
        j = slot - int(base[inst])
        assert j >= 0
        e = [int(LANE_WORDS[min(t, TYPES - 1) * LANES + min(j + k, LANES - 1)]) for k in range(4)]
        bits = pay_boff + 8 * int(pbyte[inst])
        reach = max([x & 0xFF for x in e] + [(x >> 16) & 0xFF for x in e if x >> 24])
        staged = bits >= 0 and ((bits + reach) >> 5) + 1 < nstage
        staged_lanes += staged
        for k in range(4):
            ba, wa, bb, wb = e[k] & 0xFF, (e[k] >> 8) & 0xFF, (e[k] >> 16) & 0xFF, e[k] >> 24
            x = extract(bits + ba, wa, staged)
            if wb > 0:
                x |= (extract(bits + bb, wb, staged) << min(wa, 31)) & M32
            out[slot + k] = 1 if t == 0 else x
    return out, outside, staged_lanes == 32


def k7_row(words, f, G):
    """One row of the K7 kernel: the raw values from the words it stages,
    every byte read checked to lie in them."""
    nw = len(words)
    w0, s, ngroups = int(f[BF_W0]), int(f[BF_BOFF]), int(f[BF_B])
    G = min(G, 64)
    ng = max(0, min(ngroups, G))
    nstage = ((9 * ng - 1) >> 2) + 2 if ng > 0 else 0
    win = words[np.clip(w0 + np.arange(nstage), 0, nw - 1)].astype(np.int64)

    def byte_at(k):
        q = k >> 2
        assert q + (s > 0) < nstage, "a byte past the staged words"
        a = ((int(win[q]) >> s) | ((int(win[q + 1]) << (32 - s)) & M32 if s else 0)) & M32
        return (a >> (8 * (k & 3))) & 0xFF

    out = np.zeros(128, np.int64)
    idx = 0
    for g in range(ng):
        desc = byte_at(9 * g)
        acc = place = 0
        for i in range(8):
            d = byte_at(9 * g + 1 + i)
            if place < 4:
                acc = (acc + (d << (8 * place))) & M32
            if (desc >> i) & 1:
                if idx < 128:
                    out[idx] = acc
                idx += 1
                acc = place = 0
            else:
                place += 1
    return out


def _plain_qmx(words, fields, NI, S):
    c = lambda i: torch.from_numpy(fields[:, i].astype(np.int64))  # noqa: E731
    return qmx_decode_torch(torch.from_numpy(words.view(np.int32)), c(BF_W0), c(BF_BOFF),
                            c(BF_B), c(BF_EX_W0), c(BF_EX_BOFF), c(BF_NEX), NI, S).numpy()


def _plain_varint(words, fields, G):
    c = lambda i: torch.from_numpy(fields[:, i].astype(np.int64))  # noqa: E731
    return varint_decode_torch(torch.from_numpy(words.view(np.int32)), c(BF_W0), c(BF_BOFF),
                               c(BF_B), G).numpy()


@pytest.fixture(scope="module")
def qmx_engine(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=8, max_query_len=3)
    c = BinaryFreqCollection(base)
    b = make_index_type("block_qmx").builder(c.num_docs, GlobalParameters())
    for docs, freqs in c:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
    return ResidentEngine(b.build(), device="cpu")


@pytest.mark.parametrize("stream", ["docs", "freqs"])
def test_k8_stage_on_every_index_block(qmx_engine, stream):
    """Every full QMX block of one stream of a small block_qmx index,
    under its group's NI and S: the model equals qmx_decode_torch bit for
    bit, and no read leaves the stage."""
    eng = qmx_engine
    words = eng.state.docs_words.numpy().view(np.uint32)
    fields = eng.tiles.docs if stream == "docs" else eng.tiles.freqs
    gid, statics = ((eng.tile_gid_d, eng.group_statics_d) if stream == "docs"
                    else (eng.tile_gid_f, eng.group_statics_f))
    rows = 0
    for g, st in enumerate(statics):
        if st[0] != "qmx":
            continue
        tiles = np.flatnonzero(gid == g)
        exp = _plain_qmx(words, fields[tiles], st[1], st[2]).view(np.uint32)
        for r, t in enumerate(tiles):
            got, outside, staged = k8_row(words, fields[t], st[1], st[2])
            np.testing.assert_array_equal(got, exp[r], err_msg=f"tile {t}, statics {st}")
            assert staged and outside == 0, f"tile {t}: {outside} reads outside the stage"
        rows += len(tiles)
    assert rows > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_k8_stage_on_edge_rows(seed):
    """The seeded edge rows: the model equals qmx_decode_torch, which
    equals the JAX qmx_decode; well formed blocks read only their stage,
    and the rows that read outside it (malformed cursors, selectors before
    the payload or past the stream) are counted."""
    words, rows = qmx_rows(seed)
    kinds = {k for _, _, _, k in rows}
    assert {"fit", "bucketed", "ones", "ones_last", "alternating", "wide", "stream_end",
            "malformed"} <= kinds
    assert any(NI == S == 32 and f[BF_B] > 16 and f[BF_NEX] > 16 for NI, S, f, _ in rows)
    assert any(f[BF_B] < NI and f[BF_NEX] < S for NI, S, f, k in rows if k != "malformed")
    fallback, unstaged = {}, {}
    for NI, S, f, kind in rows:
        exp = _plain_qmx(words, f[None], NI, S).view(np.uint32)[0]
        jx = np.asarray(jax_qmx_decode(
            jnp.asarray(words), *[jnp.asarray(f[None, i]) for i in
                                  (BF_W0, BF_BOFF, BF_B, BF_EX_W0, BF_EX_BOFF, BF_NEX)],
            NI=NI, S=S)).view(np.uint32)[0]
        np.testing.assert_array_equal(exp, jx)
        got, outside, staged = k8_row(words, f, NI, S)
        np.testing.assert_array_equal(got, exp, err_msg=f"{kind} row, NI {NI}, S {S}")
        if kind != "malformed":
            assert staged and outside == 0, f"a well formed {kind} row read {outside} words outside"
        fallback[kind] = fallback.get(kind, 0) + (outside > 0)
        unstaged[kind] = unstaged.get(kind, 0) + (not staged)
    print(f"K8 rows that read outside the stage, by kind: {fallback}; rows off the staged "
          f"path: {unstaged}")
    assert fallback["malformed"] > 0 and unstaged["malformed"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_k7_window_on_edge_rows(seed):
    """The seeded Varint-G8IU rows (ngroups < G = 64, more groups than G
    reads, the stream's last block, malformed cursors): every byte the
    decode reads lies in the words K7 stages, and the values equal
    varint_decode_torch and the JAX varint_decode."""
    words, rows = varint_rows(seed)
    assert {"fit", "bucketed", "over_g", "stream_end", "malformed"} <= {k for _, _, k in rows}
    assert any(G == 64 and 0 < f[BF_B] < G for G, f, _ in rows)
    for G, f, kind in rows:
        exp = _plain_varint(words, f[None], G).view(np.uint32)[0]
        jx = np.asarray(jax_varint_decode(
            jnp.asarray(words), *[jnp.asarray(f[None, i]) for i in (BF_W0, BF_BOFF, BF_B)],
            G=G)).view(np.uint32)[0]
        np.testing.assert_array_equal(exp, jx)
        np.testing.assert_array_equal(k7_row(words, f, G), exp, err_msg=f"{kind} row, G {G}")
