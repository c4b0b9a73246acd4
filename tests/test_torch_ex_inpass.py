"""The in-pass Simple16 exception decode of OptPFor blocks (K1s:
ds2i_torch.ops.block_decode.optpfor_inpass_decode_torch, the plain
version of csrc/optpfor_s16_decode.cu) and the engine past its resident
word limit, on the CPU, against the JAX package:

  - the plain op against JAX optpfor_decode(..., b_static=b,
    ex_patch=False), bit for bit, on seeded light, heavy and b = 32
    blocks, on the seeded edge rows of tests/torch_block_rows.py (n_ex
    above E, highs past the stream's K values, positions that repeat,
    b = 32 with exceptions, windows clamped at the stream's ends) and on
    every OptPFor group with exceptions of a small block_optpfor index,
    both streams; those groups also equal the port's patch path
    ("optp");
  - a numpy model of the kernel's warp, lane by lane (its rounds of 32
    Simple16 words stopped at the values the op needs, each value's
    search for its word, the positions scan in rounds, the highs from
    shared memory and the atomic sums) against the plain op on the same
    rows and on every row with exceptions of the small index;
  - ResidentEngine with engine.resident.RESIDENT_WORD_LIMIT lowered
    below its words plus patch pairs against the JAX engine with
    DS2I_EX_PATCH=0: statics, tables and words, plans, decoded parts,
    CTA tables and launches, counts exactly and top-10 within rtol 1e-3,
    exhaustive and prune=True; cache_dir cold and warm under the lowered
    limit; make_engine over the index.

About 165 s serially on the build host's CPU (the JAX compiles of the op's
static classes and engines dominate)."""

import contextlib
import gc
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu.codecs.optpfor import OptPForBlock
from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine
from ds2i_tpu.engine.resident import _decode_block_stream
from ds2i_tpu.io import generate_collection
from ds2i_tpu.ops.optpfor_device import optpfor_decode
from ds2i_tpu.queries import read_queries

import chip_smoke
from ds2i_torch.codecs.simple16 import S16_MODES
from ds2i_torch.engine import ResidentEngine, make_engine, resident
from ds2i_torch.engine.block_tiles import (
    BF_B, BF_BOFF, BF_EX_BOFF, BF_EX_W0, BF_NEX, BF_W0, _E_BUCKETS, _bucket, _s16_words,
)
from ds2i_torch.engine.tiles import F_NVALS
from ds2i_torch.ops import block_decode
from ds2i_torch.ops.block_decode import block_stream_torch, optpfor_inpass_decode_torch

from test_torch_host_copy import assert_same_walk, build_index, build_wdata
from test_torch_resident import _assert_topk_close, _plan_arrays
from test_torch_split_decode import (
    check_cta_tables, check_launches_compose, check_part_decode_equals_jax,
)
from torch_block_rows import s16_more_rows, s16_rows

M32 = 0xFFFFFFFF
KW = dict(max_part_slots=1 << 13, max_part_queries=16)
CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "ds2i_torch", "csrc", "optpfor_s16_decode.cu")


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release the JAX executables each test compiled before the next
    one (the fixture of tests/test_wand_device.py)."""
    yield
    jax.clear_caches()
    gc.collect()


# -- the op ------------------------------------------------------------------


def _ws(b):
    return (31 + 128 * min(b, 32)) // 32 + 1


def jax_inpass(words, fields, b, E):
    """JAX optpfor_decode(..., b_static=b, ex_patch=False) of int32 field
    rows: (R, 128) int32."""
    f = jnp.asarray(np.asarray(fields, np.int32))
    return np.asarray(optpfor_decode(
        jnp.asarray(np.asarray(words).view(np.uint32)), f[:, BF_W0], f[:, BF_BOFF], f[:, BF_B],
        f[:, BF_NEX], f[:, BF_EX_W0], f[:, BF_EX_BOFF], WS=_ws(b), E=E, T=128, b_static=b,
        ex_patch=False))


def port_inpass(words, fields, b, E):
    f = torch.from_numpy(np.ascontiguousarray(np.asarray(fields, np.int32)))
    w = torch.from_numpy(np.ascontiguousarray(np.asarray(words).view(np.int32)))
    return optpfor_inpass_decode_torch(w, f[:, BF_W0], f[:, BF_BOFF], f[:, BF_B], f[:, BF_NEX],
                                       f[:, BF_EX_W0], f[:, BF_EX_BOFF], _ws(b), E, b).numpy()


def _seeded_blocks(kind, seed):
    """Blocks encoded by ds2i_tpu's codec at random byte offsets of one
    stream (tests/test_optpfor_device.py's shapes): (words, field rows,
    expected values)."""
    rng = np.random.RandomState(seed)
    streams, expect = [], []
    for _ in range(16):
        if kind == "b32":
            v = rng.randint(0, 2 ** 31, size=128).astype(np.uint32)
        else:
            base = rng.randint(1, 60)
            v = rng.randint(0, base, size=128).astype(np.uint32)
            n = rng.randint(1, 40 if kind == "heavy" else 6)
            v[rng.choice(128, size=n, replace=False)] = rng.randint(base, base * 5000, size=n)
        chunk = []
        OptPForBlock.encode(v, int(v.sum()), 128, chunk)
        streams.append(np.concatenate([np.asarray(c, np.uint8).reshape(-1) for c in chunk]))
        expect.append(v)
    parts, offs, cur = [], [], 0
    for s in streams:
        pad = int(rng.randint(0, 7))
        parts += [np.zeros(pad, np.uint8), s]
        offs.append(cur + pad)
        cur += pad + len(s)
    buf = np.concatenate(parts + [np.zeros(8, np.uint8)])
    buf = np.concatenate([buf, np.zeros((-len(buf)) % 4, np.uint8)])
    fields = []
    for s, off in zip(streams, offs):
        b, nex = int(s[0]), int(s[1])
        f = np.zeros(11, np.int64)
        f[BF_W0], f[BF_BOFF] = (off + 2) >> 2, ((off + 2) & 3) * 8
        f[BF_B], f[BF_NEX] = b, nex
        ex = off + 2 + 4 * ((128 * min(b, 32) + 31) // 32)
        f[BF_EX_W0], f[BF_EX_BOFF] = ex >> 2, (ex & 3) * 8
        fields.append(f)
    return buf.view("<u4"), np.stack(fields).astype(np.int32), np.stack(expect)


def _by_statics(rows):
    """{(b, E): [row indices]} of (b, E, fields, kind) rows."""
    out = {}
    for i, (b, E, _, _) in enumerate(rows):
        out.setdefault((b, E), []).append(i)
    return out


def test_s16_mode_table_matches_simple16():
    """The kernel's packed mode table (kS16Modes) is S16_MODES: run r's
    count at bits 10r, its width at bits 10r + 5."""
    src = open(CU).read()
    body = re.search(r"kS16Modes\[16\] = \{([^}]*)\}", src).group(1)
    got = [int(x, 16) for x in re.findall(r"0x[0-9a-f]+", body)]
    want = []
    for mode in S16_MODES:
        assert len(mode) <= 2
        want.append(sum(c << (10 * r) | w << (10 * r + 5) for r, (c, w) in enumerate(mode)))
    assert got == want


@pytest.mark.parametrize("kind", ["light", "heavy", "b32"])
def test_inpass_op_matches_jax_on_seeded_blocks(kind):
    """Each group of blocks sharing b under the E bucket of its largest
    n_ex (4 where none has exceptions), bit for bit against the JAX op
    and equal to the encoded values."""
    words, fields, expect = _seeded_blocks(kind, {"light": 3, "heavy": 4, "b32": 9}[kind])
    for b in np.unique(fields[:, BF_B]):
        rows = np.flatnonzero(fields[:, BF_B] == b)
        E = _bucket(max(int(fields[rows, BF_NEX].max()), 1), _E_BUCKETS)
        got = port_inpass(words, fields[rows], int(b), E)
        np.testing.assert_array_equal(got, jax_inpass(words, fields[rows], int(b), E))
        np.testing.assert_array_equal(got.view(np.uint32), expect[rows])


def test_inpass_op_matches_jax_on_edge_rows():
    """The seeded edge rows (torch_block_rows.s16_rows) grouped by their
    (b, E) statics, bit for bit against the JAX op; the rows do reach
    each edge: n_ex > E, a high past the K stream values, a repeated
    position inside the block, b = 32 with exceptions, clamped windows."""
    words, rows = s16_rows(0)
    kinds = {k for _, _, _, k in rows}
    assert {"over_e", "repeat", "b32_ex", "stream_end", "malformed", "bucketed"} <= kinds
    for (b, E), idx in _by_statics(rows).items():
        f = np.stack([rows[i][2] for i in idx])
        np.testing.assert_array_equal(port_inpass(words, f, b, E), jax_inpass(words, f, b, E),
                                      err_msg=f"b={b} E={E} {[rows[i][3] for i in idx]}")
    # the repeat row: exceptions 0 and 16 land on one slot, whose sum the
    # op takes (the encoded highs 1 + h0 and 1 + h16 shifted by 7)
    b, E, f, _ = next(r for r in rows if r[3] == "repeat")
    pos, high = _model_row(words, f, E)[1:3]
    nex = int(f[BF_NEX])
    assert pos[0] == pos[16] and 0 <= pos[0] < 128 and nex == 17
    got = port_inpass(words, f[None], b, E)[0].view(np.uint32)
    base = port_inpass(words, np.where(np.arange(11) == BF_NEX, 0, f)[None], b, E)[0].view(np.uint32)
    assert got[pos[0]] == base[pos[0]] | ((high[0] + high[16]) << 7) & M32
    # an over_e row reads highs past K as 0 (high 1)
    b, E, f, _ = next(r for r in rows if r[3] == "over_e" and int(r[2][BF_NEX]) + r[1] > 2 * r[1])
    assert _model_row(words, f, E)[2][-1] == 1


# -- a numpy model of csrc/optpfor_s16_decode.cu's warp ------------------------

_MODES = [sum(c << (10 * r) | w << (10 * r + 5) for r, (c, w) in enumerate(m)) for m in S16_MODES]


def _need(nex, E):
    """The stream values [0, need) the op reads of a row: m = min(E, n_ex)
    exceptions are valid (none where n_ex <= 0); their positions take the
    values [0, m), their highs the values n_ex + e, e < m, below K = 2E.
    So need = min(K, n_ex + m) for n_ex < K, and m for n_ex >= K (every
    high then reads past K)."""
    K = 2 * E
    m = min(E, nex) if nex > 0 else 0
    return m, (0 if nex <= 0 else m if nex >= K else min(K, nex + m))


def _model_row(words, f, E):
    """One row's exception decode as the kernel's warp does it, lane by
    lane: rounds of 32 Simple16 words, one a lane (lane 31 reading the
    realignment's next word), stopped once the values of the words read
    reach _need; each value q = 32 t + lane of a round found in its word
    by two warp reductions (a bit at each word's first index inside the
    32 values of t, and the words that start before them) and a popcount; the
    positions a warp scan of the values of lanes' registers in rounds of
    32 with a carry, the highs read from the values stored at n_ex + e
    (a high that was never stored raises KeyError: a needed value the
    rounds did not reach). Returns (patch sums (128,), positions (E,),
    highs (E,), words read): positions as int32 and highs for e < min(E,
    n_ex), else 0."""
    nw = len(words)
    w = np.asarray(words).view(np.uint32).astype(np.int64)
    K = 2 * E
    xw0, xboff = int(f[BF_EX_W0]), int(f[BF_EX_BOFF])
    nex, fb = int(f[BF_NEX]), int(f[BF_B])
    shift = min(max(fb, 0), 31)
    m, need = _need(nex, E)

    def load(i):
        return int(w[min(max(xw0 + i, 0), nw - 1)])

    val = np.zeros((4, 32), np.int64)  # value 32 t + lane, t < 4, in lane's registers
    s_high = {}  # value n_ex + e at e
    done = r = nread = 0
    while done < need and r < K:
        lo = [load(r + lane) for lane in range(32)]
        hi = lo[1:] + [load(r + 32)]  # __shfl_down_sync; lane 31 loads
        nread += 33
        x = [((a >> xboff) | (c << (32 - xboff))) & M32 if xboff else a for a, c in zip(lo, hi)]
        md = [_MODES[v >> 28] for v in x]
        cnt = [(mm & 31) + ((mm >> 10) & 31) if r + lane < K else 0
               for lane, mm in enumerate(md)]
        incl = [int(c) + done for c in np.cumsum(cnt)]  # the warp scan and its carry
        end = min(incl[31], need)
        for t in range(8):
            if 32 * t + 32 <= done or 32 * t >= end:
                continue
            first = [i - c for i, c in zip(incl, cnt)]
            starts = 0  # __reduce_or_sync: a bit at each word's first index in the window
            for c, fi in zip(cnt, first):
                if c and 32 * t <= fi < 32 * t + 32:
                    starts |= 1 << (fi - 32 * t)
            before = sum(1 for c, fi in zip(cnt, first) if c and fi < 32 * t)  # __reduce_add_sync
            for lane in range(32):
                q = 32 * t + lane
                j = before + bin(starts & ((2 << lane) - 1)).count("1") - 1
                if not done <= q < end:
                    continue
                mq, o = md[j], q - first[j]
                c0, wa, wb = mq & 31, (mq >> 5) & 31, (mq >> 15) & 31
                sh, width = (o * wa, wa) if o < c0 else (c0 * wa + (o - c0) * wb, wb)
                value = ((x[j] & 0x0FFFFFFF) >> sh) & ((1 << width) - 1)
                if t < 4:
                    val[t, lane] = value
                if q >= nex:
                    s_high[q - nex] = value
        done = incl[31]
        r += 32
    patch = np.zeros(128, np.int64)
    pos_all, high_all = np.zeros(E, np.int64), np.zeros(E, np.int64)
    carry = 0
    for t in range(4):
        if 32 * t >= m:
            break
        steps = [(val[t, lane] if 32 * t + lane == 0 else val[t, lane] + 1)
                 if 32 * t + lane < m else 0 for lane in range(32)]
        pos = [(int(c) + carry) & M32 for c in np.cumsum(steps)]
        carry = pos[31]
        for lane in range(32):
            e = 32 * t + lane
            if e >= m:
                continue
            ps = pos[lane] - (1 << 32) if pos[lane] >= 1 << 31 else pos[lane]
            pos_all[e] = ps
            high_all[e] = (s_high[e] if e < K - nex else 0) + 1
            if 0 <= ps < 128:
                patch[ps] = (patch[ps] + (high_all[e] << shift)) & M32
    return patch, pos_all, high_all, nread


def model_inpass(words, fields, b, E):
    """The kernel's decode of field rows under ("opt", b, E, 128): its
    slots (K1's, the plain op's with no exceptions) ORed with the warp
    model's sums."""
    f = np.asarray(fields, np.int32)
    slots = port_inpass(words, np.where(np.arange(11) == BF_NEX, 0, f), b, E).view(np.uint32)
    patch = np.stack([_model_row(words, row, E)[0] for row in f]).astype(np.uint32)
    return (slots | patch).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_model_matches_plain_on_edge_rows(seed):
    """The warp model against the plain op on every seeded edge row, of
    s16_rows and of s16_more_rows (each over its own words); the
    hand-built rows of s16_more_rows reach the model's branches: "long"
    rows read more than one round of words and one reads all K, a
    "mid_word" row's last needed value lies inside a word of 14 or 28
    values, "nex_le0" rows read no word, the malformed windows at the
    stream's end read all K."""
    for words, rows in (s16_rows(seed), s16_more_rows(seed)):
        for (b, E), idx in _by_statics(rows).items():
            f = np.stack([rows[i][2] for i in idx])
            np.testing.assert_array_equal(model_inpass(words, f, b, E),
                                          port_inpass(words, f, b, E),
                                          err_msg=f"seed {seed} b={b} E={E}")
    nread = {k: [_model_row(words, f, E)[3] for _, E, f, kk in rows if kk == k]
             for k in ("long", "mid_word", "nex_le0", "malformed")}
    assert min(nread["long"]) > 33 and max(nread["long"]) == 8 * 33
    assert nread["nex_le0"] == [0, 0] and nread["malformed"] == [8 * 33, 8 * 33]
    w = np.asarray(words).view(np.uint32)
    inside = []
    for _, E, f, k in rows:
        if k == "mid_word":
            n, need, i = 0, _need(int(f[BF_NEX]), E)[1], 0
            while n < need:  # the stream's words up to the one holding value need - 1
                x = int(w[f[BF_EX_W0] + i])
                x = (x >> int(f[BF_EX_BOFF]) | int(w[f[BF_EX_W0] + i + 1]) << (
                    32 - int(f[BF_EX_BOFF]))) & M32 if f[BF_EX_BOFF] else x
                n += sum(c for c, _ in S16_MODES[x >> 28])
                i += 1
            inside.append(n > need)  # the word holding value need - 1 holds more
    assert inside and all(inside)


def test_kernel_model_matches_plain_on_every_exception_row(engines):
    """The warp model against the plain op on every row with exceptions of
    the small index's "opt" groups, both streams, row by row; each row
    reads ceil(words / 32) rounds, words the Simple16 words that the
    values it needs take (block_tiles._s16_words, walked from the index
    bytes). About 1 s serially on the build host's CPU (the engines fixture aside)."""
    inpass, _, _, index, _, _ = engines
    words = inpass.state.docs_words.numpy()
    data = np.concatenate([np.asarray(index.lists, np.uint8), np.zeros(8, np.uint8)])
    rows = 0
    for gid, statics, table in ((inpass.tile_gid_d, inpass.group_statics_d,
                                 inpass.state.tiles_docs),
                                (inpass.tile_gid_f, inpass.group_statics_f,
                                 inpass.state.tiles_freqs)):
        f_all = table.numpy()
        for gi, st in enumerate(statics):
            if not (st[0] == "opt" and st[2] > 0):
                continue
            for t in np.flatnonzero(gid == gi):
                f = f_all[t]
                if f[BF_NEX] <= 0:
                    continue
                got = model_inpass(words, f[None], st[1], st[2])
                np.testing.assert_array_equal(got, port_inpass(words, f[None], st[1], st[2]),
                                              err_msg=f"tile {t} statics {st}")
                need = _need(int(f[BF_NEX]), st[2])[1]
                pos = 4 * int(f[BF_EX_W0]) + int(f[BF_EX_BOFF]) // 8
                rounds = -(-_s16_words(data, pos, need) // 32)
                assert _model_row(words, f, st[2])[3] == 33 * rounds
                rows += 1
    assert rows > 100


# -- the engine past its word limit --------------------------------------------


def resident_words(index):
    """The words of a block index's stream before any patch pair."""
    n = len(np.asarray(index.lists))
    return (n + (-n) % 4 + 8) // 4


@contextlib.contextmanager
def lowered_limit(index):
    """RESIDENT_WORD_LIMIT just above the index's own words: its patch
    pairs pass it, so engines built inside decode exceptions in the pass."""
    old = resident.RESIDENT_WORD_LIMIT
    resident.RESIDENT_WORD_LIMIT = resident_words(index) + 1
    try:
        yield
    finally:
        resident.RESIDENT_WORD_LIMIT = old


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


@pytest.fixture(scope="module")
def engines(coll):
    """(in-pass port engine, patched port engine, JAX engine with
    DS2I_EX_PATCH=0, port index, queries, port wand data), small part
    budgets (several parts a plan), norm caches built."""
    assert_same_walk()
    port_index, ref_index = build_index(coll, "block_optpfor", "port"), build_index(
        coll, "block_optpfor", "ref")
    wd = build_wdata(coll, "port")
    with lowered_limit(port_index):
        inpass = ResidentEngine(port_index, wd, device="cpu", **KW)
    patched = ResidentEngine(port_index, wd, device="cpu", **KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS2I_EX_PATCH", "0")
        ref = JaxResidentEngine(ref_index, build_wdata(coll, "ref"), **KW)
    for e in (inpass, patched, ref):
        e._ensure_norm_cache()
    return inpass, patched, ref, port_index, read_queries(coll + ".queries")[:40], wd


@pytest.fixture(scope="module")
def served(coll, engines):
    """(in-pass port engine, patched port engine, JAX engine with
    DS2I_EX_PATCH=0) at the default part budgets, as they serve."""
    _, _, _, port_index, _, wd = engines
    with lowered_limit(port_index):
        inpass = ResidentEngine(port_index, wd, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS2I_EX_PATCH", "0")
        ref = JaxResidentEngine(build_index(coll, "block_optpfor", "ref"), build_wdata(coll, "ref"))
    return inpass, ResidentEngine(port_index, wd, device="cpu"), ref


def test_engine_keeps_opt_statics_past_the_limit(engines):
    """Past the lowered limit the port keeps the walk's "opt" statics with
    E > 0, BF_EX_W0/BF_EX_BOFF and the index's words alone, as the JAX
    engine does with DS2I_EX_PATCH=0; the patched engine's groups are
    "optp" and its stream is longer by the patch pairs."""
    inpass, patched, ref, index, _, _ = engines
    assert inpass.group_statics_d == ref.group_statics_d
    assert inpass.group_statics_f == ref.group_statics_f
    statics = inpass.group_statics_d + inpass.group_statics_f
    assert any(st[0] == "opt" and st[2] > 0 for st in statics)
    assert not any(st[0] == "optp" for st in statics)
    assert any(st[0] == "optp" for st in patched.group_statics_d + patched.group_statics_f)
    s = inpass.state
    np.testing.assert_array_equal(s.tiles_docs.numpy(), np.asarray(ref.tiles_docs))
    np.testing.assert_array_equal(s.tiles_freqs.numpy(), np.asarray(ref.tiles_freqs))
    np.testing.assert_array_equal(s.docs_words.numpy().view(np.uint32), np.asarray(ref.docs_words))
    assert s.docs_words.numel() == resident_words(index) < patched.state.docs_words.numel()


@pytest.mark.parametrize("stream", ["docs", "freqs"])
def test_every_exception_group_matches_jax_and_patches(engines, stream):
    """Every ("opt", b, E > 0) group of the stream: the plain op's raw
    slots against the JAX op bit for bit on all 128 slots of every row,
    the numpy warp model against both, and the whole masked stream
    (block_stream_torch) against the patched engine's "optp" decode of
    the same tiles, bit for bit (and, for the first group, against the
    JAX engine's _decode_block_stream on the valid slots)."""
    inpass, patched, ref, _, _, _ = engines
    is_docs = stream == "docs"
    gid, statics = ((inpass.tile_gid_d, inpass.group_statics_d) if is_docs
                    else (inpass.tile_gid_f, inpass.group_statics_f))
    table, ptable = ((inpass.state.tiles_docs, patched.state.tiles_docs) if is_docs
                     else (inpass.state.tiles_freqs, patched.state.tiles_freqs))
    rtable = ref.tiles_docs if is_docs else ref.tiles_freqs
    words = inpass.state.docs_words.numpy()
    nvals = inpass.tiles.docs[:, F_NVALS]
    found = 0
    for gi, st in enumerate(statics):
        if not (st[0] == "opt" and st[2] > 0):
            continue
        rows = np.flatnonzero(gid == gi)
        ids = torch.from_numpy(rows.astype(np.int64))
        f = table[ids].numpy()
        raw = port_inpass(words, f, st[1], st[2])
        np.testing.assert_array_equal(raw, jax_inpass(words, f, st[1], st[2]))
        np.testing.assert_array_equal(model_inpass(words, f, st[1], st[2]), raw)
        got = block_stream_torch(inpass.state.docs_words, table[ids], st, inpass.num_docs,
                                 is_docs).numpy()
        if found == 0:  # the JAX engine's stream decode of one group (a compile each)
            exp = np.asarray(_decode_block_stream(ref.docs_words, rtable[rows.astype(np.int32)],
                                                  st, len(rows), is_docs, ref.num_docs))
            valid = np.arange(128)[None, :] < nvals[rows][:, None]
            np.testing.assert_array_equal(got[valid], exp[valid])
        optp = block_stream_torch(patched.state.docs_words, ptable[ids], ("optp",) + st[1:],
                                  patched.num_docs, is_docs).numpy()
        np.testing.assert_array_equal(got, optp)
        found += 1
    assert found > 0


@pytest.mark.parametrize("ranked", [True, False])
def test_inpass_plans_and_parts_match_jax(engines, ranked):
    """Several-part plans equal the JAX engine's array for array, and
    every part's split decode (split_decode_part_torch, the CPU wrapper)
    equals its _decode_part bit for bit."""
    inpass, _, ref, _, qs, _ = engines
    ops = ("and",) if ranked else ("counts",)
    assert _plan_arrays(inpass.prepare(qs, k=10, ops=ops, ranked=ranked)) == _plan_arrays(
        ref.prepare(qs, k=10, ops=ops, ranked=ranked))
    check_part_decode_equals_jax(inpass, ref, qs, ranked)


@pytest.mark.parametrize("weights", ["bm25", "presence", None])
def test_inpass_launches_compose_to_the_part(engines, weights):
    """The K1s CTA tables cover every in-pass row once, and the launches
    the card makes (K1s beside K2, and K1 for blocks without exceptions),
    each as decode_launch_torch, give the part's plain decode."""
    inpass, _, _, _, qs, _ = engines
    assert {"optpfor_s16", "interp"} <= check_cta_tables(inpass, qs) <= {
        "optpfor", "optpfor_s16", "interp"}
    check_launches_compose(inpass, qs, weights)


def test_replicated_map_repeats_the_rows(engines):
    """chip_smoke.replicated_map (its replicated line): 3 copies of each
    K1s launch of the in-pass engine's all-tiles part, each over its own
    copy of the words, fields, freq and den rows, through the wrapper on
    the CPU, write the launch's own blocks three times over, freqs and
    BM25 docs (each docs block's freqs from the all-tiles freqs, blkperm
    of its block); no copy reads another's words."""
    inpass = engines[0]
    s, nd = inpass.state, inpass.num_docs
    gt, gf, bp, lay = inpass.all_tiles_part()[:4]
    freq = torch.zeros((lay.nb_f, 32), dtype=torch.int32)
    for kernel in block_decode.KERNELS:
        block_decode.WRAPPERS[kernel](lay.launch(kernel, False, "cpu"), s.docs_words,
                                      s.tiles_freqs, gf, "freqs", nd, freq)
    nw = len(s.docs_words)
    for mode, gtile0, table, nb in (("freqs", gf, s.tiles_freqs, lay.nb_f),
                                    ("bm25", gt, s.tiles_docs, lay.nb_d)):
        base = lay.launch("optpfor_s16", mode != "freqs", "cpu")
        out0, w0 = torch.zeros((nb, 32), dtype=torch.int32), torch.zeros((nb, 32))
        block_decode.optpfor_s16_decode(base, s.docs_words, table, gtile0, mode, nd, out0, w0,
                                        freq, bp, s.den_blocks, s.tile_gblk0)
        bm25 = (freq, bp, s.den_blocks, s.tile_gblk0) if mode == "bm25" else None
        (launch, *args), blocks = chip_smoke.replicated_map(base, gtile0, table, s.docs_words, 3,
                                                           bm25)
        assert launch.n_cta == 3 * base.n_cta and launch.end_blk == len(blocks)
        nrow = int(base.host[:, 4].sum())
        assert len(blocks) == 3 * 4 * nrow
        fld = args[1]
        for c in range(3):  # copy c's windows lie in the c-th copy of the words
            rows = fld[c * nrow:(c + 1) * nrow]
            assert bool(((rows[:, BF_EX_W0] >= c * nw) & (rows[:, BF_EX_W0] < (c + 1) * nw)).all())
        out, w = torch.zeros((launch.end_blk, 32), dtype=torch.int32), torch.zeros(
            (launch.end_blk, 32))
        block_decode.optpfor_s16_decode(launch, args[2], fld, args[0], mode, nd, out, w, *args[3:])
        idx = torch.from_numpy(blocks)
        assert torch.equal(out, out0[idx])
        if mode == "bm25":
            assert torch.equal(w, w0[idx]) and bool((w > 0).any())


@pytest.mark.parametrize("prune", [False, True])
def test_inpass_results_match_jax(served, engines, prune):
    """and/or counts exact; top-10 ranked_and (exhaustive or prune=True)
    and ranked_or within rtol 1e-3 of the JAX engine's and equal to the
    patched engine's."""
    inpass, patched, ref = served
    qs = engines[4]
    got = inpass.ranked_and(qs, k=10, prune=prune)
    _assert_topk_close(got, ref.ranked_and(qs, k=10, prune=prune), qs)
    assert got == patched.ranked_and(qs, k=10, prune=prune)
    if not prune:
        np.testing.assert_array_equal(inpass.and_counts(qs), ref.and_counts(qs))
        np.testing.assert_array_equal(inpass.or_counts(qs), ref.or_counts(qs))
        _assert_topk_close(inpass.ranked_or(qs, k=10), ref.ranked_or(qs, k=10), qs)


def test_inpass_cache_cold_and_warm(engines, tmp_path):
    """cache_dir under the lowered limit: the cold engine saves the patch
    words it does not use, the warm one loads them, and both keep the
    "opt" statics, the tables and words, and serve what the uncached
    in-pass engine serves."""
    inpass, _, _, index, qs, wd = engines
    exp = inpass.ranked_and(qs, k=10)
    with lowered_limit(index):
        cold = ResidentEngine(index, wd, device="cpu", cache_dir=str(tmp_path), **KW)
        assert any(f.endswith("_expatch.npz") for f in os.listdir(tmp_path))
        warm = ResidentEngine(index, wd, device="cpu", cache_dir=str(tmp_path), **KW)
    for eng in (cold, warm):
        assert eng.group_statics_d == inpass.group_statics_d
        assert eng.group_statics_f == inpass.group_statics_f
        assert torch.equal(eng.state.tiles_docs, inpass.state.tiles_docs)
        assert torch.equal(eng.state.docs_words, inpass.state.docs_words)
        assert eng.ranked_and(qs, k=10) == exp


def test_make_engine_serves_past_the_limit(engines):
    """make_engine counts only the index's bytes: under the lowered word
    limit it gives a ResidentEngine that decodes in the pass and serves
    the same results."""
    inpass, _, _, index, qs, wd = engines
    with lowered_limit(index):
        eng = make_engine(index, wd, device="cpu")
    assert isinstance(eng, ResidentEngine)
    assert eng.group_statics_d == inpass.group_statics_d
    assert eng.ranked_and(qs, k=10) == inpass.ranked_and(qs, k=10)
    np.testing.assert_array_equal(eng.and_counts(qs), inpass.and_counts(qs))
    with pytest.raises(ValueError, match="8GB"):  # the index alone still has a limit
        old = resident.RESIDENT_WORD_LIMIT
        resident.RESIDENT_WORD_LIMIT = resident_words(index)
        try:
            ResidentEngine(index, wd, device="cpu")
        finally:
            resident.RESIDENT_WORD_LIMIT = old
