"""The part-level pair decode (ds2i_torch.ops.pair_decode) on the CPU,
for the four EF-family index types: pair_decode_part_torch against the
JAX engine's _decode_part (pair branch, norm-cache den rows) on every
part of a several-part plan and on the all-tiles part (each layout
compiled once: BM25 from _decode_part, presence from its docids), its
docs-only form against _norm_cache_step, one `opt` part against the
Pallas kernel in interpret mode, the CTA table of the one launch a part,
and the plain contract of that launch (decode_pair_launch_torch, which
the CUDA kernel is held to on the card) against the whole part's plain
decode.

docs32 compare exactly. w32 compare bit for bit (as uint32): both sides
compute one IEEE f32 add and one IEEE f32 divide of the same f32
operands, unmasked, so a pad slot's weight is 0 / (0 + den) = +0.0 on
both; the bit comparison pins that sign, which `==` would not."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine
from ds2i_tpu.engine import resident as jax_resident
from ds2i_tpu.io import generate_collection
from ds2i_tpu.queries import read_queries

from ds2i_torch.engine import ResidentEngine
from ds2i_torch.engine import resident as port_resident
from ds2i_torch.engine.tiles import F_NVALS
from ds2i_torch.ops import pair_decode
from ds2i_torch.ops.block_decode import PAIR_ROWS, PartLayout
from ds2i_torch.ops.pair_decode import (
    decode_pair, pair_decode_part, pair_decode_part_torch,
)

from test_torch_host_copy import build_index, build_wdata

EF_TYPES = ["ef", "single", "uniform", "opt"]
KW = dict(max_part_slots=1 << 13, max_part_queries=16)
NQ = 17  # two parts: 16 queries and 1


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release the JAX executables each test compiled before the next
    one (the fixture of tests/test_wand_device.py): this module's JAX
    engines compile large XLA-CPU programs, and a full suite's
    live-executable population is what crashes XLA-CPU's compiler in a
    worker."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


@pytest.fixture(scope="module")
def engines(coll):
    """name -> (port engine, JAX engine, queries), each engine over an
    index of its own package, both with the norm cache built."""
    qs = read_queries(coll + ".queries")[:NQ]
    out = {}
    for name in EF_TYPES:
        port = ResidentEngine(build_index(coll, name, "port"), build_wdata(coll, "port"),
                              device="cpu", **KW)
        ref = JaxResidentEngine(build_index(coll, name, "ref"), build_wdata(coll, "ref"), **KW)
        port._ensure_norm_cache()
        ref._ensure_norm_cache()
        out[name] = (port, ref, qs)
    return out


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()


def _parts(port, ref, qs, ranked):
    """[(port gtile_ids, PartLayout, JAX plan part)] of every part of the
    plan, then the all-tiles part (JAX side: its _order_groups over every
    tile, with the plan's placeholder freqs layout)."""
    ops = ("and",) if ranked else ("counts",)
    plan = port.prepare(qs, k=10, ops=ops, ranked=ranked)
    jplan = ref.prepare(qs, k=10, ops=ops, ranked=ranked)
    assert len(plan["plans"]) > 1
    out = []
    for p, jp in zip(plan["plans"], jplan["plans"]):
        assert p["groups"] == jp["groups"] and p["groups_f"] == jp["groups_f"] == ()
        out.append((_i64(p["gtile_ids"]), p["layout"], jp))
    part = port.all_tiles_part()
    groups, gids, _, _, _ = ref._order_groups(np.arange(ref.pad_tile), ref.tile_gid,
                                              ref.group_statics)
    assert tuple(groups) == part.layout.groups
    np.testing.assert_array_equal(part.gtile_ids.numpy(), gids)
    jp = dict(gtile_ids=gids, gtile_f=np.zeros(1, np.int32), blkperm=np.zeros(1, np.int32),
              groups=tuple(groups))
    out.append((part.gtile_ids, part.layout, jp))
    return out


def _jax_part(ref, jp, ranked, pallas=0):
    return jax_resident._decode_part(
        ref.docs_words, ref.freqs_words, ref.tiles_docs, ref.tiles_freqs, ref.norm_den,
        jnp.asarray(jp["gtile_ids"]), jnp.asarray(jp["gtile_f"]), jnp.asarray(jp["blkperm"]),
        tuple(jp["groups"]), (), ref.num_docs, ranked=ranked, pallas=pallas, normcache=1,
        den_blocks=ref.den_blocks, tile_gblk0=ref.tile_gblk0)


def _part_args(port, gt, lay):
    s = port.state
    return (s.docs_words, s.freqs_words, s.tiles_docs, s.tiles_freqs, gt, lay, port.num_docs)


def _bits(w):
    return np.asarray(w, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("ranked", [True, False])
@pytest.mark.parametrize("name", EF_TYPES)
def test_part_decode_equals_jax_decode_part(engines, name, ranked):
    """Every part of a several-part plan and the all-tiles part: docs32
    exact and w32 bit for bit, the power-of-two pad rows and each tile's
    pad slots included (BM25: +0.0 from the unmasked 0 / (0 + den)). The
    JAX side is _decode_part itself, ranked on every part, and presence
    (ranked=False) on `opt`'s all-tiles part; elsewhere presence is the
    JAX branch's own expression, 1.0 where doc < num_docs (0 on the pad
    rows), over _decode_part's docids, so that each layout compiles
    once."""
    port, ref, qs = engines[name]
    s = port.state
    weights = "bm25" if ranked else "presence"
    parts = _parts(port, ref, qs, ranked)
    for i, (gt, lay, jp) in enumerate(parts):
        rows = _pow2(lay.nb_d)
        docs32, w32 = pair_decode_part_torch(*_part_args(port, gt, lay), weights, s.den_blocks,
                                             s.tile_gblk0, out_rows=rows)
        if ranked or (name == "opt" and i == len(parts) - 1):
            exp_d, exp_w = _jax_part(ref, jp, ranked)
        else:
            exp_d, _ = _jax_part(ref, jp, True)
            exp_w = jnp.where(exp_d < ref.num_docs, 1.0, 0.0)
        assert docs32.shape == (rows, 32) and docs32.dtype == torch.int32
        assert w32.dtype == torch.float32
        np.testing.assert_array_equal(docs32.numpy(), np.asarray(exp_d))
        np.testing.assert_array_equal(_bits(w32), _bits(exp_w))
        pad = docs32.numpy() == port.num_docs
        assert pad.any() and not (_bits(w32)[pad]).any(), "pad slots must weigh +0.0"
        # the engine's CPU wrapper and the engine's decode stage are the plain version
        got = pair_decode_part(*_part_args(port, gt, lay), weights, s.den_blocks, s.tile_gblk0,
                               out_rows=rows)
        stage = port_resident._decode_part(s, gt, None, None, lay, port.num_docs, ranked)
        for d, w in (got, stage):
            torch.testing.assert_close(d, docs32, rtol=0, atol=0)
            np.testing.assert_array_equal(_bits(w), _bits(w32))


@pytest.mark.parametrize("name", EF_TYPES)
def test_docs_form_equals_jax_norm_cache_step(engines, name):
    """The docs-only form (weights None, one docs-mode launch on the card)
    gives the JAX engine's docids over every tile, and the port's
    _norm_cache_step the JAX _norm_cache_step's denominators."""
    port, ref, _ = engines[name]
    s = port.state
    part = port.all_tiles_part()
    docs32, w32 = pair_decode_part_torch(*_part_args(port, part.gtile_ids, part.layout), None)
    assert w32 is None
    exp_d, _ = _jax_part(ref, dict(gtile_ids=part.gtile_ids.numpy(), gtile_f=np.zeros(1, np.int32),
                                   blkperm=np.zeros(1, np.int32), groups=part.layout.groups),
                         ranked=True)
    np.testing.assert_array_equal(docs32.numpy(), np.asarray(exp_d)[:len(docs32)])
    den = port_resident._norm_cache_step(s.docs_words, s.tiles_docs, s.norm_den, part.gtile_ids,
                                         part.layout, port.num_docs)
    exp = jax_resident._norm_cache_step(ref.docs_words, ref.tiles_docs, ref.norm_den,
                                        jnp.asarray(part.gtile_ids.numpy()),
                                        groups=part.layout.groups, num_docs=ref.num_docs,
                                        split=False)
    np.testing.assert_array_equal(_bits(den), _bits(exp))
    np.testing.assert_array_equal(_bits(s.den_blocks), _bits(ref.den_blocks))


def test_opt_part_equals_pallas_interpret(engines):
    """One `opt` part (the plan's smallest) against the JAX engine's
    _decode_part through the Pallas kernel in interpret mode (pallas=2),
    ranked: docs32 exact, w32 bit for bit."""
    port, ref, qs = engines["opt"]
    s = port.state
    gt, lay, jp = min(_parts(port, ref, qs, True)[:-1], key=lambda x: x[1].nb_d)
    docs32, w32 = pair_decode_part_torch(*_part_args(port, gt, lay), "bm25", s.den_blocks,
                                         s.tile_gblk0, out_rows=_pow2(lay.nb_d))
    exp_d, exp_w = _jax_part(ref, jp, True, pallas=2)
    np.testing.assert_array_equal(docs32.numpy(), np.asarray(exp_d))
    np.testing.assert_array_equal(_bits(w32), _bits(exp_w))


def _covered(lay):
    """Assert the pair table lists every row of every group once, no CTA
    across two groups, each CTA's statics and output blocks those of its
    group, the longest rows first; returns the table."""
    tab = lay.tables["pair", True]
    row_group = {}
    for gi, (off, R, st) in enumerate(lay.groups):
        for r in range(off, off + R):
            row_group[r] = gi
    seen = set()
    for W, WL, T, row0, n, blk0 in tab.tolist():
        assert 0 < n <= PAIR_ROWS
        gis = {row_group[r] for r in range(row0, row0 + n)}
        assert len(gis) == 1, "a CTA straddles two groups"
        gi = gis.pop()
        off, R, st = lay.groups[gi]
        assert st == ("ef", W, WL, T)
        gblk = sum(Rg * sg[-1] // 32 for _, Rg, sg in lay.groups[:gi])
        assert blk0 == gblk + (row0 - off) * (T // 32)
        assert not seen & set(range(row0, row0 + n)), "a row in two CTAs"
        seen |= set(range(row0, row0 + n))
    assert seen == set(row_group)
    key = [(T, W + WL) for W, WL, T in tab[:, :3].tolist()]
    assert key == sorted(key, reverse=True), "the longest rows come first"
    return tab


@pytest.mark.parametrize("name", EF_TYPES)
def test_cta_table_covers_every_row_once(engines, name):
    """Every part of a several-part plan and the all-tiles part; the
    launch's sizes follow its table; the split kernels' tables are
    empty."""
    port, ref, qs = engines[name]
    for _, lay, _ in _parts(port, ref, qs, True):
        assert lay.pair and lay.groups_f == () and lay.nb_f == 0
        tab = _covered(lay)
        assert lay.nb_d == sum(R * st[-1] // 32 for _, R, st in lay.groups)
        launch = lay.launch("pair", True, "cpu")
        assert launch.n_cta == len(tab) and launch.end_blk == lay.nb_d
        assert launch.max_w == max(W + WL + 1 + T for W, WL, T in tab[:, :3].tolist())
        assert launch.max_t == tab[:, 2].max()
        assert all(len(lay.tables[k, d]) == 0 for k, d in lay.tables if k != "pair")
    with pytest.raises(ValueError, match="either EF pair groups alone"):
        PartLayout(((0, 8, ("ef", 4, 4, 32)), (8, 8, ("interp", 4, 32))))


@pytest.mark.parametrize("weights", ["bm25", "presence", None])
@pytest.mark.parametrize("name", EF_TYPES)
def test_launches_compose_to_the_part(engines, name, weights):
    """The one launch the CUDA path makes a part, as decode_pair_launch_torch
    (the kernel's contract, reached through the CPU wrapper), writes
    exactly pair_decode_part_torch's blocks; the CPU wrapper counts
    nothing."""
    port, ref, qs = engines[name]
    s = port.state
    before = pair_decode.decode_pair.launches
    for gt, lay, _ in _parts(port, ref, qs, True):
        exp_d, exp_w = pair_decode_part_torch(*_part_args(port, gt, lay), weights, s.den_blocks,
                                              s.tile_gblk0)
        docs32 = torch.full((lay.nb_d, 32), -7, dtype=torch.int32)
        w32 = torch.full((lay.nb_d, 32), -7.0) if weights else None
        decode_pair(lay.launch("pair", True, "cpu"), s.docs_words, s.freqs_words, s.tiles_docs,
                    s.tiles_freqs, gt, weights or "docs", port.num_docs, docs32, w32,
                    s.den_blocks, s.tile_gblk0)
        torch.testing.assert_close(docs32, exp_d, rtol=0, atol=0)
        if weights:
            np.testing.assert_array_equal(_bits(w32), _bits(exp_w))
    assert pair_decode.decode_pair.launches == before


@pytest.mark.parametrize("name", EF_TYPES)
def test_all_tiles_part(engines, name):
    """ResidentEngine.all_tiles_part in pair mode: every tile once, the
    freqs layout the plan's placeholders (both streams share the docs
    rows: tblk_f is tblk), and each tile's docids at its first block of
    the part's decode, as the host decodes its list."""
    port, _, _ = engines[name]
    s, nt = port.state, port.pad_tile
    part = port.all_tiles_part()
    ids = part.gtile_ids.numpy()
    assert part.gtile_ids.dtype == torch.int64 and sorted(ids[ids < nt]) == list(range(nt))
    assert part.gtile_f.tolist() == [0] and part.blkperm.tolist() == [0]
    assert part.tblk_f is part.tblk
    docs32, _ = pair_decode_part_torch(*_part_args(port, part.gtile_ids, part.layout), None)
    nvals = port.tiles.docs[:, F_NVALS]
    d = docs32.numpy().reshape(-1)
    for li in range(port.index.size()):
        tiles = range(int(port.list_tile_start[li]), int(port.list_tile_start[li + 1]))
        hd, _ = port.index.decode_list(li)
        np.testing.assert_array_equal(
            np.concatenate([d[32 * part.tblk[t]:][:nvals[t]] for t in tiles]), hd)
