"""The part-level split decode (ds2i_torch.ops.block_decode) on the CPU:
split_decode_part_torch against the JAX engine's _decode_part on every
part of a plan, the CTA tables of the kernel launches, and the plain
contract of each launch (decode_launch_torch, which the CUDA kernels are
held to on the card) against the whole part's plain decode.

docs32 compare exactly. w32 compare exactly too: both sides compute one
IEEE f32 add and one IEEE f32 divide of the same f32 operands (freqs are
exact in f32, den comes from equal norm caches), and XLA on the CPU
rounds them as PyTorch does."""

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
from ds2i_torch.engine.tiles import F_NVALS
from ds2i_torch.ops import block_decode
from ds2i_torch.ops.block_decode import (
    KERNELS, ROWS_PER_CTA, PartLayout, split_decode_part, split_decode_part_torch,
)

from test_torch_host_copy import assert_same_walk, build_index, build_wdata

BLOCK_TYPES = ["block_optpfor", "block_interpolative"]
KW = dict(max_part_slots=1 << 13, max_part_queries=16)


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


def build_engines(coll, names):
    """name -> (port engine, JAX engine, queries), each engine over an
    index of its own package, both with the norm cache built."""
    assert_same_walk()
    qs = read_queries(coll + ".queries")[:40]
    out = {}
    for name in names:
        port = ResidentEngine(build_index(coll, name, "port"), build_wdata(coll, "port"),
                              device="cpu", **KW)
        ref = JaxResidentEngine(build_index(coll, name, "ref"), build_wdata(coll, "ref"), **KW)
        port._ensure_norm_cache()
        ref._ensure_norm_cache()
        out[name] = (port, ref, qs)
    return out


@pytest.fixture(scope="module")
def engines(coll):
    return build_engines(coll, BLOCK_TYPES)


def _part_args(eng, p):
    s = eng.state
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))  # noqa: E731
    return (s.docs_words, s.tiles_docs, s.tiles_freqs, t(p["gtile_ids"]), t(p["gtile_f"]),
            t(p["blkperm"]), p["layout"])


def check_part_decode_equals_jax(port, ref, qs, ranked):
    """split_decode_part_torch (and the CPU wrapper) against the JAX
    engine's _decode_part on every part of a several-part plan."""
    ops = ("and",) if ranked else ("counts",)
    plan = port.prepare(qs, k=10, ops=ops, ranked=ranked)
    jplan = ref.prepare(qs, k=10, ops=ops, ranked=ranked)
    assert len(plan["plans"]) > 1
    s = port.state
    for p, jp in zip(plan["plans"], jplan["plans"]):
        assert p["groups"] == jp["groups"] and p["groups_f"] == jp["groups_f"]
        rows = 1
        while rows < p["layout"].nb_d:
            rows *= 2
        docs32, w32 = split_decode_part_torch(
            *_part_args(port, p), port.num_docs, "bm25" if ranked else "presence",
            s.den_blocks, s.tile_gblk0, out_rows=rows)
        exp_d, exp_w = jax_resident._decode_part(
            ref.docs_words, ref.freqs_words, ref.tiles_docs, ref.tiles_freqs, ref.norm_den,
            jnp.asarray(jp["gtile_ids"]), jnp.asarray(jp["gtile_f"]), jnp.asarray(jp["blkperm"]),
            jp["groups"], jp["groups_f"], ref.num_docs, ranked=ranked, normcache=1,
            den_blocks=ref.den_blocks, tile_gblk0=ref.tile_gblk0)
        assert docs32.dtype == torch.int32 and w32.dtype == torch.float32
        np.testing.assert_array_equal(docs32.numpy(), np.asarray(exp_d))
        np.testing.assert_array_equal(w32.numpy(), np.asarray(exp_w))
        # the engine's CPU wrapper is the plain version
        got = split_decode_part(*_part_args(port, p), port.num_docs,
                                "bm25" if ranked else "presence", s.den_blocks, s.tile_gblk0,
                                out_rows=rows)
        torch.testing.assert_close(got[0], docs32, rtol=0, atol=0)
        torch.testing.assert_close(got[1], w32, rtol=0, atol=0)


@pytest.mark.parametrize("ranked", [True, False])
@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_part_decode_equals_jax_decode_part(engines, name, ranked):
    check_part_decode_equals_jax(*engines[name], ranked)


def _covered(layout, kernel, is_docs):
    """(row -> group index, block -> group index) the kernel's table
    covers, asserting each row once and no CTA across two groups."""
    groups = layout.groups if is_docs else layout.groups_f
    tab = layout.tables[kernel, is_docs]
    row_group, blk0s = {}, []
    for gi, (off, R, st) in enumerate(groups):
        for r in range(off, off + R):
            row_group[r] = gi
    seen = {}
    rows_per = ROWS_PER_CTA[kernel]
    for p1, p2, T, row0, n, blk0 in tab.tolist():
        assert 0 < n <= rows_per
        gis = {row_group[r] for r in range(row0, row0 + n)}
        assert len(gis) == 1, "a CTA straddles two groups"
        gi = gis.pop()
        off, R, st = groups[gi]
        assert block_decode._kernel_of(st) == kernel and st[-1] == T
        assert (p1, p2) == ((st[1], st[2]) if st[0] in ("opt", "optp", "qmx") else (st[1], 0))
        bpt = max(T // 32, 1)
        gblk = sum(Rg * max(sg[-1] // 32, 1) for _, Rg, sg in groups[:gi])
        assert blk0 == gblk + (row0 - off) * bpt
        for r in range(row0, row0 + n):
            assert r not in seen, f"row {r} in two CTAs"
            seen[r] = gi
        blk0s.append(blk0)
    mine = {r for r, gi in row_group.items() if block_decode._kernel_of(groups[gi][2]) == kernel}
    assert set(seen) == mine
    return tab


def check_cta_tables(port, qs):
    """Every row of every group of a kernel once, no CTA across two
    groups, blocks at the group's layout, K2's 128-value CTAs first
    (T descending); every part of a several-part plan, both streams.
    Returns the kernels with CTAs."""
    plan = port.prepare(qs, k=10, ops=("and",))
    kinds = set()
    for p in plan["plans"]:
        lay = p["layout"]
        assert lay.groups == p["groups"] and lay.groups_f == p["groups_f"]
        for is_docs in (True, False):
            for kernel in KERNELS:
                tab = _covered(lay, kernel, is_docs)
                if len(tab):
                    kinds.add(kernel)
                if kernel == "interp" and len(tab):
                    assert np.all(np.diff(tab[:, 2]) <= 0)
                    if 128 in tab[:, 2]:
                        assert tab[0, 2] == 128
        nb_f = sum(R * max(st[-1] // 32, 1) for _, R, st in p["groups_f"])
        assert lay.nb_d == len(p["blkperm"]) and lay.nb_f == nb_f
    return kinds


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_cta_tables_cover_every_row_once(engines, name):
    kinds = check_cta_tables(engines[name][0], engines[name][2])
    assert kinds == ({"optpfor", "interp"} if name == "block_optpfor" else {"interp"})


def check_launches_compose(port, qs, weights):
    """The launches the CUDA path makes, each as decode_launch_torch (the
    kernels' contract), in its order (freqs, then docs), give exactly
    split_decode_part_torch; the CPU wrappers count nothing."""
    s = port.state
    plan = port.prepare(qs, k=10, ops=("and",))
    before = [w.launches for w in block_decode.WRAPPERS.values()]
    for p in plan["plans"]:
        words, td, tf, gt, gf, bp, lay = _part_args(port, p)
        exp_d, exp_w = split_decode_part_torch(
            words, td, tf, gt, gf, bp, lay, port.num_docs, weights, s.den_blocks, s.tile_gblk0)
        docs32 = torch.full((lay.nb_d, 32), -7, dtype=torch.int32)
        w32 = torch.full((lay.nb_d, 32), -7.0) if weights else None
        freq = torch.full((lay.nb_f, 32), -7, dtype=torch.int32)
        if weights == "bm25":
            for kernel in KERNELS:
                block_decode.WRAPPERS[kernel](lay.launch(kernel, False, "cpu"), words, tf, gf,
                                              "freqs", port.num_docs, freq)
            assert not (freq == -7).any()
        for kernel in KERNELS:
            block_decode.WRAPPERS[kernel](
                lay.launch(kernel, True, "cpu"), words, td, gt, weights or "docs",
                port.num_docs, docs32, w32, freq, bp, s.den_blocks, s.tile_gblk0)
        torch.testing.assert_close(docs32, exp_d, rtol=0, atol=0)
        if weights:
            torch.testing.assert_close(w32, exp_w, rtol=0, atol=0)
    assert [w.launches for w in block_decode.WRAPPERS.values()] == before


@pytest.mark.parametrize("weights", ["bm25", "presence", None])
@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_launches_compose_to_the_part(engines, name, weights):
    check_launches_compose(engines[name][0], engines[name][2], weights)


def check_all_tiles_part(port):
    """ResidentEngine.all_tiles_part: every tile once in each stream's rows,
    and each tile's values at its first docs-order and freqs-order block
    of the part's decode, as the host decodes its list."""
    s, nt = port.state, port.pad_tile
    part = port.all_tiles_part()
    for gtile in (part.gtile_ids, part.gtile_f):
        ids = gtile.numpy()
        assert gtile.dtype == torch.int64 and sorted(ids[ids < nt]) == list(range(nt))
    docs32, _ = split_decode_part_torch(
        s.docs_words, s.tiles_docs, s.tiles_freqs, part.gtile_ids, part.gtile_f, part.blkperm,
        part.layout, port.num_docs, None)
    freq = torch.empty((part.layout.nb_f, 32), dtype=torch.int32)
    for kernel in KERNELS:
        block_decode.WRAPPERS[kernel](part.layout.launch(kernel, False, "cpu"), s.docs_words,
                                      s.tiles_freqs, part.gtile_f, "freqs", port.num_docs, freq)
    nvals = port.tiles.docs[:, F_NVALS]
    d, f = docs32.numpy().reshape(-1), freq.numpy().reshape(-1)
    for li in range(port.index.size()):
        tiles = range(int(port.list_tile_start[li]), int(port.list_tile_start[li + 1]))
        hd, hf = port.index.decode_list(li)
        np.testing.assert_array_equal(
            np.concatenate([d[32 * part.tblk[t]:][:nvals[t]] for t in tiles]), hd)
        np.testing.assert_array_equal(
            np.concatenate([f[32 * part.tblk_f[t]:][:nvals[t]] for t in tiles]), hf)


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_all_tiles_part(engines, name):
    check_all_tiles_part(engines[name][0])


def test_kernel_of_rejects_what_the_kernels_do_not_take():
    # exceptions decoded in the pass go to K1s, patches or none to K1
    assert block_decode._kernel_of(("opt", 5, 4, 128)) == "optpfor_s16"
    assert block_decode._kernel_of(("opt", 5, 0, 128)) == "optpfor"
    assert block_decode._kernel_of(("optp", 5, 4, 128)) == "optpfor"
    for st in (("optp", 5, 3, 128), ("opt", 5, 3, 128), ("opt", 33, 4, 128), ("opt", 5, 4, 64)):
        with pytest.raises(ValueError, match="optpfor_decode takes"):
            block_decode._kernel_of(st)
    with pytest.raises(ValueError, match="interp_decode takes"):
        block_decode._kernel_of(("interp", 5, 32))
    for st in (("var", 32, 128), ("var", 24, 64), ("var", 24, 4, 128)):
        with pytest.raises(ValueError, match="varint_decode takes"):
            block_decode._kernel_of(st)
    for st in (("qmx", 12, 8, 128), ("qmx", 8, 64, 128), ("qmx", 8, 8, 32), ("qmx", 8, 128)):
        with pytest.raises(ValueError, match="qmx_decode takes"):
            block_decode._kernel_of(st)
    with pytest.raises(ValueError, match="unknown group statics"):
        block_decode._kernel_of(("s16", 4, 128))
    assert block_decode._kernel_of(("var", 64, 128)) == "varint"
    assert block_decode._kernel_of(("qmx", 32, 8, 128)) == "qmx"
    empty = PartLayout(((0, 8, ("interp", 4, 32)),))
    assert empty.nb_d == 8 and len(empty.tables["interp", True]) == 1
    assert len(empty.tables["optpfor", True]) == 0 and empty.nb_f == 0
