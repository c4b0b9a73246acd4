"""The join and pack (K3, ds2i_torch/ops/join.py) on the CPU.

- join_bucket_torch against the JAX engine's _join_bucket on seeded
  buckets (ops, tmax, k; rows with fewer than k candidates, rows with no
  entry, all-sentinel pad rows, equal scores), bit for bit;
- join_part_torch against the JAX _join_bucket + _pack_rows over every
  part of real plans (exhaustive and and_skip over `opt` and
  block_optpfor), f16 and f32 downloads, bit for bit;
- a numpy emulation of csrc/join.cu's loop (the CSR of real entries, the
  two searches of every other slot, the run's owner in its highest slot,
  the descending-slot sum, the chunked top-k and its merge) bit-equal to
  join_part_torch on those parts and buckets, at the kernel's chunk and
  at smaller ones;
- the row structure the kernel's search relies on, over every plan of
  every index type (exhaustive, and_skip, wand, maxscore; the probe
  sub-plans included): slots ascend along a row (so each slot's entries
  are contiguous); within a slot the blocks' real docids strictly
  increase, each block's slot 0 is real and its pads (num_docs) come
  last. Pads inside a slot's run (before a later block) occur where a
  tile ends inside a list, in pair mode: the test pins that `opt` has
  them and the block indexes have none.

Scores are compared bit for bit everywhere: the same f32 products and
adds in the same order, and XLA's CPU rounds them as IEEE does. About 50 s
serially on one CPU core.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu.engine.resident import _join_bucket as jax_join_bucket
from ds2i_tpu.engine.resident import _pack_rows as jax_pack_rows

from ds2i_torch.engine import ResidentEngine, resident
from ds2i_torch.host import BinaryFreqCollection, generate_collection, read_queries
from ds2i_torch.ops import join
from ds2i_torch.ops.join import (
    CHUNK, JoinLayout, join_bucket_torch, join_part, join_part_torch,
)

from test_torch_host_copy import SERVED_TYPES, build_index, build_wdata

F32 = np.float32
NEG_INF = F32(-np.inf)


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release each test's JAX executables before the next compiles its
    own (tests/test_torch_resident.py)."""
    yield
    jax.clear_caches()
    gc.collect()


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def assert_bit_equal(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.dtype == exp.dtype and got.shape == exp.shape, (got.dtype, got.shape, exp.shape)
    assert np.array_equal(_bits(got), _bits(exp)), np.argwhere(_bits(got) != _bits(exp))[:5]


# -- the kernel's loop, in numpy ---------------------------------------------


def _find(docs, first, ent, doc, a, b):
    """csrc/join.cu RowEntries::find for 32 lanes: the slot index of each
    lane's doc among the row's entries [a, b), or -1."""
    lo = np.full(32, a, np.int64)
    n = np.full(32, b - a, np.int64)
    while np.any(n > 0):
        half = n >> 1
        live = n > 0
        f = first[np.minimum(lo + half, len(first) - 1)]
        go = live & (f <= doc)
        lo = np.where(go, lo + half + 1, lo)
        n = np.where(live, np.where(go, n - half - 1, half), 0)
    base = (ent[np.maximum(lo - 1, 0)] >> 5).astype(np.int64) * 32
    j = np.zeros(32, np.int64)
    for st in (16, 8, 4, 2, 1):
        j = np.where(docs[base + j + st - 1] < doc, j + st, j)
    return np.where((lo > a) & (docs[base + j] == doc), base + j, -1)


def _desc(x):
    return -np.sort(-x)


def emulate_join_kernel(docs32, w32, lay, num_docs, fetch16, fscale):
    """csrc/join.cu's two launches over a JoinLayout, step for step in
    numpy f32: the packed output rows."""
    docs = np.ascontiguousarray(docs32).reshape(-1).astype(np.int64)
    w = np.ascontiguousarray(w32).reshape(-1)
    k, tmax, nr = lay.k, lay.tmax, lay.n_ranked
    ranked = [i for i, op in enumerate(("or", "and")) if op in lay.ops]
    out = np.zeros((lay.n_rows, lay.width), F32)
    sc_vals = np.zeros((max(lay.n_scratch, 1), max(nr, 1), k), F32)
    sc_cnt = np.zeros((max(lay.n_scratch, 1), 2), np.int64)
    c0 = 2 if "counts" in lay.ops else 0
    for row, e0, ne, sc in lay.items.tolist():
        ent0, nent, tgt = lay.rows[row].tolist()
        ent = lay.ent[ent0:ent0 + nent].astype(np.int64)
        first = docs[(ent >> 5) * 32]
        # the first entry of each slot >= s (slots ascend along the row)
        sb = np.searchsorted(ent & 31, np.arange(tmax + 1), side="left")
        qw = lay.qw[row]
        cand = np.full((2, CHUNK * 32), NEG_INF, F32)
        n_or = n_and = 0
        for e in range(ne):
            d = int(ent[e0 + e])
            slot, base = d & 31, (d >> 5) * 32
            doc = docs[base:base + 32]
            real = doc < num_docs
            total = w[base:base + 32] * qw[slot]
            cnt = np.ones(32, np.int64)
            owner = real.copy()
            for s in range(tmax - 1, -1, -1):
                a, b = int(sb[s]), int(sb[s + 1])
                if s == slot or a == b:
                    continue
                p = _find(docs, first, ent, doc, a, b)
                hit = owner & (p >= 0)
                if s > slot:
                    owner &= ~hit
                else:
                    total = np.where(hit, total + w[np.maximum(p, 0)] * qw[s], total)
                    cnt += hit
            in_and = owner & (cnt == tgt) & (tgt > 0)
            n_or += int(owner.sum())
            n_and += int(in_and.sum())
            cand[0, e * 32:e * 32 + 32] = np.where(owner, total, NEG_INF)
            cand[1, e * 32:e * 32 + 32] = np.where(in_and, total, NEG_INF)
        n = 32
        while n < ne * 32:
            n *= 2
        tops = [np.concatenate([_desc(cand[i, :n])[:k], np.full(max(k - n, 0), NEG_INF, F32)])
                for i in ranked]
        if sc < 0:
            vals = ([F32(n_and), F32(n_or)] if c0 else []) + [v for t in tops for v in t]
            out[row] = np.asarray(vals, F32)
        else:
            sc_cnt[sc] = (n_and, n_or)
            for r, t in enumerate(tops):
                sc_vals[sc, r] = t
    sb_size = 1024
    while sb_size < 2 * k:
        sb_size *= 2
    for row, s0, ni in lay.merges.tolist():
        vals = list(sc_cnt[s0:s0 + ni].sum(axis=0).astype(F32)) if c0 else []
        for r in range(nr):
            flat = sc_vals[s0:s0 + ni, r].reshape(-1)
            buf, pos = flat[:k], k
            while pos < len(flat):
                take = min(len(flat) - pos, sb_size - k)
                n = 32
                while n < k + take:
                    n *= 2
                buf = _desc(np.concatenate([buf, flat[pos:pos + take],
                                            np.full(n - k - take, NEG_INF, F32)]))[:k]
                pos += take
            vals += list(buf)
        out[row] = np.asarray(vals, F32)
    return (out * F32(fscale)).astype(np.float16) if fetch16 else out


# -- seeded buckets ------------------------------------------------------------


def seeded_bucket(rng, tmax, k, num_docs=240, rows=6):
    """One bucket of `rows` real rows plus two all-sentinel pad rows
    (tgt 0): (docs32, w32, bdir, qwtab, tgt, row entries). Each real
    row's terms draw sorted docids from [0, 160) (runs overlap), laid in
    32-slot blocks with pads at the end; the last real row's terms are
    all missing (tgt > 0, no entry), the one before has one term of 3
    postings (fewer than k candidates); row 0's weights and query weights are all 0.5, so its
    scores tie."""
    docs_b, w_b, row_ents = [], [], []
    qwtab = np.zeros((rows + 2, tmax), F32)
    tgt = np.zeros(rows + 2, np.int32)
    for r in range(rows):
        nt = 1 if r == rows - 2 else int(rng.randint(1, tmax + 1))
        tgt[r] = nt
        ents = []
        for s in range(nt):
            if r == rows - 1:
                continue  # missing terms
            size = 3 if r == rows - 2 else int(rng.randint(1, max(12, 180 // tmax)))
            d = np.sort(rng.choice(160, size=size, replace=False))
            equal = r == 0
            qwtab[r, s] = F32(0.5) if equal else F32(rng.uniform(0.2, 3.0))
            for j in range(0, size, 32):
                blk = np.full(32, num_docs, np.int32)
                blk[:len(d[j:j + 32])] = d[j:j + 32]
                wv = np.where(blk < num_docs, F32(0.5) if equal
                              else rng.uniform(0.05, 1.0, 32).astype(F32), F32(0))
                ents.append((len(docs_b) << 5) | s)
                docs_b.append(blk)
                w_b.append(wv.astype(F32))
        row_ents.append(ents)
    sent = len(docs_b)
    docs_b.append(np.full(32, num_docs, np.int32))
    w_b.append(np.zeros(32, F32))
    L = 64
    while L < max(k, 32 * max(len(e) for e in row_ents)):
        L *= 2
    bdir = np.full((rows + 2, L // 32), sent << 5, np.int32)
    for r, ents in enumerate(row_ents):
        bdir[r, :len(ents)] = ents
    return (np.stack(docs_b), np.stack(w_b), bdir, qwtab, tgt, row_ents)


def bucket_layout(bdir, qwtab, tgt, row_ents, k, ops, tmax, chunk=CHUNK):
    """A JoinLayout of the seeded bucket's real rows (its pack drops the
    two pad rows)."""
    n = len(row_ents)
    ent = np.asarray([e for es in row_ents for e in es], np.int32)
    nent = np.asarray([len(es) for es in row_ents], np.int64)
    bucket = {"dir": bdir, "qwtab": qwtab, "tgt": tgt}
    return JoinLayout(ent, np.cumsum(nent) - nent, nent, tgt[:n], qwtab[:n], [bucket],
                      np.arange(n, dtype=np.int32), k, ops, tmax, chunk=chunk)


OPS = [("counts",), ("or",), ("and",), ("or", "and")]
KS = [1, 10, 128]
TMAXES = [2, 4, 32]
# every pair of (ops, tmax), (ops, k) and (tmax, k) once; and all three
# ops together
CASES = [(ops, t, KS[(i + j) % 3]) for i, ops in enumerate(OPS) for j, t in enumerate(TMAXES)]
CASES += [(("counts", "or", "and"), t, k) for t, k in zip(TMAXES, KS)]


@pytest.mark.parametrize("ops,tmax,k", CASES, ids=lambda x: "+".join(x) if isinstance(x, tuple)
                         else str(x))
def test_join_bucket_matches_jax(ops, tmax, k):
    """join_bucket_torch == the JAX _join_bucket on a seeded bucket, all
    rows (the pad rows too); the kernel's emulation == join_part_torch
    on its real rows, at the kernel's chunk and at chunk 1 and 3 (rows
    spanning several CTAs)."""
    rng = np.random.RandomState(1000 * tmax + k + 7 * len(ops))
    nd = 240
    docs32, w32, bdir, qwtab, tgt, row_ents = seeded_bucket(rng, tmax, k, nd)
    exp = jax_join_bucket(jnp.asarray(docs32), jnp.asarray(w32), jnp.asarray(bdir),
                          jnp.asarray(qwtab), jnp.asarray(tgt), num_docs=nd, k=k, ops=ops,
                          tmax=tmax)
    got = join_bucket_torch(torch.from_numpy(docs32), torch.from_numpy(w32),
                            torch.from_numpy(bdir), torch.from_numpy(qwtab),
                            torch.from_numpy(tgt), nd, k, ops, tmax)
    assert_bit_equal(got.numpy(), np.asarray(exp))
    c0 = 2 if "counts" in ops else 0
    if "or" in ops:
        # the row of one 3-posting term has fewer than k candidates; the
        # equal-weight row ties its scores
        assert k < 4 or np.isneginf(got.numpy()[len(row_ents) - 2, c0 + k - 1])
        eq = got.numpy()[0, c0:c0 + k]
        assert len(np.unique(eq[np.isfinite(eq)])) < np.isfinite(eq).sum() or k == 1
    for chunk in (CHUNK, 1, 3):
        lay = bucket_layout(bdir, qwtab, tgt, row_ents, k, ops, tmax, chunk=chunk)
        plain = join_part(torch.from_numpy(docs32), torch.from_numpy(w32), lay, nd, False, None)
        assert_bit_equal(plain.numpy(), got.numpy()[:len(row_ents)])
        assert_bit_equal(emulate_join_kernel(docs32, w32, lay, nd, False, None), plain.numpy())


# -- real plans ------------------------------------------------------------------


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=800, num_terms=2000, postings_target=25_000,
                        num_queries=16, max_query_len=4)
    return base


@pytest.fixture(scope="module")
def engines(coll):
    """name -> port engine (device="cpu", small parts, its block-max
    metadata from the collection pass) over the port's index."""
    wdata = build_wdata(coll, "port")
    out = {}
    for name in SERVED_TYPES:
        eng = ResidentEngine(build_index(coll, name, "port"), wdata, device="cpu",
                             max_part_slots=1 << 13, max_part_queries=6)
        eng.build_blockmax(BinaryFreqCollection(coll))
        out[name] = eng
    return out


PLANS = {
    "exhaustive": dict(ops=("and",)),
    "or_counts": dict(ops=("counts", "or", "and")),
    "and_skip": dict(ops=("and",), prune=True),
    "wand": dict(ops=("or",), prune=True),
    "maxscore": dict(ops=("or",), prune="maxscore"),
}


def plans_of(eng, queries, which):
    """The plan `which` of PLANS and the probe sub-plans its prepare ran
    (f32 downloads): [(name, plan)]."""
    seen = []
    dispatch = eng.dispatch
    eng.dispatch = lambda plan: (seen.append(plan), dispatch(plan))[1]
    try:
        plan = eng.prepare(queries, k=10, **PLANS[which])
    finally:
        del eng.dispatch
    return [(which, plan)] + [(f"{which} probe", p) for p in seen]


def part_inputs(eng, p):
    """The part's decode (docs32, w32) as the engine's dispatch gives it."""
    put = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))  # noqa: E731
    ranked = "or" in p["ops"] or "and" in p["ops"]
    eng._ensure_norm_cache()
    return resident._decode_part(eng.state, put(p["gtile_ids"]), put(p["gtile_f"]),
                                 put(p["blkperm"]), p["layout"], eng.num_docs, ranked)


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_join_part_matches_jax_and_the_kernel_loop(coll, engines, name):
    """Every part of the exhaustive and the and_skip plan (and of its probe
    sub-plans, f32): join_part_torch == the JAX _join_bucket over every
    bucket + _pack_rows, in f16 (the plan's fscale) and f32, and the
    wrapper on CPU tensors == join_part_torch; the kernel's emulation ==
    join_part_torch there and on every part of the counts, wand and
    maxscore plans."""
    eng = engines[name]
    queries = read_queries(coll + ".queries")
    nparts = 0
    # block_optpfor's plain decode is slow on the CPU: its pruned OR plans
    # are left to the row-structure test and the card
    whiches = ("exhaustive", "and_skip") + (("or_counts", "wand", "maxscore") if name == "opt"
                                            else ())
    for which in whiches:
        for _, plan in plans_of(eng, queries, which):
            for p in plan["plans"]:
                docs32, w32 = part_inputs(eng, p)
                lay = p["join"]
                dirs, qws, tgts, pidx = lay.plain(torch.device("cpu"))
                jax_rows = None
                if which in ("exhaustive", "and_skip"):
                    jax_rows = tuple(jax_join_bucket(
                        jnp.asarray(docs32.numpy()), jnp.asarray(w32.numpy()),
                        jnp.asarray(b["dir"]), jnp.asarray(b["qwtab"]), jnp.asarray(b["tgt"]),
                        num_docs=eng.num_docs, k=p["k"], ops=p["ops"], tmax=p["tmax"])
                        for b in p["buckets"])
                for fetch16 in ((False, True) if "counts" not in p["ops"] else (False,)):
                    fscale = (p["fscale"] or 1.0) if fetch16 else None
                    got = join_part_torch(docs32, w32, dirs, qws, tgts, pidx, eng.num_docs,
                                          p["k"], p["ops"], p["tmax"], fetch16, fscale)
                    if jax_rows is not None:
                        exp = jax_pack_rows(jax_rows, jnp.asarray(p["pack_idx"]),
                                            jnp.float32(fscale if fetch16 else 1.0), fetch16)
                        assert_bit_equal(got.numpy(), np.asarray(exp))
                    assert_bit_equal(join_part(docs32, w32, lay, eng.num_docs, fetch16, fscale),
                                     got.numpy())
                    assert_bit_equal(emulate_join_kernel(docs32.numpy(), w32.numpy(), lay,
                                                         eng.num_docs, fetch16, fscale),
                                     got.numpy())
                nparts += 1
    assert nparts >= 4


def _local_to_global(eng, p):
    """Each part-local docs-order block's global (tile-major) block, -1
    for the pad rows' blocks."""
    out = []
    gt = np.asarray(p["gtile_ids"]).astype(np.int64)
    for off, R, st in p["groups"]:
        bpt = max(st[-1] // 32, 1)
        tiles = np.repeat(gt[off:off + R], bpt)
        j = np.tile(np.arange(bpt), R)
        real = tiles < eng.pad_tile
        tb = np.where(real, eng.tile_blocks[np.minimum(tiles, eng.pad_tile - 1)], 0)
        g = np.where(real & (j < tb), eng.gblk0[np.minimum(tiles, eng.pad_tile - 1)] + j, -1)
        out.append(g)
    return np.concatenate(out)


@pytest.mark.parametrize("name", SERVED_TYPES)
def test_row_structure_of_every_plan(coll, engines, name):
    """What the kernel's search relies on, over every row of every part of
    every plan (exhaustive, and_skip, wand, maxscore and their probe
    sub-plans), docids from the collection's slot planes: slots ascend
    along the row; within a slot's entries the real docids strictly
    increase, each block's slot 0 is real and its pads come last. Pads
    inside a slot's run occur in pair mode alone, where a tile ends inside
    a list (`opt` here: its partitions end anywhere); block indexes have
    pads only at a run's end."""
    eng = engines[name]
    queries = read_queries(coll + ".queries")
    doc_plane, _ = eng._collection_planes(BinaryFreqCollection(coll))
    nd = eng.num_docs
    mid_pads = rows_seen = 0
    for which in ("exhaustive", "and_skip", "wand", "maxscore"):
        for _, plan in plans_of(eng, queries, which):
            for p in plan["plans"]:
                lay = p["join"]
                l2g = _local_to_global(eng, p)
                ents = lay.ent.astype(np.int64)
                gblk = l2g[ents >> 5]
                assert np.all(gblk >= 0), "an entry names a pad block"
                blocks = doc_plane[gblk]  # (n_ent, 32)
                real = blocks < nd
                assert np.all(real[:, 0])
                # real docids first, pads last, ascending inside a block
                assert np.all(np.diff(real.astype(np.int8), axis=1) <= 0)
                assert np.all((np.diff(blocks, axis=1) > 0) | ~real[:, 1:])
                for ent0, nent, _ in lay.rows.tolist():
                    rows_seen += 1
                    slots = ents[ent0:ent0 + nent] & 31
                    assert np.all(np.diff(slots) >= 0)
                    for s in np.unique(slots):
                        e = ent0 + np.flatnonzero(slots == s)
                        d = blocks[e][real[e]]
                        assert np.all(np.diff(d) > 0)
                        mid_pads += int((~real[e[:-1]]).any())
    assert rows_seen > 50
    if eng.split:
        assert mid_pads == 0
    elif name == "opt":
        assert mid_pads > 0  # partitioned EF's tiles end inside lists


def test_wrapper_raises_off_cpu_and_cuda():
    """join_part runs its plain version on CPU tensors alone and raises
    for another device without a CUDA card; no launch is counted."""
    rng = np.random.RandomState(3)
    docs32, w32, bdir, qwtab, tgt, row_ents = seeded_bucket(rng, 4, 10)
    lay = bucket_layout(bdir, qwtab, tgt, row_ents, 10, ("and",), 4)
    before = join.join_part.launches
    join_part(torch.from_numpy(docs32), torch.from_numpy(w32), lay, 240, False, None)
    assert join.join_part.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        join_part(torch.from_numpy(docs32).to("meta"), torch.from_numpy(w32).to("meta"), lay,
                  240, False, None)
    with pytest.raises(ValueError, match="chunk"):
        bucket_layout(bdir, qwtab, tgt, row_ents, 10, ("and",), 4, chunk=CHUNK + 1)
