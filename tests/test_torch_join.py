"""The join and pack (K3, ds2i_torch/ops/join.py) on the CPU.

- join_bucket_torch against the JAX engine's _join_bucket on seeded
  buckets (ops, tmax, k; rows with fewer than k candidates, rows with no
  entry, all-sentinel pad rows, equal scores), bit for bit;
- join_part_torch against the JAX _join_bucket + _pack_rows over every
  part of real plans (exhaustive and and_skip over `opt` and
  block_optpfor), f16 and f32 downloads, bit for bit;
- a numpy emulation of csrc/join.cu's design (the AND-only form driven
  from each row's shortest slot, its search stopping at the first slot
  that lacks a docid; the general form's run owner in its highest slot;
  the descending-slot sum; warp rows and CTA items; each lane's search
  of a slot; the warp's register top-k with its bitonic merge, the CTA
  item's merge of its warps' lists, the compacted candidates for k > 32,
  the merge of a long row's items) bit-equal to join_part_torch on those
  parts and buckets, under every work split (CHUNKS);
- seeded rows the kernel treats apart (single-term rows, a row whose
  shortest slot is its top slot, pruned rows with an empty slot, pads
  inside a slot's run, equal scores, 17-32 slots, rows longer than a CTA
  item) at k 10 and 128, the k 10 form also against the JAX
  _join_bucket;
- the row structure the kernel's search relies on, over every plan of
  every index type (exhaustive, and_skip, wand, maxscore; the probe
  sub-plans included): slots ascend along a row (so each slot's entries
  are contiguous); within a slot the blocks' real docids strictly
  increase, each block's slot 0 is real and its pads (num_docs) come
  last; the layout's driving entries are the shortest slot's (AND-only)
  or every entry. Pads inside a slot's run (before a later block) occur
  where a tile ends inside a list, in pair mode: the test pins that
  `opt` has them and the block indexes have none.

Scores are compared bit for bit everywhere: the same f32 products and
adds in the same order, and XLA's CPU rounds them as IEEE does. About 55 s
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
from ds2i_torch.ops.join import CHUNK, join_bucket_torch, join_part, join_part_torch

from test_torch_host_copy import SERVED_TYPES, build_index, build_wdata
from torch_join_rows import KINDS, bucket_layout, bucket_of, relaid, special_rows

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

LANES = np.arange(32)
KSMALL = join.WARP_K


def _topk_merge(top, v):
    """A warp's running list `top` (a value a lane, descending) merged
    with 32 ascending values: the elementwise max (bitonic, the 32
    largest of both), then a half-cleaner network to descending
    (csrc/join.cu topk_merge, __shfl_xor_sync for each exchange)."""
    m = np.maximum(top, v)
    for st in (16, 8, 4, 2, 1):
        o = m[LANES ^ st]
        m = np.where(LANES & st, np.minimum(m, o), np.maximum(m, o))
    return m


def _topk_insert(top, v, k):
    """csrc/join.cu topk_insert: a batch v (a candidate or -inf a lane)
    into the running top-k list, skipped where no lane beats its k-th
    value; else a bitonic sort of v ascending across the lanes, then the
    merge."""
    if not np.any(v > top[k - 1]):
        return top
    size = 2
    while size <= 32:
        st = size // 2
        while st:
            o = v[LANES ^ st]
            keep_min = ((LANES & st) == 0) == ((LANES & size) == 0)
            v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            st //= 2
        size *= 2
    return _topk_merge(top, v)


class _Row:
    """One packed row as a warp of the kernel sees it: its entries, their
    blocks' first docids (staged or not, the same values), the slot
    bounds (lane s holds the row's first entry of a slot >= s) and its
    query weights."""

    def __init__(self, lay, docs, row):
        ent0, nent, self.tgt, self.d0, self.nd = lay.rows[row].tolist()
        self.ent = lay.ent[ent0:ent0 + nent].astype(np.int64)
        self.first = docs[(self.ent >> 5) * 32]
        self.sb = np.searchsorted(self.ent & 31, np.arange(lay.tmax + 1), side="left")
        self.qw = lay.qw[row]


def _search(docs, w, row, x, live, s):
    """csrc/join.cu search: each live lane's docid x in slot s. A lane's
    block is the slot's last entry whose first docid is <= x (a binary
    search over the first docids); a 5-step search of the block's
    docids finds x. (hit, its weight)."""
    a, b = int(row.sb[s]), int(row.sb[s + 1])
    lo = np.full(32, a, np.int64)
    n = np.where(live, b - a, 0).astype(np.int64)
    while np.any(n > 0):
        half = n >> 1
        go = (n > 0) & (row.first[np.minimum(lo + half, len(row.first) - 1)] <= x)
        lo = np.where(go, lo + half + 1, lo)
        n = np.where(n > 0, np.where(go, n - half - 1, half), 0)
    pos = lo - 1
    cand = live & (pos >= a)
    if not cand.any():
        return cand, np.zeros(32, F32)
    base = (row.ent[np.maximum(pos, a)] >> 5) * 32
    j = np.zeros(32, np.int64)
    for st in (16, 8, 4, 2, 1):
        j = np.where(docs[base + j + st - 1] < x, j + st, j)
    hit = cand & (docs[base + j] == x)
    return hit, np.where(hit, w[base + j], F32(0))


def _drive(lay, docs, w, row, e, num_docs):
    """csrc/join.cu drive: the 32 postings of the row's entry e, a lane
    each. AND-only form (ops ("and",), e in the row's shortest slot): the
    other slots in descending order, stopping at the first that lacks the
    docid, the sum ((c[tgt-1] + c[tgt-2]) + ...) + c[0]. General form:
    every other slot, highest first; a docid found in a higher slot is
    not this entry's to own; the owner adds the lower slots' c in
    descending order and counts them. (OR value, AND value, OR flags, AND
    flags), -inf where not a candidate."""
    d = int(row.ent[e])
    slot, base = d & 31, (d >> 5) * 32
    x = docs[base:base + 32]
    own = w[base:base + 32] * row.qw[slot]
    live = x < num_docs
    if lay.and_only:
        total = own
        for s in range(row.tgt - 1, -1, -1):
            if s == slot:
                c = own
            else:
                if not live.any():
                    break
                hit, hw = _search(docs, w, row, x, live, s)
                live &= hit
                c = hw * row.qw[s]
            total = c if s == row.tgt - 1 else total + c
        return None, np.where(live, total, NEG_INF), None, live
    total, cnt = own, np.ones(32, np.int64)
    for s in range(lay.tmax - 1, -1, -1):
        if s == slot or row.sb[s] == row.sb[s + 1]:
            continue
        if not live.any():
            break
        hit, hw = _search(docs, w, row, x, live, s)
        if s > slot:
            live &= ~hit
        else:
            total = np.where(hit, total + hw * row.qw[s], total)
            cnt += hit
    in_and = live & (cnt == row.tgt) & (row.tgt > 0)
    return np.where(live, total, NEG_INF), np.where(in_and, total, NEG_INF), live, in_and


def _desc(x):
    return -np.sort(-x)


def emulate_join_kernel(docs32, w32, lay, num_docs, fetch16, fscale):
    """csrc/join.cu's launch over a JoinLayout, step for step in numpy
    f32: the packed output rows. Warp rows: one warp drives the row's
    driving entries in turn, its top-k lists in registers. CTA items:
    warp i drives entries i, i + 8, ...; k <= 32, the 8 warps' lists
    merged once; k > 32, the item's candidates compacted and sorted
    alone. Rows of several items: counts and top-k lists to scratch,
    merged by the last item to finish (k <= 32: by warp merges; else
    sorted sb values at a time)."""
    docs = np.ascontiguousarray(docs32).reshape(-1).astype(np.int64)
    w = np.ascontiguousarray(w32).reshape(-1)
    k, nr = lay.k, lay.n_ranked
    ranked = [i for i, op in enumerate(("or", "and")) if op in lay.ops]
    out = np.zeros((lay.n_rows, lay.width), F32)
    sc_vals = np.zeros((max(lay.n_scratch, 1), max(nr, 1), k), F32)
    sc_cnt = np.zeros((max(lay.n_scratch, 1), 2), np.int64)
    c0 = 2 if "counts" in lay.ops else 0
    neg = np.full(32, NEG_INF, F32)

    def warp_pass(row, entries):
        tops, cands, n = [neg, neg], [[], []], [0, 0]
        for e in entries:
            vals = _drive(lay, docs, w, row, e, num_docs)
            for i in ranked:
                if k <= KSMALL:
                    tops[i] = _topk_insert(tops[i], vals[i], k)
                else:
                    cands[i] += list(vals[i][np.isfinite(vals[i])])
            for i in (0, 1):
                if vals[2 + i] is not None:
                    n[i] += int(vals[2 + i].sum())
        return tops, cands, n

    def write(row, sc, n, lists):
        if sc < 0:
            vals = ([F32(n[1]), F32(n[0])] if c0 else []) + [v for t in lists for v in t]
            out[row] = np.asarray(vals, F32)
        else:
            sc_cnt[sc] = (n[1], n[0])
            for r, t in enumerate(lists):
                sc_vals[sc, r] = t

    for row in lay.wrows.tolist():
        r = _Row(lay, docs, row)
        tops, _, n = warp_pass(r, range(r.d0, r.d0 + r.nd))
        write(row, -1, n, [tops[i][:k] for i in ranked])
    for row, d0, ne, sc, _ in lay.items.tolist():
        r = _Row(lay, docs, row)
        warps = [warp_pass(r, range(d0 + i, d0 + ne, 8)) for i in range(8)]
        n = [sum(wp[2][i] for wp in warps) for i in (0, 1)]
        lists = []
        for i in ranked:
            if k <= KSMALL:
                top = warps[0][0][i]
                for wp in warps[1:]:
                    v = wp[0][i][::-1]
                    if np.any(v > top[k - 1]):
                        top = _topk_merge(top, v)
                lists.append(top[:k])
            else:
                c = np.asarray([v for wp in warps for v in wp[1][i]], F32)
                m = 32
                while m < len(c):
                    m *= 2
                buf = np.concatenate([_desc(c), np.full(m - len(c), NEG_INF, F32)])
                lists.append(np.concatenate([buf, np.full(max(k - m, 0), NEG_INF, F32)])[:k])
        write(row, sc, n, lists)
    sb_size = 2 * CHUNK * 32
    while sb_size < 2 * k:
        sb_size *= 2
    for row, s0, ni in lay.merges.tolist():  # by the row's last item to finish
        vals = list(sc_cnt[s0:s0 + ni].sum(axis=0).astype(F32)) if c0 else []
        for r in range(nr):
            if k <= KSMALL:  # warp 0: each list, ascending, into its register list
                top = neg
                for q in range(ni):
                    v = np.concatenate([sc_vals[s0 + q, r], np.full(32 - k, NEG_INF, F32)])[::-1]
                    if np.any(v > top[k - 1]):
                        top = _topk_merge(top, v)
                vals += list(top[:k])
                continue
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


# the kernel's work splits, by the most driving entries a CTA item takes:
# its own (CHUNK); one (every row of more driving entries than a warp
# takes merges its items' lists); and three
CHUNKS = [CHUNK, 1, 3]


def assert_kernel_loop(docs32, w32, lay, num_docs, fetch16, fscale, exp, chunks=CHUNKS):
    """The kernel's emulation == exp under every work split of `chunks`."""
    for chunk in chunks:
        assert_bit_equal(emulate_join_kernel(docs32, w32, relaid(lay, chunk), num_docs, fetch16,
                                             fscale), exp)


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
    on its real rows, under every work split of CHUNKS (rows spanning
    several CTA items among them)."""
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
    lay = bucket_layout(bdir, qwtab, tgt, row_ents, k, ops, tmax)
    plain = join_part(torch.from_numpy(docs32), torch.from_numpy(w32), lay, nd, False, None)
    assert_bit_equal(plain.numpy(), got.numpy()[:len(row_ents)])
    assert_kernel_loop(docs32, w32, lay, nd, False, None, plain.numpy())


@pytest.mark.parametrize("ops,k", [(("and",), 10), (("counts", "or", "and"), 128)],
                         ids=["and-10", "counts+or+and-128"])
@pytest.mark.parametrize("kind", KINDS)
def test_join_kernel_loop_special_rows(kind, ops, k):
    """Rows the kernel treats apart, seeded: single-term rows, a row whose
    shortest slot is its top slot, pruned rows with an empty slot, pads
    inside a slot's run, equal scores, 17-32 slots, rows longer than a
    CTA item. join_bucket_torch == the JAX _join_bucket (at k 10, the
    main path's form); the wrapper on CPU tensors
    == join_bucket_torch's real rows; the kernel's emulation == both
    under every work split; and the layout drives each row as the
    kernel's design says."""
    rng = np.random.RandomState(KINDS.index(kind) * 100 + k)
    rows, nd, equal = special_rows(kind, rng)
    tmax = 2
    while tmax < max(len(r) for r in rows):
        tmax *= 2
    docs32, w32, bdir, qwtab, tgt, row_ents = bucket_of(rows, tmax, nd, rng, equal)
    got = join_bucket_torch(torch.from_numpy(docs32), torch.from_numpy(w32),
                            torch.from_numpy(bdir), torch.from_numpy(qwtab),
                            torch.from_numpy(tgt), nd, k, ops, tmax)
    if k == 10:  # the main path's form against the JAX engine too
        exp = jax_join_bucket(jnp.asarray(docs32), jnp.asarray(w32), jnp.asarray(bdir),
                              jnp.asarray(qwtab), jnp.asarray(tgt), num_docs=nd, k=k, ops=ops,
                              tmax=tmax)
        assert_bit_equal(got.numpy(), np.asarray(exp))
    n = len(rows)
    lay = bucket_layout(bdir, qwtab, tgt, row_ents, k, ops, tmax)
    plain = join_part(torch.from_numpy(docs32), torch.from_numpy(w32), lay, nd, False, None)
    assert_bit_equal(plain.numpy(), got.numpy()[:n])
    assert_kernel_loop(docs32, w32, lay, nd, False, None, plain.numpy())

    sizes = [[len(b) for b in r] for r in rows]
    d0, ndrive = lay.rows[:, 3], lay.rows[:, 4]
    st = lay.structure()
    assert st["warp_rows"] + st["cta_rows"] == n
    if ops == ("and",):
        for r, sz in enumerate(sizes):  # the driving slot: a shortest one
            if min(sz) == 0:
                assert lay.empty[r] and ndrive[r] == 0
                assert np.all(np.isneginf(plain.numpy()[r]))
            else:
                s = int(np.argmin(sz))
                assert (d0[r], ndrive[r]) == (sum(sz[:s]), sz[s]) and not lay.empty[r]
        assert st["drive_entries"] < st["entries"] or kind == "single"
        assert st["warp_rows"] > 0
        if kind == "top_shortest":
            assert all(int(np.argmin(sz)) == len(sz) - 1 for sz in sizes)
    else:
        assert np.array_equal(ndrive, [sum(sz) for sz in sizes]) and not lay.empty.any()
        assert st["warp_rows"] == 0  # k > 32: every row on CTA items
    if kind == "long":
        assert st["merged_rows"] > 0
    if kind == "mid_pads":
        assert any(0 < len(b) < 32 for r in rows for sl in r for b in sl[:-1])
    if kind == "ties":
        vals = plain.numpy()[:, -k:]
        fin = vals[np.isfinite(vals)]
        assert len(np.unique(fin)) < len(fin)
    if kind in ("top_shortest", "empty_slot", "single", "long"):
        assert np.isfinite(plain.numpy()[:, -k]).any()  # some row has an AND result


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
    maxscore plans, under every work split of CHUNKS."""
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
                    # every work split in f32, the f16 pack on the kernel's own
                    assert_kernel_loop(docs32.numpy(), w32.numpy(), lay, eng.num_docs, fetch16,
                                       fscale, got.numpy(),
                                       chunks=CHUNKS[:1] if fetch16 else CHUNKS)
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
    increase, each block's slot 0 is real and its pads come last. The
    layout's driving entries: with ops ("and",) the shortest slot's among
    0 .. tgt-1, none where one of them has no entry; else every entry.
    Pads
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
                for (ent0, nent, tgt, d0, ndrive), empty in zip(lay.rows.tolist(), lay.empty):
                    rows_seen += 1
                    slots = ents[ent0:ent0 + nent] & 31
                    assert np.all(np.diff(slots) >= 0)
                    # the driving entries: the shortest slot of 0 .. tgt-1
                    # (none where one has no entry) or every entry
                    cnt = np.bincount(slots, minlength=32)[:tgt]
                    if lay.and_only:
                        assert np.all(slots < tgt)
                        assert empty == (tgt > 0 and cnt.min() == 0)
                        if not empty and tgt:
                            s = int(np.argmin(cnt))
                            assert (d0, ndrive) == (cnt[:s].sum(), cnt[s])
                            assert np.all(slots[d0:d0 + ndrive] == s)
                        else:
                            assert ndrive == 0
                    else:
                        assert (d0, ndrive) == (0, nent) and not empty
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
