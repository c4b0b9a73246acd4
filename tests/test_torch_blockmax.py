"""The port's block-max metadata (ds2i_torch.ops.blockmax and
ResidentEngine._ensure_blockmax / build_blockmax, device="cpu", the plain
PyTorch path) against the JAX engine's, on zipf-skewed lists built by
both packages: the blockmax rows exactly against _slots_weight_step and
_decode_slots_step, every BLOCKMAX_FIELDS array byte-equal to the JAX
engine's decode pass for four index types, the collection pass equal to
the decode pass, the chunked pass equal to one chunk, and the planner's
overlap and pyramid bounds against a brute force."""

import gc
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu import GlobalParameters as RefParams
from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine
from ds2i_tpu.engine.resident import _decode_slots_step, _slots_weight_step
from ds2i_tpu.index.types import make_index_type as ref_index_type
from ds2i_tpu.queries.wand_data import WandData as RefWandData

from ds2i_torch.engine import ResidentEngine
from ds2i_torch.host import BinaryFreqCollection, generate_collection
from ds2i_torch.host import GlobalParameters as PortParams
from ds2i_torch.host import WandData as PortWandData
from ds2i_torch.host import make_index_type as port_index_type
from ds2i_torch.ops.blockmax import blockmax_rows, blockmax_rows_torch
from ds2i_torch.queries.bm25 import BM25

from test_torch_host_copy import build_index

BLOCKMAX_FIELDS = (
    "wmax_blk", "dmax_blk", "dmin_blk", "gblk0", "tile_of_gblk", "list_gblk0",
    "list_wmax", "_kth_vals", "_kth_start", "rank_blk", "_blk_dlo",
    "_dmax_keys", "_dlo_keys", "_pyr", "_pyr_off", "_pyr_q",
    "is_short", "_short_keys", "_short_w",
)


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release the JAX executables each test compiled before the next
    one: the JAX engines here compile large XLA-CPU programs, and a full
    suite's live-executable population is what crashed XLA-CPU's compiler
    in a worker (tests/test_wand_device.py, same fixture)."""
    yield
    jax.clear_caches()
    gc.collect()


def build_skewed(tname, seed=5, num_docs=4000, nterms=150, nqueries=48):
    """The zipf-skewed lists and query mix of tests/test_wand_device.py
    (_build), built into a `tname` index by each package, with each
    package's WandData; plus two AND-heavy queries (the five and the
    four longest lists after the two longest), whose rows keep more than
    the AND probe's 128 blocks."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(50, 400, num_docs).astype(np.int64)
    lens = np.maximum(np.minimum(rng.zipf(1.25, nterms) * 3, num_docs // 2), 1).astype(np.int64)
    lists = []
    for i in range(nterms):
        n = int(lens[i])
        docs = np.sort(rng.choice(num_docs, size=n, replace=False)).astype(np.int64)
        freqs = np.ones(n, dtype=np.int64)
        spikes = rng.rand(n) < 0.05
        freqs[spikes] = rng.randint(5, 60, max(int(spikes.sum()), 0))
        lists.append((docs, freqs))
    p = np.sqrt(lens.astype(float))
    p /= p.sum()
    qs = [list(np.unique(rng.choice(nterms, size=rng.randint(1, 6), p=p)))
          for _ in range(nqueries)]
    qs += [[int(np.argmin(lens)), int(np.argmax(lens))], [0], [1, 1, 2]]
    top = np.argsort(-lens, kind="stable")
    qs += [sorted(int(x) for x in top[:5]), sorted(int(x) for x in top[2:6])]
    out = {}
    for pkg, make_type, params, wand_data in (
            ("ref", ref_index_type, RefParams, RefWandData),
            ("port", port_index_type, PortParams, PortWandData)):
        b = make_type(tname).builder(num_docs, params())
        for docs, freqs in lists:
            b.add_posting_list(len(docs), docs, freqs, int(freqs.sum()))
        out[pkg] = (b.build(), wand_data.build(sizes, lists))
    return SimpleNamespace(ref=out["ref"], port=out["port"], qs=qs, lists=lists)


def assert_fields_equal(got, exp, names=BLOCKMAX_FIELDS):
    for name in names:
        g, e = np.asarray(getattr(got, name)), np.asarray(getattr(exp, name))
        assert g.dtype == e.dtype and g.shape == e.shape, (name, g.dtype, e.dtype, g.shape, e.shape)
        np.testing.assert_array_equal(g, e, err_msg=name)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _random_rows(seed, rows=300, num_docs=500):
    """Seeded (rows, 32) docid and freq planes with pad slots (docid
    num_docs, freq 0) and a few rows with no valid slot, and per-doc
    BM25 denominators."""
    rng = np.random.RandomState(seed)
    docs = np.sort(rng.randint(0, num_docs, (rows, 32)), axis=1).astype(np.int32)
    pad = rng.rand(rows, 32) < 0.3
    pad[:7] = True
    docs[pad] = num_docs
    freqs = np.where(pad, 0, rng.randint(1, 60, (rows, 32))).astype(np.float32)
    den = BM25.norm_denominator(rng.uniform(0.2, 3.0, num_docs).astype(np.float32))
    return docs, freqs, den, num_docs


def test_rows_match_jax_weight_step():
    """Planes form: wmax and the w plane equal _slots_weight_step's bit
    for bit; rows form (fed that w plane with garbage in the pad slots,
    as pair mode leaves them unmasked) gives the same wmax; dmax and dmin
    are _decode_slots_step's expressions (masked max, -1 for a row with
    no valid slot; slot 0)."""
    docs, freqs, den, nd = _random_rows(0)
    wm_j, w_j = _slots_weight_step(jnp.asarray(docs), jnp.asarray(freqs), jnp.asarray(den),
                                   num_docs=nd)
    wm, dmax, dmin, w = blockmax_rows_torch(torch.from_numpy(docs), torch.from_numpy(freqs), nd,
                                            torch.from_numpy(den))
    np.testing.assert_array_equal(_bits(wm.numpy()), _bits(wm_j))
    np.testing.assert_array_equal(_bits(w.numpy()), _bits(w_j))
    exp_dmax = np.where(docs < nd, docs, -1).max(axis=1)
    assert dmax.dtype == dmin.dtype == torch.int32
    np.testing.assert_array_equal(dmax.numpy(), exp_dmax)
    np.testing.assert_array_equal(dmin.numpy(), docs[:, 0])
    assert np.all(exp_dmax[:7] == -1) and np.all(wm.numpy()[:7] == 0)

    w_rows = np.where(docs < nd, np.asarray(w_j), np.float32(0.7))
    wm2, dmax2, dmin2, none = blockmax_rows(torch.from_numpy(docs), torch.from_numpy(w_rows), nd)
    assert none is None
    np.testing.assert_array_equal(_bits(wm2.numpy()), _bits(wm_j))
    np.testing.assert_array_equal(dmax2.numpy(), exp_dmax)
    np.testing.assert_array_equal(dmin2.numpy(), docs[:, 0])


@pytest.mark.parametrize("tname", ["opt", "block_interpolative"])
def test_rows_match_jax_decode_slots_step(tname):
    """Over every tile of an index as the JAX engine's decode pass lays
    it out (group-major, pad rows included): the plain version's dmax and
    dmin equal _decode_slots_step's, and its planes form equals
    _slots_weight_step's over the decoded planes."""
    d = build_skewed(tname, seed=7, num_docs=1200, nterms=40)
    ref = JaxResidentEngine(*d.ref)
    groups, gtile, _, _, groups_f, gtile_f, blkperm = ref._full_tile_orders()
    docs32, freq32, dmax_j, dmin_j = _decode_slots_step(
        ref.docs_words, ref.freqs_words, ref.tiles_docs, ref.tiles_freqs, jnp.asarray(gtile),
        jnp.asarray(gtile_f), jnp.asarray(blkperm), groups=tuple(groups),
        groups_f=tuple(groups_f), num_docs=ref.num_docs)
    wm_j, w_j = _slots_weight_step(docs32, freq32, ref.norm_den, num_docs=ref.num_docs)
    docs, freqs = np.array(docs32), np.array(freq32)
    assert np.any(np.all(docs >= ref.num_docs, axis=1))  # pad rows
    wm, dmax, dmin, w = blockmax_rows_torch(torch.from_numpy(docs), torch.from_numpy(freqs),
                                            ref.num_docs, torch.from_numpy(np.array(ref.norm_den)))
    np.testing.assert_array_equal(dmax.numpy(), np.asarray(dmax_j))
    np.testing.assert_array_equal(dmin.numpy(), np.asarray(dmin_j))
    np.testing.assert_array_equal(_bits(wm.numpy()), _bits(wm_j))
    np.testing.assert_array_equal(_bits(w.numpy()), _bits(w_j))


@pytest.mark.parametrize("tname", ["ef", "opt", "block_optpfor", "block_interpolative"])
def test_ensure_blockmax_matches_jax(tname):
    """The decode pass (every tile through the part launches with the
    served BM25 weights, then the rows form) gives every pruning table
    byte-equal to the JAX engine's decode pass."""
    d = build_skewed(tname, seed=7, num_docs=1500, nterms=60)
    ref = JaxResidentEngine(*d.ref)
    ref._ensure_blockmax()
    port = ResidentEngine(*d.port, device="cpu")
    port._ensure_blockmax()
    assert port.is_short.any() and not port.is_short.all()
    assert_fields_equal(port, ref)


@pytest.mark.parametrize("tname", ["ef", "block_optpfor"])
def test_build_blockmax_equals_decode_pass(tname):
    """The collection pass (slot planes of the original lists, planes
    form) gives the decode pass's tables byte for byte; a second call is
    a no-op."""
    d = build_skewed(tname, seed=7, num_docs=1500, nterms=60)
    dev = ResidentEngine(*d.port, device="cpu")
    dev._ensure_blockmax()
    host = ResidentEngine(*d.port, device="cpu")
    host.build_blockmax(d.lists)
    assert host.state.den_blocks is None  # no tile was decoded
    assert_fields_equal(host, dev)
    wmax = host.wmax_blk
    host.build_blockmax(d.lists[:-1])
    assert host.wmax_blk is wmax


def test_build_blockmax_from_a_collection_file(tmp_path):
    """build_blockmax over a BinaryFreqCollection (the vectorized
    concatenation of its memory-mapped streams) equals the decode pass."""
    base = str(tmp_path / "c")
    generate_collection(base, num_docs=800, num_terms=1200, postings_target=25_000,
                        num_queries=10, max_query_len=3)
    index = build_index(base, "block_optpfor", "port")
    dev = ResidentEngine(index, device="cpu")
    dev._ensure_blockmax()
    host = ResidentEngine(index, device="cpu")
    host.build_blockmax(BinaryFreqCollection(base))
    assert_fields_equal(host, dev)


def test_chunked_pass_equals_one_chunk():
    """A slot budget of 1 << 10 (floor-clamped to 1 << 12) splits the
    decode pass into several runs of tiles; the tables equal one run's,
    and wand over them equals the exhaustive ranked_or."""
    d = build_skewed("block_optpfor", seed=11, num_docs=1200, nterms=40, nqueries=16)
    one = ResidentEngine(*d.port, device="cpu")
    one._ensure_blockmax()
    many = ResidentEngine(*d.port, device="cpu", max_part_slots=1 << 10)
    many._ensure_blockmax()
    assert int(one.tile_blocks.sum()) * 32 > 2 * (1 << 12)  # three runs or more
    assert_fields_equal(many, one)
    for a, p in zip(one.ranked_or(d.qs, k=10), many.wand(d.qs, k=10)):
        assert len(a) == len(p)
        np.testing.assert_allclose(p, a, rtol=1e-3)


def test_build_blockmax_rejects_wrong_collection():
    d = build_skewed("ef", seed=3, num_docs=800, nterms=30)
    eng = ResidentEngine(*d.port, device="cpu")
    with pytest.raises(ValueError, match="does not match the index"):
        eng.build_blockmax(d.lists[:-1])
    with pytest.raises(ValueError, match="does not match the index"):
        eng.build_blockmax(d.lists[:-1] + [(d.lists[-1][0][:-1], d.lists[-1][1][:-1])])


def test_overlap_and_pyramid_against_bruteforce():
    """_blk_overlap returns the exact block range intersecting a docid
    interval, and _range_ub upper-bounds the true range max."""
    d = build_skewed("block_optpfor", seed=3, num_docs=2000, nterms=80)
    eng = ResidentEngine(*d.port, device="cpu")
    eng.build_blockmax(d.lists)
    rng = np.random.RandomState(0)
    nl = len(eng.list_gblk0) - 1
    lists = rng.randint(nl, size=500).astype(np.int64)
    ab = np.sort(rng.randint(0, eng.num_docs, (500, 2)), axis=1).astype(np.int64)
    dlos, dhis = ab[:, 0], ab[:, 1]
    bf, bl = eng._blk_overlap(lists, dlos, dhis)
    has = bf <= bl
    ub = np.zeros(len(lists), dtype=np.float32)
    ub[has] = eng._range_ub(lists[has], bf[has], bl[has])
    nonempty = 0
    for i in range(len(lists)):
        l0, l1 = eng.list_gblk0[lists[i]], eng.list_gblk0[lists[i] + 1]
        inter = [b for b in range(l0, l1)
                 if eng._blk_dlo[b] <= dhis[i] and eng.dmax_blk[b] >= dlos[i]]
        if inter:
            nonempty += 1
            assert has[i] and bf[i] == inter[0] and bl[i] == inter[-1], i
            true_max = eng.wmax_blk[inter[0]:inter[-1] + 1].max()
            assert ub[i] >= true_max, (i, ub[i], true_max)
        else:
            assert not has[i], i
    assert 50 < nonempty < len(lists)
