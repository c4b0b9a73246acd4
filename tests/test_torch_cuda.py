"""The port on the card: each CUDA kernel (the part-level EF pair
decode, OptPFor, Varint-G8IU, QMX and interpolative block decode, launch
by launch and as a whole part, and K7 and K8 on seeded edge rows; the
block-max pass in both forms; the join and pack, K3, on every part of
every plan) against its plain
PyTorch version, and ResidentEngine on CUDA against the same
engine on the CPU, exhaustive and pruned, over every index type.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is False. The card's machine has no jax, so run them there without the
JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ds2i_torch.engine import ResidentEngine, resident
from ds2i_torch.host import (
    BinaryFreqCollection, GlobalParameters, WandData, generate_collection,
    make_index_type, mixed_choices, read_queries, read_sizes, rebuild_mixed,
)
from ds2i_torch.ops import block_decode, pair_decode
from ds2i_torch.ops.blockmax import blockmax_rows, blockmax_rows_torch
from ds2i_torch.ops.block_decode import (
    KERNELS, WRAPPERS, PartLayout, decode_launch_torch, interp_decode, optpfor_decode,
    qmx_decode, split_decode_part, split_decode_part_torch, varint_decode,
)

from ds2i_torch.ops.pair_decode import (
    decode_pair, decode_pair_launch_torch, pair_decode_part, pair_decode_part_torch,
)
from torch_block_rows import block_part, qmx_rows, varint_rows
from torch_join_rows import KINDS, bucket_layout, bucket_of, special_rows

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def coll(cuda, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


def build(coll_base, name):
    """`name` index of the collection; block_mixed is rebuild_mixed over
    block_optpfor with mixed_choices."""
    c = BinaryFreqCollection(coll_base)
    b = make_index_type("block_optpfor" if name == "block_mixed" else name).builder(
        c.num_docs, GlobalParameters())
    for docs, freqs in c:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
    index = b.build()
    return rebuild_mixed(index, *mixed_choices(index)) if name == "block_mixed" else index


EF_TYPES = ["ef", "single", "uniform", "opt"]
BLOCK_TYPES = ["block_optpfor", "block_varint", "block_interpolative", "block_qmx",
               "block_mixed"]
# the block kernels each block type launches
BLOCK_KERNELS = {"block_optpfor": {"optpfor", "interp"}, "block_varint": {"varint", "interp"},
                 "block_interpolative": {"interp"}, "block_qmx": {"qmx", "interp"},
                 "block_mixed": {"optpfor", "varint", "interp"}}


def _same_bits(a, b):
    """Equal dtypes and shapes and equal bits (-0.0 != +0.0)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", EF_TYPES)
def test_kernel_matches_plain_on_every_group(cuda, coll, name):
    """pair_decode's one launch over every tile (all groups), in each mode
    the engine uses (docs alone, for the norm cache; presence flags; BM25
    weights), against decode_pair_launch_torch on the card, bit for bit;
    one counted launch per call."""
    eng = ResidentEngine(build(coll, name), device=cuda)
    eng._ensure_norm_cache()
    s, nd = eng.state, eng.num_docs
    part = eng.all_tiles_part()
    launch = part.layout.launch("pair", True, cuda)
    assert launch.n_cta > 0
    for mode in ("docs", "presence", "bm25"):
        outs = []
        for fn in (decode_pair, decode_pair_launch_torch):
            out = torch.full((part.layout.nb_d, 32), -7, dtype=torch.int32, device=cuda)
            w = torch.full((part.layout.nb_d, 32), -7.0, device=cuda)
            before = pair_decode.decode_pair.launches
            fn(launch, s.docs_words, s.freqs_words, s.tiles_docs, s.tiles_freqs, part.gtile_ids,
               mode, nd, out, w, s.den_blocks, s.tile_gblk0)
            torch.cuda.synchronize()
            assert pair_decode.decode_pair.launches == before + (fn is decode_pair)
            outs.append((out, w))
        (go, gw), (po, pw) = outs
        _same_bits(go, po)
        _same_bits(gw, pw)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, coll):
    eng = ResidentEngine(build(coll, "opt"), device=cuda)
    s, nd = eng.state, eng.num_docs
    part = eng.all_tiles_part()
    launch = part.layout.launch("pair", True, cuda)
    out = torch.empty((part.layout.nb_d, 32), dtype=torch.int32, device=cuda)
    args = (s.freqs_words, s.tiles_docs, s.tiles_freqs, part.gtile_ids, "docs", nd)
    with pytest.raises(ValueError, match="int32"):
        decode_pair(launch, s.docs_words.long(), *args, out)
    with pytest.raises(ValueError, match="int64"):
        decode_pair(launch, s.docs_words, *args[:3], part.gtile_ids.int(), "docs", nd, out)
    with pytest.raises(ValueError, match="CTA table lies on"):
        decode_pair(part.layout.launch("pair", True, "cpu"), s.docs_words, *args, out)
    with pytest.raises(ValueError, match="launch writes blocks"):
        decode_pair(launch, s.docs_words, *args, out[:-1])
    with pytest.raises(ValueError, match="w must be given"):
        decode_pair(launch, s.docs_words, *args[:4], "presence", nd, out)
    with pytest.raises(ValueError, match="CTA table of the interp"):
        decode_pair(PartLayout(((0, 8, ("interp", 4, 32)),)).launch("interp", True, cuda),
                    s.docs_words, *args, out)
    for st in (("ef", 4, 4, 256), ("ef", 4, 4, 16), ("ef", 4096, 4, 32), ("ef", 0, 4, 32),
               ("ef", 4, 2048, 32), ("ef", 4, -1, 32)):
        with pytest.raises(ValueError, match="pair_decode takes"):
            PartLayout(((0, 8, st),))


@pytest.mark.parametrize("name", BLOCK_TYPES)
def test_block_kernels_match_plain_on_every_group(cuda, coll, name):
    """Each kernel's one launch per stream over every tile, in each mode
    the engine uses (freqs; docs with BM25 weights; docs alone, for the
    norm cache; docs with presence flags), against decode_launch_torch on
    the card, bit for bit; one counted launch per call."""
    eng = ResidentEngine(build(coll, name), device=cuda)
    eng._ensure_norm_cache()
    s, nd = eng.state, eng.num_docs
    gt, gf, bp, lay = eng.all_tiles_part()[:4]
    freq = torch.empty((lay.nb_f, 32), dtype=torch.int32, device=cuda)
    for kernel in KERNELS:  # the freqs buffer the weighted docs launches read
        block_decode.WRAPPERS[kernel](lay.launch(kernel, False, cuda), s.docs_words,
                                      s.tiles_freqs, gf, "freqs", nd, freq)
    launched = set()
    for kernel in KERNELS:
        wrapper = block_decode.WRAPPERS[kernel]
        for mode in ("freqs", "bm25", "docs", "presence"):
            is_docs = mode != "freqs"
            launch = lay.launch(kernel, is_docs, cuda)
            if not launch.n_cta:
                continue
            table, gtile = (s.tiles_docs, gt) if is_docs else (s.tiles_freqs, gf)
            nb = lay.nb_d if is_docs else lay.nb_f
            outs = []
            for fn in (wrapper, decode_launch_torch):
                out = torch.full((nb, 32), -7, dtype=torch.int32, device=cuda)
                w = torch.full((nb, 32), -7.0, device=cuda) if mode in ("bm25", "presence") else None
                if fn is wrapper:
                    before = wrapper.launches
                    fn(launch, s.docs_words, table, gtile, mode, nd, out, w, freq, bp,
                       s.den_blocks, s.tile_gblk0)
                    torch.cuda.synchronize()
                    assert wrapper.launches == before + 1
                    launched.add(kernel)
                else:
                    fn(launch, s.docs_words, table, gtile, mode, nd, out, w, freq, bp,
                       s.den_blocks, s.tile_gblk0)
                outs.append((out, w))
            (go, gw), (po, pw) = outs
            torch.testing.assert_close(go, po, rtol=0, atol=0)
            if gw is not None:
                torch.testing.assert_close(gw, pw, rtol=0, atol=0)
    assert launched == BLOCK_KERNELS[name]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kernel", ["qmx", "varint"])
def test_block_kernel_on_seeded_rows(cuda, kernel, seed):
    """K8 or K7 on the seeded edge rows of tests/torch_block_rows.py (QMX:
    ninst < NI, nsel < S, NI and S at 32; Varint-G8IU: ngroups < G = 64
    and more groups than G; both: the stream's last block, whose words
    clamp, and malformed cursors at and past the stream's ends), laid as a
    part of one group per statics: one launch per mode (freqs; docs alone,
    with presence flags, with BM25 weights) against decode_launch_torch on
    the card, bit for bit; an output off a 16-byte boundary raises."""
    if kernel == "qmx":
        words, rows = qmx_rows(seed)
        statics = [("qmx", NI, S, 128) for NI, S, _, _ in rows]
        fields = [f for _, _, f, _ in rows]
    else:
        words, rows = varint_rows(seed)
        statics = [("var", G, 128) for G, _, _ in rows]
        fields = [f for _, f, _ in rows]
    lay, t = block_part(statics, fields, seed)
    words = torch.from_numpy(words.view(np.int32)).to(cuda)
    fld, gtile, freq, bp, den, g0 = (t[k].to(cuda) for k in (
        "fld", "gtile", "freq", "blkperm", "den_blocks", "tile_gblk0"))
    wrapper = block_decode.WRAPPERS[kernel]
    for mode in ("freqs", "docs", "presence", "bm25"):
        launch = lay.launch(kernel, mode != "freqs", cuda)
        assert launch.n_cta > 1
        outs = []
        for fn in (wrapper, decode_launch_torch):
            out = torch.full((lay.nb_d, 32), -7, dtype=torch.int32, device=cuda)
            w = torch.full((lay.nb_d, 32), -7.0, device=cuda) if mode in ("bm25", "presence") else None
            before = wrapper.launches
            fn(launch, words, fld, gtile, mode, t["num_docs"], out, w, freq, bp, den, g0)
            torch.cuda.synchronize()
            assert wrapper.launches == before + (fn is wrapper)
            outs.append((out, w))
        (go, gw), (po, pw) = outs
        _same_bits(go, po)
        if gw is not None:
            _same_bits(gw, pw)
    off = torch.empty(lay.nb_d * 32 + 1, dtype=torch.int32, device=cuda)[1:].view(lay.nb_d, 32)
    with pytest.raises(RuntimeError, match="misaligned"):  # the tail's 16-byte vectors
        wrapper(lay.launch(kernel, True, cuda), words, fld, gtile, "docs", t["num_docs"], off)


@pytest.mark.parametrize("weights", ["bm25", "presence", None])
@pytest.mark.parametrize("name", EF_TYPES + BLOCK_TYPES)
def test_part_decode_matches_plain_on_every_part(cuda, coll, name, weights):
    """pair_decode_part (EF family) or split_decode_part (block indexes)
    on the card against its plain version on the card, bit for bit, on
    every part of a several-part plan and over all tiles. Pair mode: one
    launch a part; split mode: at most one launch per kernel and stream,
    freqs only for BM25 weights (None is the norm cache's docs-only
    decode)."""
    eng = ResidentEngine(build(coll, name), device=cuda, max_part_slots=1 << 13,
                         max_part_queries=32)
    eng._ensure_norm_cache()
    s, nd = eng.state, eng.num_docs
    plan = eng.prepare(read_queries(coll + ".queries"), k=10, ops=("and",))
    assert len(plan["plans"]) > 1
    put = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(cuda)  # noqa: E731
    parts = [(put(p["gtile_ids"]), put(p["gtile_f"]), put(p["blkperm"]), p["layout"])
             for p in plan["plans"]]
    for gt, gf, bp, lay in parts + [eng.all_tiles_part()[:4]]:
        rows = 1 << max(lay.nb_d - 1, 0).bit_length()
        if name in EF_TYPES:
            args = (s.docs_words, s.freqs_words, s.tiles_docs, s.tiles_freqs, gt, lay, nd,
                    weights, s.den_blocks, s.tile_gblk0, rows)
            before = pair_decode.decode_pair.launches
            got = pair_decode_part(*args)
            torch.cuda.synchronize()
            assert pair_decode.decode_pair.launches == before + 1
            exp = pair_decode_part_torch(*args)
            _same_bits(got[0], exp[0])
            if weights is None:
                assert got[1] is None and exp[1] is None
            else:
                _same_bits(got[1], exp[1])
            continue
        args = (s.docs_words, s.tiles_docs, s.tiles_freqs, gt, gf, bp, lay, nd, weights,
                s.den_blocks, s.tile_gblk0, rows)
        before = {k: w.launches for k, w in WRAPPERS.items()}
        got = split_decode_part(*args)
        torch.cuda.synchronize()
        n = {k: w.launches - before[k] for k, w in WRAPPERS.items()}
        streams = 2 if weights == "bm25" else 1
        assert 1 <= n["interp"] <= streams and all(x <= streams for x in n.values())
        assert {k for k, x in n.items() if x > 0} <= BLOCK_KERNELS[name]
        exp = split_decode_part_torch(*args)
        torch.testing.assert_close(got[0], exp[0], rtol=0, atol=0)
        if weights is None:
            assert got[1] is None and exp[1] is None
        else:
            torch.testing.assert_close(got[1], exp[1], rtol=0, atol=0)


def test_block_wrappers_reject_what_the_kernels_do_not_take(cuda, coll):
    eng = ResidentEngine(build(coll, "block_optpfor"), device=cuda)
    s, nd = eng.state, eng.num_docs
    gt, gf, bp, lay = eng.all_tiles_part()[:4]
    launch = lay.launch("optpfor", True, cuda)
    out = torch.empty((lay.nb_d, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        optpfor_decode(launch, s.docs_words.long(), s.tiles_docs, gt, "docs", nd, out)
    with pytest.raises(ValueError, match="int64"):
        optpfor_decode(launch, s.docs_words, s.tiles_docs, gt.int(), "docs", nd, out)
    with pytest.raises(ValueError, match="CTA table of the optpfor"):
        interp_decode(launch, s.docs_words, s.tiles_docs, gt, "docs", nd, out)
    with pytest.raises(ValueError, match="mode"):
        optpfor_decode(launch, s.docs_words, s.tiles_docs, gt, "weights", nd, out)
    with pytest.raises(ValueError, match="w must be given"):
        optpfor_decode(launch, s.docs_words, s.tiles_docs, gt, "presence", nd, out)
    with pytest.raises(ValueError, match="CTA table lies on"):
        optpfor_decode(lay.launch("optpfor", True, "cpu"), s.docs_words, s.tiles_docs, gt,
                       "docs", nd, out)
    with pytest.raises(ValueError, match="optpfor_decode takes"):
        PartLayout(((0, 8, ("optp", 5, 3, 128)),))
    with pytest.raises(NotImplementedError, match="Simple16"):
        PartLayout(((0, 8, ("opt", 5, 4, 128)),))
    with pytest.raises(ValueError, match="interp_decode takes"):
        PartLayout(((0, 8, ("interp", 5, 32)),))
    with pytest.raises(ValueError, match="varint_decode takes"):
        PartLayout(((0, 8, ("var", 32, 128)),))
    with pytest.raises(ValueError, match="qmx_decode takes"):
        PartLayout(((0, 8, ("qmx", 8, 12, 128)),))
    with pytest.raises(ValueError, match="CTA table of the optpfor"):
        varint_decode(launch, s.docs_words, s.tiles_docs, gt, "docs", nd, out)
    with pytest.raises(ValueError, match="CTA table of the optpfor"):
        qmx_decode(launch, s.docs_words, s.tiles_docs, gt, "docs", nd, out)


@pytest.mark.parametrize("name", ["ef", "opt"] + BLOCK_TYPES)
def test_engine_on_cuda_equals_engine_on_cpu(cuda, coll, name):
    """Same decode bits, IEEE f32 add and divide on both devices, the same
    stable sort and shifted-add order: the norm cache, counts and top-10
    scores are equal, not merely close."""
    index = build(coll, name)
    c = BinaryFreqCollection(coll)
    wdata = WandData.build(read_sizes(coll), c)
    queries = read_queries(coll + ".queries")
    gpu = ResidentEngine(index, wdata, device=cuda)
    cpu = ResidentEngine(index, wdata, device="cpu")
    gpu._ensure_norm_cache()
    cpu._ensure_norm_cache()
    torch.testing.assert_close(gpu.state.den_blocks.cpu(), cpu.state.den_blocks, rtol=0, atol=0)
    np.testing.assert_array_equal(gpu.and_counts(queries), cpu.and_counts(queries))
    np.testing.assert_array_equal(gpu.or_counts(queries), cpu.or_counts(queries))
    assert gpu.ranked_and(queries, k=10) == cpu.ranked_and(queries, k=10)
    assert gpu.ranked_or(queries, k=10) == cpu.ranked_or(queries, k=10)


BLOCKMAX_FIELDS = (
    "wmax_blk", "dmax_blk", "dmin_blk", "gblk0", "tile_of_gblk", "list_gblk0",
    "list_wmax", "_kth_vals", "_kth_start", "rank_blk", "_blk_dlo",
    "_dmax_keys", "_dlo_keys", "_pyr", "_pyr_off", "_pyr_q",
    "is_short", "_short_keys", "_short_w",
)


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_blockmax_kernel_matches_plain(cuda, coll, name):
    """blockmax's one launch against blockmax_rows_torch on the card, bit
    for bit: rows form over every tile's BM25 decode (pair mode's w
    unmasked), planes form over seeded planes with pad slots and rows
    with no valid slot; one counted launch per call."""
    wdata = WandData.build(read_sizes(coll), BinaryFreqCollection(coll))
    eng = ResidentEngine(build(coll, name), wdata, device=cuda)
    eng._ensure_norm_cache()
    docs32, w32, _, _, _ = resident._decode_slots_step(eng.state, eng.all_tiles_part(), eng.num_docs)
    rng = np.random.RandomState(0)
    nd = eng.num_docs
    docs = np.sort(rng.randint(0, nd, (5000, 32)), axis=1).astype(np.int32)
    pad = rng.rand(5000, 32) < 0.3
    pad[:9] = True
    docs[pad] = nd
    freqs = np.where(pad, 0, rng.randint(1, 60, (5000, 32))).astype(np.float32)
    planes = (torch.from_numpy(docs).to(cuda), torch.from_numpy(freqs).to(cuda), eng.state.norm_den)
    for args in ((docs32, w32, None), planes):
        before = blockmax_rows.launches
        got = blockmax_rows(args[0], args[1], nd, args[2])
        torch.cuda.synchronize()
        assert blockmax_rows.launches == before + 1
        exp = blockmax_rows_torch(args[0], args[1], nd, args[2])
        for g, e in zip(got, exp):
            if e is None:
                assert g is None
            else:
                _same_bits(g, e)


def test_blockmax_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    d = torch.zeros((4, 32), dtype=torch.int32, device=cuda)
    w = torch.zeros((4, 32), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        blockmax_rows(d.long(), w, 10)
    with pytest.raises(ValueError, match="rows, 32"):
        blockmax_rows(d[:, :16].contiguous(), w[:, :16].contiguous(), 10)
    with pytest.raises(ValueError, match="norm_den"):
        blockmax_rows(d, w, 10, torch.ones(9, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        blockmax_rows(d.t(), w, 10)


@pytest.mark.parametrize("name", ["opt", "block_optpfor", "block_varint", "block_qmx",
                                  "block_mixed"])
def test_pruned_engine_on_cuda_equals_engine_on_cpu(cuda, coll, name):
    """The block-max metadata of the CUDA engine's decode pass and
    collection pass are byte-equal to the CPU engine's; the pruned
    ranked_and and wand give the CPU engine's results."""
    index = build(coll, name)
    c = BinaryFreqCollection(coll)
    wdata = WandData.build(read_sizes(coll), c)
    queries = read_queries(coll + ".queries")
    gpu = ResidentEngine(index, wdata, device=cuda)
    host = ResidentEngine(index, wdata, device=cuda)
    cpu = ResidentEngine(index, wdata, device="cpu")
    gpu._ensure_blockmax()
    host.build_blockmax(c)
    cpu._ensure_blockmax()
    for field in BLOCKMAX_FIELDS:
        np.testing.assert_array_equal(getattr(gpu, field), getattr(cpu, field), err_msg=field)
        np.testing.assert_array_equal(getattr(host, field), getattr(cpu, field), err_msg=field)
    assert gpu.ranked_and(queries, k=10, prune=True) == cpu.ranked_and(queries, k=10, prune=True)
    assert gpu.wand(queries, k=10) == cpu.wand(queries, k=10)


JOIN_PLANS = {
    "exhaustive": dict(ops=("and",)),
    "counts": dict(ops=("counts",), ranked=False),
    "or_counts": dict(ops=("counts", "or", "and")),
    "and_skip": dict(ops=("and",), prune=True),
    "wand": dict(ops=("or",), prune=True),
    "maxscore": dict(ops=("or",), prune="maxscore"),
}


def _join_plans(eng, queries, which, k=10):
    """The plan `which` of JOIN_PLANS and the probe sub-plans (f32
    downloads) its prepare ran."""
    seen = []
    dispatch = eng.dispatch
    eng.dispatch = lambda plan: (seen.append(plan), dispatch(plan))[1]
    try:
        plan = eng.prepare(queries, k=k, **JOIN_PLANS[which])
    finally:
        del eng.dispatch
    return [plan] + seen


def _assert_join_equal(got, exp):
    assert got.dtype == exp.dtype and got.shape == exp.shape
    view = torch.int16 if got.dtype == torch.float16 else torch.int32
    torch.testing.assert_close(got.view(view), exp.view(view), rtol=0, atol=0)


@pytest.mark.parametrize("which", list(JOIN_PLANS))
@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_join_kernel_matches_plain_on_every_part(cuda, coll, name, which):
    """K3 (join_part, csrc/join.cu) on every part of the plan and of its
    probe sub-plans (f32) against join_part_torch on the card, byte for
    byte, with one counted launch a part (at most 2); the same parts with
    every row searched in device memory (_stage=0), with CTA items of one
    driving entry (every row of more than a warp takes merging its items'
    lists in the launch) and, where the plan downloads f16, in f32 too.
    Queries here reach 32 terms (tmax 32) and k 128."""
    from ds2i_torch.ops.join import JoinLayout, join_part, join_part_torch

    wdata = WandData.build(read_sizes(coll), BinaryFreqCollection(coll))
    eng = ResidentEngine(build(coll, name), wdata, device=cuda, max_part_slots=1 << 13,
                         max_part_queries=32)
    queries = read_queries(coll + ".queries")
    long = [sum(queries[i:i + 10], []) for i in range(0, 40, 10)]
    nd = eng.num_docs
    eng._ensure_norm_cache()
    parts = 0
    for k, qs in ((10, queries), (128, queries[:20] + long)):
        for plan in _join_plans(eng, qs, which, k):
            eng.execute(plan)  # uploads the plan
            for p in plan["plans"]:
                gt, gf, bp = p["_dev"][eng.device][:3]
                ranked = "or" in p["ops"] or "and" in p["ops"]
                docs32, w32 = resident._decode_part(eng.state, gt, gf, bp, p["layout"], nd,
                                                    ranked)
                lay = p["join"]
                one = JoinLayout(lay.ent, lay.rows[:, 0], lay.rows[:, 1], lay.rows[:, 2], lay.qw,
                                 lay.buckets, lay.pack_idx, lay.k, lay.ops, lay.tmax, chunk=1)
                f16 = "counts" not in p["ops"] and p["fscale"] is not None
                for fetch16 in sorted({False, f16}):
                    fscale = p["fscale"] if fetch16 else None
                    exp = join_part_torch(docs32, w32, *lay.plain(eng.device), nd, p["k"],
                                          p["ops"], p["tmax"], fetch16, fscale)
                    for layout, stage in ((lay, 2048), (lay, 0), (one, 2048)):
                        before = join_part.launches
                        got = join_part(docs32, w32, layout, nd, fetch16, fscale, _stage=stage)
                        torch.cuda.synchronize()
                        n = join_part.launches - before
                        assert n == 1
                        _assert_join_equal(got, exp)
                parts += 1
    assert parts >= 4


# the kernel's paths over seeded rows: (chunk, _stage) of the kernel's own
# split, CTA items of one driving entry (every row of more than a warp
# takes merged by the last item to finish), items of three, and every row
# searched in device memory
JOIN_SPLITS = {
    "own": (None, 2048),
    "merged": (1, 2048),
    "items_of_3": (3, 2048),
    "device_memory": (None, 0),
}
JOIN_FORMS = {"and-10": (("and",), 10), "general-10": (("counts", "or", "and"), 10),
              "and-128": (("and",), 128), "general-128": (("counts", "or", "and"), 128)}


@pytest.mark.parametrize("form", list(JOIN_FORMS))
@pytest.mark.parametrize("kind", KINDS)
def test_join_kernel_on_seeded_rows(cuda, kind, form):
    """K3 on seeded rows of each kind the kernel treats apart (single-term
    rows, the shortest slot on top, empty slots, pads inside a slot's run,
    ties, 17-32 slots, rows longer than a CTA item), in the AND-only and
    the general form at k 10 (register top-k) and 128 (compacted
    candidates), under every split of JOIN_SPLITS: byte for byte against
    join_part_torch on the card (f32, and f16 on the kernel's own split),
    one launch (the long rows' merges in it), and each split reaching the path it is
    for."""
    from ds2i_torch.ops.join import CHUNK, WARP_DRIVE, WARP_K, join_part, join_part_torch

    ops, k = JOIN_FORMS[form]
    rng = np.random.RandomState(KINDS.index(kind) * 100 + k)
    rows, nd, equal = special_rows(kind, rng)
    tmax = 2
    while tmax < max(len(r) for r in rows):
        tmax *= 2
    docs, w, bdir, qwtab, tgt, row_ents = bucket_of(rows, tmax, nd, rng, equal)
    docs32 = torch.from_numpy(docs).to(cuda)
    w32 = torch.from_numpy(w).to(cuda)
    for split, (chunk, stage) in JOIN_SPLITS.items():
        lay = bucket_layout(bdir, qwtab, tgt, row_ents, k, ops, tmax, chunk=chunk or CHUNK)
        st = lay.structure()
        nd_cta = np.delete(lay.rows[:, 4], lay.wrows)  # the CTA rows' driving entries
        assert st["merged_rows"] == int((nd_cta > (chunk or CHUNK)).sum())
        if k <= WARP_K:  # the short rows on warps, the others on CTA items
            assert np.all(lay.rows[lay.wrows, 4] <= WARP_DRIVE)
            assert st["warp_rows"] > 0 or ops != ("and",)
        else:
            assert st["warp_rows"] == 0
        if kind == "long":  # rows longer than a warp takes, on CTA items
            assert st["cta_rows"] > 0
        for fetch16 in (False, True) if split == "own" else (False,):
            fscale = 4.0 if fetch16 else None
            exp = join_part_torch(docs32, w32, *lay.plain(cuda), nd, k, ops, tmax, fetch16,
                                  fscale)
            before = join_part.launches
            got = join_part(docs32, w32, lay, nd, fetch16, fscale, _stage=stage)
            torch.cuda.synchronize()
            assert join_part.launches - before == 1
            _assert_join_equal(got, exp)


def test_join_engine_on_cuda_equals_engine_on_cpu(cuda, coll):
    """Long queries (tmax 32) through the whole engine: the CUDA engine's
    counts and top-k scores equal the CPU engine's."""
    index = build(coll, "block_optpfor")
    wdata = WandData.build(read_sizes(coll), BinaryFreqCollection(coll))
    queries = read_queries(coll + ".queries")
    qs = [sum(queries[i:i + 10], []) for i in range(0, 60, 10)] + queries[:10]
    gpu = ResidentEngine(index, wdata, device=cuda)
    cpu = ResidentEngine(index, wdata, device="cpu")
    np.testing.assert_array_equal(gpu.or_counts(qs), cpu.or_counts(qs))
    assert gpu.ranked_or(qs, k=64) == cpu.ranked_or(qs, k=64)
    assert gpu.ranked_and(qs, k=1) == cpu.ranked_and(qs, k=1)


def test_join_wrapper_rejects_what_the_kernel_does_not_take(cuda, coll):
    from ds2i_torch.ops.join import JoinLayout, join_part

    eng = ResidentEngine(build(coll, "opt"), device=cuda)
    plan = eng.prepare(read_queries(coll + ".queries")[:8], k=10, ops=("and",))
    p = plan["plans"][0]
    eng.execute(plan)
    gt, gf, bp = p["_dev"][eng.device][:3]
    docs32, w32 = resident._decode_part(eng.state, gt, gf, bp, p["layout"], eng.num_docs, True)
    lay = p["join"]

    def relaid(**kw):
        args = dict(k=lay.k, ops=lay.ops, tmax=lay.tmax)
        args.update(kw)
        qw = np.zeros((lay.n_rows, args["tmax"]), np.float32)
        return JoinLayout(lay.ent, lay.rows[:, 0], lay.rows[:, 1], lay.rows[:, 2], qw,
                          lay.buckets, lay.pack_idx, **args)

    nd = eng.num_docs
    with pytest.raises(ValueError, match="tmax"):
        join_part(docs32, w32, relaid(tmax=64), nd, False, None)
    with pytest.raises(ValueError, match="k in"):
        join_part(docs32, w32, relaid(k=5000), nd, False, None)
    with pytest.raises(ValueError, match="w32"):
        join_part(docs32, w32.cpu(), lay, nd, False, None)
    with pytest.raises(ValueError, match="docs32"):
        join_part(docs32.long(), w32, lay, nd, False, None)
    with pytest.raises(ValueError, match="rows, 32"):
        join_part(docs32[:, :16].contiguous(), w32[:, :16].contiguous(), lay, nd, False, None)
    with pytest.raises(ValueError, match="names block"):
        join_part(docs32[:1].contiguous(), w32[:1].contiguous(), lay, nd, False, None)
    with pytest.raises(ValueError, match="fscale"):
        join_part(docs32, w32, lay, nd, True, None)


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_doc_sharded_on_cuda_equals_single_engine(cuda, coll, name):
    """DocShardedEngine, 3 shards on the card (devices=[cuda]), against
    the single CUDA engine: counts exact, top-10 within rtol 1e-3,
    pruned equal to exhaustive; every shard launches K3."""
    from ds2i_torch.ops.join import join_part
    from ds2i_torch.parallel import DocShardedEngine

    index = build(coll, name)
    wdata = WandData.build(read_sizes(coll), BinaryFreqCollection(coll))
    queries = read_queries(coll + ".queries")
    single = ResidentEngine(index, wdata, device=cuda)
    sharded = DocShardedEngine(index, wdata, num_shards=3, devices=[cuda])
    assert all(e.device == single.device for e in sharded.engines)
    np.testing.assert_array_equal(sharded.and_counts(queries), single.and_counts(queries))
    np.testing.assert_array_equal(sharded.or_counts(queries), single.or_counts(queries))
    before = join_part.launches
    exact_and = single.ranked_and(queries, k=10)
    exact_or = single.ranked_or(queries, k=10)
    for got, exp in ((sharded.ranked_and(queries, k=10), exact_and),
                     (sharded.ranked_and(queries, k=10, prune=True), exact_and),
                     (sharded.ranked_or(queries, k=10), exact_or),
                     (sharded.wand(queries, k=10), exact_or),
                     (sharded.maxscore(queries, k=10), exact_or)):
        for g, e in zip(got, exp):
            assert len(g) == len(e)
            if e:
                np.testing.assert_allclose(g, e, rtol=1e-3)
    assert join_part.launches > before


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_two_replicas_on_cuda_equal_one(cuda, coll, name):
    """ResidentEngine(devices=[cuda, cuda]): two copies of the state, the
    parts round-robin over them, results equal to one engine's."""
    index = build(coll, name)
    wdata = WandData.build(read_sizes(coll), BinaryFreqCollection(coll))
    queries = read_queries(coll + ".queries")
    single = ResidentEngine(index, wdata, device=cuda)
    two = ResidentEngine(index, wdata, devices=[cuda, cuda], max_part_queries=16)
    assert two._replicas[0].docs_words.data_ptr() != two._replicas[1].docs_words.data_ptr()
    assert len(two.prepare(queries, k=10, ops=("and",))["plans"]) >= 4
    assert two.ranked_and(queries, k=10) == single.ranked_and(queries, k=10)
    assert two.ranked_and(queries, k=10, prune=True) == single.ranked_and(queries, k=10,
                                                                          prune=True)
    np.testing.assert_array_equal(two.or_counts(queries), single.or_counts(queries))


@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_engine_cache_round_trip_on_cuda(cuda, coll, name, tmp_path):
    """cache_dir on the card: the second engine loads the tables, the norm
    cache, the block-max tables and the probe thresholds, launches K5
    (blockmax) and the norm cache's decode zero times, and gives the
    first engine's and_skip and wand results."""
    from ds2i_torch.ops import blockmax

    index = build(coll, name)
    c = BinaryFreqCollection(coll)
    wdata = WandData.build(read_sizes(coll), c)
    queries = read_queries(coll + ".queries")
    first = ResidentEngine(index, wdata, device=cuda, cache_dir=str(tmp_path))
    first.build_blockmax(c)
    exp = (first.ranked_and(queries, k=10, prune=True), first.wand(queries, k=10))
    second = ResidentEngine(index, wdata, device=cuda, cache_dir=str(tmp_path))
    k5, dec = blockmax.blockmax_rows.launches, sum(w.launches for w in (
        decode_pair, *WRAPPERS.values()))
    second._ensure_norm_cache()
    second.build_blockmax(c)
    plan = second.prepare(queries, k=10, ops=("and",), prune=True)
    assert plan["probe_rows"] == 0  # the thresholds came from the cache
    assert blockmax.blockmax_rows.launches == k5
    assert sum(w.launches for w in (decode_pair, *WRAPPERS.values())) == dec
    got = (second.collect(plan, second.dispatch(plan)), second.wand(queries, k=10))
    assert [second._topk_list(r[3]) for r in got[0]] == exp[0]
    assert got[1] == exp[1]
    for field in BLOCKMAX_FIELDS:
        np.testing.assert_array_equal(getattr(second, field), getattr(first, field),
                                      err_msg=field)
    _same_bits(second.state.den_blocks, first.state.den_blocks)
