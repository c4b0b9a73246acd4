"""The port's own copies of the host layers (ds2i_torch.{io, index,
queries, native, ...}) against the originals in ds2i_tpu: the same
collection files byte for byte, word-for-word equal indexes of every
index type the port serves (block_mixed made by each package's
rebuild_mixed), equal decoded lists, equal WandData, equal oracle
answers, the hybrid pipeline (the out-of-core lambda sort, the
lambda frontiers, the greedy trade-off) choosing alike, the sequence
collection's frozen bytes, the block profiler's dump, and the explicit
native build writing where the loader does. The
helpers here build one index per package from one collection; the other
port tests use them, so each engine gets an index of its own package."""

import os

import numpy as np
import pytest

import ds2i_tpu.native as ref_native
from ds2i_tpu import GlobalParameters as RefParams
from ds2i_tpu.codecs.time_prediction import Predictor as RefPredictor
from ds2i_tpu.config import Configuration as RefConfiguration
from ds2i_tpu.index.hybrid import LAMBDA_DTYPE as REF_LAMBDA_DTYPE
from ds2i_tpu.index.hybrid import compute_lambdas as ref_compute_lambdas
from ds2i_tpu.index.hybrid import greedy_tradeoff as ref_greedy_tradeoff
from ds2i_tpu.index.hybrid import rebuild_mixed as ref_rebuild_mixed
from ds2i_tpu.index.types import make_index_type as ref_index_type
from ds2i_tpu.io import BinaryFreqCollection as RefCollection
from ds2i_tpu.io import generate_collection as ref_generate
from ds2i_tpu.io import read_sizes as ref_sizes
from ds2i_tpu import queries as ref_queries
from ds2i_tpu.utils.extsort import external_sort_to_file as ref_external_sort

import ds2i_torch.native as port_native
from ds2i_torch import host as port_host
from ds2i_torch import queries as port_queries
from ds2i_torch.codecs.time_prediction import Predictor as PortPredictor
from ds2i_torch.config import Configuration as PortConfiguration
from ds2i_torch.index import hybrid as port_hybrid
from ds2i_torch.utils.extsort import external_sort_to_file as port_external_sort


SERVED_TYPES = ["ef", "single", "uniform", "opt", "block_optpfor", "block_varint",
                "block_interpolative", "block_qmx", "block_mixed"]

_PKGS = {
    "ref": (ref_index_type, RefParams, RefCollection, ref_sizes, ref_queries.WandData,
            ref_rebuild_mixed),
    "port": (port_host.make_index_type, port_host.GlobalParameters,
             port_host.BinaryFreqCollection, port_host.read_sizes, port_host.WandData,
             port_host.rebuild_mixed),
}


def build_index(coll, name, pkg):
    """`name` index of collection `coll`, built by ds2i_tpu (pkg="ref")
    or by the port's copy (pkg="port"). block_mixed is the package's
    rebuild_mixed over its block_optpfor index, each stream's codec drawn
    by the port's mixed_choices (PFOR streams keep their b, so exceptions
    occur)."""
    make_type, params, collection, _, _, rebuild_mixed = _PKGS[pkg]
    c = collection(coll)
    b = make_type("block_optpfor" if name == "block_mixed" else name).builder(
        c.num_docs, params())
    for docs, freqs in c:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
    index = b.build()
    if name == "block_mixed":
        index = rebuild_mixed(index, *port_hybrid.mixed_choices(index))
    return index


def build_wdata(coll, pkg):
    _, _, collection, sizes, wand_data, _ = _PKGS[pkg]
    return wand_data.build(sizes(coll), collection(coll))


def assert_same_walk():
    """Both packages take the same block-table walk (native where the
    library loads, else Python): they number group statics differently,
    so plan arrays compare only within one walk."""
    assert ref_native.available() == port_native.available(), (
        "ds2i_tpu and ds2i_torch take different table walks (one native "
        "library loads, the other does not); their plans are not comparable")


def _assert_tree_equal(got, exp, path="index"):
    if isinstance(exp, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(exp), path
        for key in exp:
            _assert_tree_equal(got[key], exp[key], f"{path}.{key}")
    elif isinstance(exp, (list, tuple)):
        assert len(got) == len(exp), path
        for i, (g, e) in enumerate(zip(got, exp)):
            _assert_tree_equal(g, e, f"{path}[{i}]")
    elif isinstance(exp, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == exp.dtype, path
        np.testing.assert_array_equal(got, exp, err_msg=path)
    else:
        assert got == exp, path


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    ref_generate(base, num_docs=600, num_terms=900, postings_target=20_000,
                 num_queries=40, max_query_len=4)
    return base


def test_generate_collection_is_byte_equal(tmp_path):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(num_docs=300, num_terms=400, postings_target=6_000, num_queries=10, seed=7)
    ref_generate(a, **kw)
    port_host.generate_collection(b, **kw)
    names = sorted(f for f in os.listdir(tmp_path) if f.startswith("ref"))
    assert names
    for f in names:
        with open(tmp_path / f, "rb") as x, open(tmp_path / ("port" + f[3:]), "rb") as y:
            assert x.read() == y.read(), f


@pytest.mark.parametrize("name", SERVED_TYPES)
def test_index_words_and_lists_equal(coll, name):
    assert_same_walk()
    ref, port = build_index(coll, name, "ref"), build_index(coll, name, "port")
    assert type(port).__module__.startswith("ds2i_torch.")
    _assert_tree_equal(port.tree(), ref.tree())
    assert port.size() == ref.size() and port.num_docs() == ref.num_docs()
    for li in range(ref.size()):
        (gd, gf), (ed, ef) = port.decode_list(li), ref.decode_list(li)
        np.testing.assert_array_equal(gd, ed, err_msg=f"docs of list {li}")
        np.testing.assert_array_equal(gf, ef, err_msg=f"freqs of list {li}")


def test_wand_data_equal(coll):
    got, exp = build_wdata(coll, "port"), build_wdata(coll, "ref")
    for key in ("norm_lens", "max_term_weight"):
        g, e = getattr(got, key), getattr(exp, key)
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e, err_msg=key)


@pytest.mark.parametrize("op", ["and_query", "or_query", "ranked_and_query", "ranked_or_query"])
def test_oracle_equal(coll, op):
    ref_idx, port_idx = build_index(coll, "opt", "ref"), build_index(coll, "opt", "port")
    ref_w, port_w = build_wdata(coll, "ref"), build_wdata(coll, "port")
    qs = ref_queries.read_queries(coll + ".queries")
    assert port_queries.read_queries(coll + ".queries") == qs
    for q in qs:
        if op in ("and_query", "or_query"):
            got, exp = getattr(port_queries, op)(port_idx, q), getattr(ref_queries, op)(ref_idx, q)
        else:
            got = getattr(port_queries, op)(port_idx, port_w, q, 10)
            exp = getattr(ref_queries, op)(ref_idx, ref_w, q, 10)
        assert got == exp, (op, q)


def test_rebuild_mixed_is_byte_equal(coll):
    """Both packages' rebuild_mixed, given the same types and params (the
    JAX engine test's: a fixed b = 10 for every PFOR stream), give equal
    indexes, and the lists decode as the block_optpfor index's."""
    ref_opt, port_opt = build_index(coll, "block_optpfor", "ref"), build_index(coll, "block_optpfor", "port")
    nb = sum(len(port_opt.get_blocks(li)) for li in range(port_opt.size()))
    types = np.random.RandomState(2).choice([0, 1, 2], size=2 * nb)
    params = np.where(types == 0, 10, 0)
    ref, port = ref_rebuild_mixed(ref_opt, types, params), port_host.rebuild_mixed(port_opt, types, params)
    assert type(port).__module__.startswith("ds2i_torch.") and port.index_type_name == "block_mixed"
    _assert_tree_equal(port.tree(), ref.tree())
    for li in range(port.size()):
        for got, exp in zip(port.decode_list(li), port_opt.decode_list(li)):
            np.testing.assert_array_equal(got, exp, err_msg=f"list {li}")


def test_greedy_tradeoff_same_choices(coll, capsys):
    """greedy_tradeoff over one lambda-sorted array: the same (type, param)
    per block from both packages, under budgets that stop the sweep part
    way and one that takes every point, and report-only mode (budget 0)."""
    ref_idx, port_idx = build_index(coll, "block_optpfor", "ref"), build_index(coll, "block_optpfor", "port")
    assert port_hybrid.LAMBDA_DTYPE == REF_LAMBDA_DTYPE
    nb = 2 * sum(len(port_idx.get_blocks(li)) for li in range(port_idx.size()))
    rng = np.random.RandomState(5)
    lam = np.zeros(3 * nb, dtype=port_hybrid.LAMBDA_DTYPE)
    lam["block_id"] = np.tile(np.arange(nb), 3)
    lam["lambda"] = np.concatenate([np.zeros(nb), rng.rand(2 * nb) + 0.01])
    lam["time"] = rng.rand(3 * nb) * 100
    lam["space"] = rng.randint(20, 400, 3 * nb)
    lam["type"] = rng.randint(0, 3, 3 * nb)
    lam["param"] = np.where(lam["type"] == 0, rng.randint(0, 17, 3 * nb), 0)
    lam = lam[np.argsort(lam["lambda"], kind="stable")]
    picks = []
    for budget in [1 << k for k in range(14, 26)] + [1 << 40]:
        got = port_hybrid.greedy_tradeoff(port_idx, lam, budget)
        exp = ref_greedy_tradeoff(ref_idx, lam, budget)
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)
        picks.append(got[0])
    # some budget stopped the sweep part way
    assert any(not np.array_equal(p, picks[-1]) for p in picks[:-1])
    assert port_hybrid.greedy_tradeoff(port_idx, lam, 0) is None
    capsys.readouterr()


def _random_lambdas(rng, n):
    a = np.zeros(n, dtype=port_hybrid.LAMBDA_DTYPE)
    a["block_id"] = rng.integers(0, max(n // 2, 1) + 1, n)
    a["lambda"] = rng.integers(0, 7, n).astype(np.float32) / 4  # few keys: many ties
    a["time"] = rng.random(n).astype(np.float32)
    a["space"] = rng.integers(0, 1 << 16, n)
    a["type"] = rng.integers(0, 3, n)
    a["param"] = rng.integers(0, 16, n)
    return a


@pytest.mark.parametrize("n,budget", [(0, 1 << 20), (1000, 1 << 20), (20000, 4096), (60000, 1 << 14)])
def test_external_sort_is_byte_equal(tmp_path, n, budget):
    """The out-of-core sort, one run or many spilled and merged (the small
    budgets), writes the same .npy as ds2i_tpu's, in stable key order."""
    a = _random_lambdas(np.random.default_rng(n), n)
    paths = {}
    for pkg, sort in (("ref", ref_external_sort), ("port", port_external_sort)):
        paths[pkg] = str(tmp_path / f"{pkg}.bin")
        chunks = np.array_split(a, 7) if n else [a]
        assert sort(chunks, port_hybrid.LAMBDA_DTYPE, "lambda", paths[pkg], budget) == n
    with open(paths["ref"], "rb") as x, open(paths["port"], "rb") as y:
        assert x.read() == y.read()
    got = np.load(paths["port"], mmap_mode="r")
    np.testing.assert_array_equal(np.asarray(got), a[np.argsort(a["lambda"], kind="stable")])


def test_compute_lambdas_is_equal(tmp_path, monkeypatch, capsys):
    """compute_lambdas over the same block_optpfor lists, predictors and
    block counts (one list without counts, some blocks at zero): the same
    lambda frontiers as ds2i_tpu's, reloaded from the checkpoint as
    computed, and the same greedy choices from them under a budget
    between the least and the greatest space."""
    monkeypatch.setenv("DS2I_SORT_BUDGET", "8192")
    RefConfiguration.reset()
    PortConfiguration.reset()
    try:
        rng = np.random.default_rng(7)
        lists = []
        for _ in range(40):
            n = int(rng.integers(100, 400))
            lists.append((np.sort(rng.choice(2000, size=n, replace=False)).astype(np.uint32),
                          rng.integers(1, 5, n).astype(np.uint32)))
        counts = {li: rng.integers(0, 3, 2 * -(-len(d) // 128)).tolist()
                  for li, (d, _) in enumerate(lists) if li != 3}
        # one predictor a block type (PFOR, VARINT, INTERPOLATIVE): the
        # smaller codes decode slower, so each block has a frontier
        coefs = [[("bias", 1.0), ("size", 0.1)], [("bias", 3.0), ("nonzeros", 0.05)],
                 [("bias", 8.0), ("size", 0.3), ("entropy", 0.01)]]
        out = {}
        for pkg, predictor, compute, greedy in (
                ("ref", RefPredictor, ref_compute_lambdas, ref_greedy_tradeoff),
                ("port", PortPredictor, port_hybrid.compute_lambdas, port_hybrid.greedy_tradeoff)):
            make_type, params = _PKGS[pkg][:2]
            b = make_type("block_optpfor").builder(2000, params())
            for docs, freqs in lists:
                b.add_posting_list(len(docs), docs, freqs)
            idx = b.build()
            path = str(tmp_path / f"{pkg}.bin")
            lam = compute(idx, [predictor(c) for c in coefs], counts, path)
            np.testing.assert_array_equal(np.asarray(compute(idx, None, None, path)), np.asarray(lam))
            out[pkg] = (np.asarray(lam), greedy(idx, lam, budget=10_500))
        (lam, (types, params)), (elam, (etypes, eparams)) = out["port"], out["ref"]
        assert len(lam) > len(types) > 0 and np.all(lam["lambda"][:-1] <= lam["lambda"][1:])
        np.testing.assert_array_equal(lam, elam)
        np.testing.assert_array_equal(types, etypes)
        np.testing.assert_array_equal(params, eparams)
    finally:
        RefConfiguration.reset()
        PortConfiguration.reset()
    capsys.readouterr()


def test_sequence_collection_is_byte_equal(tmp_path):
    """The port's SequenceCollection over its IndexedSequence: the same
    frozen bytes as ds2i_tpu's on the same sequences
    (tests/test_sequence_collection.py's), and each sequence decodes and
    enumerates back from the loaded file."""
    from ds2i_tpu.index import freeze as ref_freeze
    from ds2i_tpu.index.sequence_collection import SequenceCollection as RefSeqColl
    from ds2i_tpu.sequences import IndexedSequence as RefIndexed

    from ds2i_torch.index import freeze, load
    from ds2i_torch.index.sequence_collection import SequenceCollection
    from ds2i_torch.sequences import IndexedSequence

    rng = np.random.RandomState(2)
    port_b = SequenceCollection.builder(IndexedSequence, port_host.GlobalParameters())
    ref_b = RefSeqColl.builder(RefIndexed, RefParams())
    seqs = []
    for _ in range(15):
        n = int(rng.randint(1, 300))
        universe = int(rng.randint(n + 1, n * 20 + 2))
        v = np.sort(rng.choice(universe, size=n, replace=False)).astype(np.uint64)
        seqs.append(v)
        port_b.add_sequence(v, universe)
        ref_b.add_sequence(v, universe)
    coll = port_b.build()
    assert coll.size() == 15
    freeze(coll.tree(), tmp_path / "port.bin")
    ref_freeze(ref_b.build().tree(), tmp_path / "ref.bin")
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    loaded = SequenceCollection.from_tree(IndexedSequence, load(tmp_path / "port.bin"))
    for i, v in enumerate(seqs):
        np.testing.assert_array_equal(loaded.decode(i), v)
        assert loaded.enumerator(i).move(len(v) - 1) == (len(v) - 1, int(v[-1]))


def test_block_profiler_dumps_as_the_original():
    """BlockProfiler: the same counts (open_list, count_list with and
    without freqs) dump the same TSV as ds2i_tpu's."""
    import io

    from ds2i_tpu.utils.block_profiler import BlockProfiler as RefProfiler

    from ds2i_torch.codecs.optpfor import OptPForBlock
    from ds2i_torch.utils.block_profiler import BlockProfiler

    out = []
    for prof in (BlockProfiler(), RefProfiler()):
        prof.open_list(7, 3)[:] = 2
        prof.count_list(3, OptPForBlock, n=300)
        prof.count_list(3, OptPForBlock, n=300, with_freqs=False)
        prof.count_list(5, OptPForBlock)  # no length: nothing counted
        s = io.StringIO()
        prof.dump(s)
        out.append(s.getvalue())
    assert out[0] == out[1] == "3\t2 1 2 1 2 1\n7\t2 2 2 2 2 2\n"


@pytest.mark.parametrize("sanitize", [False, True])
def test_native_build_writes_under_build_not_the_package(monkeypatch, sanitize):
    """native/build.py g++-builds ds2i_native.cpp with the loader's flags
    (plus AddressSanitizer's for --sanitize) into build/ds2i_torch/ at the
    repository root: the loader's own path, or its asan twin, never the
    package directory."""
    import subprocess

    from ds2i_torch.native import build as native_build

    calls = []

    def fake_run(cmd, check, timeout):
        calls.append(cmd)
        open(cmd[-1], "wb").close()

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(native_build.os, "replace", lambda a, b: calls.append(("replace", a, b)))
    try:
        out = native_build.build(verbose=False, sanitize=sanitize)
    finally:
        for c in calls:
            if c[0] != "replace" and os.path.exists(c[-1]):
                os.remove(c[-1])
    (cmd, (_, tmp, dst)) = calls
    assert dst == out and tmp == cmd[-1] and os.path.dirname(out) == port_native.BUILD_DIR
    assert port_native.BUILD_DIR.endswith(os.path.join("build", "ds2i_torch"))
    assert cmd[0] == "g++" and cmd[1:1 + len(port_native.GXX_FLAGS)] == port_native.GXX_FLAGS
    assert ("-fsanitize=address" in cmd) == sanitize
    if sanitize:
        assert os.path.basename(out).startswith("libds2i_native_asan_")
    else:
        assert out == port_native.lib_path()
    assert not out.startswith(os.path.dirname(port_native.__file__))
