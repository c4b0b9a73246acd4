"""The port's engine-state persistence (ResidentEngine(cache_dir=), the
JAX engine's cache_dir): a second engine over the same index loads its
tile tables, exception patches, norm cache, block-max tables and probe
thresholds from the files the first one saved, walks and decodes
nothing (the passes are replaced by raising stubs to show it), and
equals a cold engine's state and plans array for array; norm lengths
that differ give distinct keys; a JAX engine and a port engine share a
directory without either reading the other's files; a corrupt file
raises. device="cpu" (the plain PyTorch path).

About 25 s serially."""

import os

import numpy as np
import pytest

from ds2i_torch.engine import ResidentEngine, resident
from ds2i_torch.host import GlobalParameters as PortParams
from ds2i_torch.host import WandData, make_index_type

from test_torch_resident import _assert_topk_close, _plan_arrays

NQ = 32


def _lists(seed=6, num_docs=3000, nlists=60):
    """As tests/test_engine_cache.py: seeded lists, zipf-skewed freqs."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(50, 300, num_docs).astype(np.int64)
    lists = []
    for _ in range(nlists):
        n = int(rng.randint(1, 800))
        docs = np.sort(rng.choice(num_docs, size=n, replace=False)).astype(np.int64)
        freqs = (1 + rng.zipf(1.5, n) % 40).astype(np.int64)
        lists.append((docs, freqs))
    qs = [list(rng.choice(nlists, size=rng.randint(1, 4), replace=False)) for _ in range(NQ)]
    return num_docs, sizes, lists, qs


def _build(tname, make_type=make_index_type, params=PortParams, wand_data=WandData):
    num_docs, sizes, lists, qs = _lists()
    b = make_type(tname).builder(num_docs, params())
    for docs, freqs in lists:
        b.add_posting_list(len(docs), docs, freqs, int(freqs.sum()))
    return b.build(), wand_data.build(sizes, lists), lists, qs


@pytest.fixture(scope="module")
def built():
    return {name: _build(name) for name in ("block_optpfor", "ef", "opt")}


def _raise(*_, **__):
    raise AssertionError("a cache hit ran a pass it should have loaded")


def _no_passes(monkeypatch):
    """Every walk and device pass the cache replaces, made to raise."""
    for name in ("build_tile_tables", "build_block_tables", "build_exception_patches",
                 "_norm_cache_step", "_decode_slots_step"):
        monkeypatch.setattr(resident, name, _raise)
    monkeypatch.setattr(resident.blockmax, "blockmax_rows", _raise)
    monkeypatch.setattr(ResidentEngine, "_probe_theta", _raise)
    monkeypatch.setattr(ResidentEngine, "_and_prefix_probe", _raise)


def _warm_up(eng, lists, qs, from_collection):
    """The first engine's run: every cached piece computed and saved."""
    if from_collection:
        eng.build_blockmax(lists)
    return {"ranked_or": eng.ranked_or(qs, k=10), "wand": eng.wand(qs, k=10),
            "and_skip": eng.ranked_and(qs, k=10, prune=True), "and_counts": eng.and_counts(qs)}


@pytest.mark.parametrize("from_collection", [False, True])
@pytest.mark.parametrize("name", ["block_optpfor", "ef"])
def test_cache_roundtrip(built, tmp_path, monkeypatch, name, from_collection):
    """As tests/test_engine_cache.py's round trips: the second start hits
    every file, runs no pass, and answers as the first; its tile tables
    equal a cacheless engine's."""
    idx, wd, lists, qs = built[name]
    cold = ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path))
    exp = _warm_up(cold, lists, qs, from_collection)
    with monkeypatch.context() as m:
        _no_passes(m)
        warm = ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path))
        assert warm._cache_load("tables") is not None
        assert warm._cache_load("norms", with_norms=True) is not None
        assert warm._cache_load("blockmax", with_norms=True) is not None
        if from_collection:
            warm.build_blockmax(lists)  # a hit: no planes pass
        got = _warm_up(warm, lists, qs, False)
    np.testing.assert_array_equal(got.pop("and_counts"), exp.pop("and_counts"))
    for op in exp:
        _assert_topk_close(got[op], exp[op], qs)
    plain = ResidentEngine(idx, wd, device="cpu")
    for field in ("tiles_docs", "tiles_freqs", "docs_words"):
        np.testing.assert_array_equal(getattr(warm.state, field).numpy(),
                                      getattr(plain.state, field).numpy())


@pytest.mark.parametrize("name", ["block_optpfor", "opt"])
def test_cached_state_equals_cold_engine(built, tmp_path, name):
    """A cached engine's norm cache, block-max tables (and every planner
    table derived from them), probe thresholds and plans equal a cold,
    cacheless engine's."""
    idx, wd, lists, qs = built[name]
    _warm_up(ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path)), lists, qs, False)
    warm = ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path))
    cold = ResidentEngine(idx, wd, device="cpu")
    for eng in (warm, cold):
        eng._ensure_norm_cache()
        eng._ensure_blockmax()
    for field in ("den_blocks", "tile_gblk0"):
        np.testing.assert_array_equal(getattr(warm.state, field).numpy(),
                                      getattr(cold.state, field).numpy(), err_msg=field)
    for field in ResidentEngine.BLOCKMAX_CACHED + (
            "_short_stride", "_blk_dlo", "_dmax_keys", "_dlo_keys", "_pyr", "_pyr_off",
            "_pyr_q"):
        a, b = np.asarray(getattr(warm, field)), np.asarray(getattr(cold, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    # the thresholds: each cached file against the cold engine's probe
    terms, qw, counts = cold._prep_terms(qs, True)
    span_row = np.repeat(np.arange(len(counts)), counts)
    tmax = max(2, 1 << (int(counts.max()) - 1).bit_length())
    pdir = cold._pruned_directory(terms, qw, counts, 10, span_row, probe_rank=2)
    theta_or = cold._probe_theta(pdir, terms, qw, counts, 10, tmax, "or")
    dir0 = cold._pruned_directory(terms, qw, counts, 10, span_row, mode="and")
    theta_and = cold._and_prefix_probe(dir0, terms, qw, counts, 10, tmax)
    if theta_and is None:
        theta_and = np.full(len(counts), -np.inf)
    for mode, exp in (("or", theta_or), ("and", theta_and)):
        got = warm._cache_load(warm._theta_key(terms, qw, counts, 10, mode), with_norms=True)
        np.testing.assert_array_equal(got["theta"], exp, err_msg=mode)
    for ops, prune in ((("and",), False), (("and",), True), (("or",), True), (("or",), "maxscore")):
        assert (_plan_arrays(warm.prepare(qs, k=10, ops=ops, prune=prune))
                == _plan_arrays(cold.prepare(qs, k=10, ops=ops, prune=prune))), (ops, prune)


def test_cache_distinguishes_norm_lens(built, tmp_path):
    """As tests/test_engine_cache.py: other norm lengths, another key for
    the pieces that depend on them; the index's own pieces are shared."""
    idx, wd, _, _ = built["ef"]
    e1 = ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path))
    e1.wand([[0, 1]], k=5)
    e2 = ResidentEngine(idx, None, device="cpu", cache_dir=str(tmp_path))
    assert e2._cache_path("blockmax", with_norms=True) != e1._cache_path("blockmax",
                                                                         with_norms=True)
    assert e2._cache_load("blockmax", with_norms=True) is None
    assert e2._cache_load("norms", with_norms=True) is None
    assert e2._cache_path("tables") == e1._cache_path("tables")


def test_jax_and_port_engines_share_a_directory(built, tmp_path):
    """The JAX engine's files and the port's lie side by side: neither
    engine finds the other's, and each finds its own on a second start."""
    from ds2i_tpu import GlobalParameters as RefParams
    from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine
    from ds2i_tpu.index.types import make_index_type as ref_index_type
    from ds2i_tpu.queries.wand_data import WandData as RefWandData

    d = str(tmp_path)
    ref_idx, ref_wd, lists, qs = _build("block_optpfor", ref_index_type, RefParams, RefWandData)
    jax_eng = JaxResidentEngine(ref_idx, ref_wd, cache_dir=d)
    jax_eng._ensure_norm_cache()
    jax_eng.build_blockmax(lists)
    jax_files = set(os.listdir(d))
    assert {"tables", "expatch", "norms", "blockmax"} <= {f.rsplit("_", 1)[1][:-4]
                                                           for f in jax_files}

    idx, wd, _, _ = built["block_optpfor"]
    port = ResidentEngine(idx, wd, device="cpu", cache_dir=d)  # walks, saves its own
    assert len(set(os.listdir(d)) - jax_files) == 2
    for part in ("norms", "blockmax"):
        assert port._cache_load(part, with_norms=True) is None, part
    port._ensure_norm_cache()
    port.build_blockmax(lists)
    port_files = set(os.listdir(d)) - jax_files
    assert len(port_files) == 4 and all(f.startswith("torch_") for f in port_files)
    assert not any(f.startswith("torch_") for f in jax_files)

    again = JaxResidentEngine(ref_idx, ref_wd, cache_dir=d)
    assert again._cache_load("blockmax", with_norms=True) is not None
    assert ResidentEngine(idx, wd, device="cpu", cache_dir=d)._cache_load(
        "blockmax", with_norms=True) is not None
    _assert_topk_close(port.ranked_and(qs, k=10, prune=True), port.ranked_and(qs, k=10), qs)


@pytest.mark.parametrize("damage", ["truncate", "garbage", "missing_field"])
def test_corrupt_file_raises(built, tmp_path, damage):
    """A cache file that cannot be read whole raises; it is not rebuilt
    over in silence. A missing file is a miss."""
    idx, wd, lists, qs = built["block_optpfor"]
    eng = ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path))
    eng.build_blockmax(lists)
    for part, with_norms in (("tables", False), ("blockmax", True)):
        path = eng._cache_path(part, with_norms)
        if damage == "truncate":
            data = open(path, "rb").read()
            open(path, "wb").write(data[: len(data) // 2])
        elif damage == "garbage":
            open(path, "wb").write(b"not an npz file")
        else:
            arrays = dict(np.load(path))
            arrays.pop(sorted(arrays)[0])
            np.savez(path, **arrays)
    with pytest.raises(RuntimeError, match="engine cache file .*tables"):
        ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path))
    os.remove(eng._cache_path("tables"))
    second = ResidentEngine(idx, wd, device="cpu", cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="engine cache file .*blockmax"):
        second.build_blockmax(lists)
