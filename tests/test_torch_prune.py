"""The port's block-max pruned planning and ops (ResidentEngine.
_pruned_directory, _and_prefix_probe, prepare(prune=...), ranked_and
(prune=True), wand, maxscore; device="cpu", the plain PyTorch path)
against the JAX engine's and against the port's exhaustive ops, on the
zipf-skewed lists of tests/test_torch_blockmax.py: directories exactly
when both engines are given the same threshold (the final AND
directory's row-restricted form, _refine_and_directory, exactly as the
port's call over the whole batch), probe thresholds within
rtol 1e-6, plan arrays exactly, pruned top-k results equal to the
exhaustive ones (equal lengths, scores within rtol 1e-3)."""

import gc

import jax
import numpy as np
import pytest

from ds2i_tpu.engine import ResidentEngine as JaxResidentEngine

from ds2i_torch.engine import ResidentEngine

from test_torch_blockmax import build_skewed
from test_torch_host_copy import assert_same_walk
from test_torch_resident import _assert_topk_close, _plan_arrays


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """As in tests/test_torch_blockmax.py: release each test's JAX
    executables before the next test compiles its own."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def skewed():
    """block_optpfor over the skewed lists: (data, port engine, JAX
    engine), both with their metadata from the collection pass."""
    assert_same_walk()
    d = build_skewed("block_optpfor", seed=11, num_docs=2000, nterms=60, nqueries=20)
    port = ResidentEngine(*d.port, device="cpu")
    port.build_blockmax(d.lists)
    ref = JaxResidentEngine(*d.ref)
    ref.build_blockmax(d.lists)
    return d, port, ref


def _batch(eng, qs, k=10):
    """(terms, qw, counts, span_row, tmax) of a ranked batch, as prepare
    parses it."""
    terms, qw, counts = eng._prep_terms(qs, True)
    span_row = np.repeat(np.arange(len(counts)), counts)
    tmax = max(2, 1 << (int(counts.max()) - 1).bit_length())
    return terms, qw, counts, span_row, tmax


def _assert_dirs_equal(got, exp):
    assert len(got) == len(exp) == 4
    for name, g, e in zip(("gblk_kept", "span_kept", "row_of_blk", "row_nb"), got, exp):
        assert np.asarray(g).dtype == np.asarray(e).dtype, name
        np.testing.assert_array_equal(g, e, err_msg=name)


@pytest.mark.parametrize("case", ["and", "and_theta", "or", "probe", "essential"])
def test_directory_matches_jax(skewed, case):
    """Every branch of _pruned_directory equals the JAX engine's, the
    same thresholds given to both: AND overlap and fixpoint alone, and
    with a per-row theta (some rows -inf); the static-theta OR; the
    WAND probe's top blocks; MaxScore's essential restriction."""
    d, port, ref = skewed
    terms, qw, counts, span_row, _ = _batch(port, d.qs)
    rterms, rqw, rcounts = ref._prep_terms(d.qs, True)
    np.testing.assert_array_equal(terms, rterms)
    np.testing.assert_array_equal(qw, rqw)
    kw = {}
    if case.startswith("and"):
        kw["mode"] = "and"
    if case == "and_theta":
        qwsum = np.bincount(span_row, weights=qw.astype(np.float64), minlength=len(counts))
        theta = 0.45 * qwsum
        theta[::3] = -np.inf
        kw["theta_override"] = theta
    elif case == "probe":
        kw["probe_rank"] = 2
    elif case == "essential":
        kw["essential"] = True
    got = port._pruned_directory(terms, qw, counts, 10, span_row, **kw)
    exp = ref._pruned_directory(terms, qw, counts, 10, span_row, **kw)
    _assert_dirs_equal(got, exp)
    full = port.list_blocks[terms].sum()
    assert 0 < len(got[0]) < full  # it prunes, and keeps something


def test_split_parts_match_jax(skewed):
    """A small slot budget splits the pruned directory into several
    parts, sliced as the JAX engine slices it."""
    d, port, ref = skewed
    terms, qw, counts, span_row, _ = _batch(port, d.qs)
    full = port._pruned_directory(terms, qw, counts, 10, span_row, mode="and")
    port.max_part_slots, ref.max_part_slots = 1 << 12, 1 << 12
    try:
        got = list(port._split_parts(full, counts))
        exp = list(ref._split_parts(full, counts))
    finally:
        port.max_part_slots = ref.max_part_slots = 1 << 21
    assert len(got) == len(exp) > 2
    for (g0, g1, gd), (e0, e1, ed) in zip(got, exp):
        assert (g0, g1) == (e0, e1)
        _assert_dirs_equal(gd, ed)


def test_and_prefix_probe_matches_jax(skewed):
    """The AND probe runs on the heavy rows (more than 128 kept blocks)
    and finds finite thresholds; they equal the JAX engine's within rtol
    1e-6."""
    d, port, ref = skewed
    terms, qw, counts, span_row, tmax = _batch(port, d.qs)
    dir0 = port._pruned_directory(terms, qw, counts, 10, span_row, mode="and")
    assert np.any(dir0[3] > port.AND_PROBE_MIN_BLOCKS)
    tally = {"probe_rows": 0}
    got = port._and_prefix_probe(dir0, terms, qw, counts, 10, tmax, tally)
    exp = ref._and_prefix_probe(dir0, terms, qw, counts, 10, tmax)
    # the probe ran the heavy rows
    assert 0 < tally["probe_rows"] <= int(np.sum(dir0[3] > port.AND_PROBE_MIN_BLOCKS))
    assert got is not None and exp is not None
    assert np.array_equal(np.isfinite(got), np.isfinite(exp))
    assert np.isfinite(got).sum() >= 1
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], exp[fin], rtol=1e-6)


@pytest.mark.parametrize("rounds", ["engine", 1])
def test_refined_and_directory_equals_the_full_call(skewed, monkeypatch, rounds):
    """The final AND directory from dir0 with only the rows of a finite
    theta recomputed (_refine_and_directory) equals _pruned_directory
    with that theta over the whole batch, array by array: the probe's
    thresholds, each third row's median entry bound, and one row's;
    with the engine's fixpoint rounds and with one, which cuts the
    fixpoint of some rows, thresholded ones among them. The batch is the fixture's
    queries and 1,000 seeded ones over its terms. An all -inf theta
    recomputes no row and gives dir0 back, as the full call does."""
    d, port, _ = skewed
    rng = np.random.RandomState(5)
    qs = list(d.qs) + [list(rng.choice(len(d.lists), size=rng.randint(2, 6), replace=False))
                       for _ in range(1000)]
    terms, qw, counts, span_row, tmax = _batch(port, qs)
    dir0 = port._pruned_directory(terms, qw, counts, 10, span_row, mode="and")
    ub = port._entry_score_ub(np.clip(terms, 0, None), qw, terms < 0, counts, span_row, dir0[1],
                              dir0[0])
    every_third = np.full(len(counts), -np.inf)
    for r in np.nonzero(dir0[3])[0][::3]:
        every_third[r] = np.median(ub[dir0[2] == r])
    one_row = np.full(len(counts), -np.inf)
    heavy = int(np.argmax(dir0[3]))
    one_row[heavy] = np.median(ub[dir0[2] == heavy])
    full = port._pruned_directory(terms, qw, counts, 10, span_row, theta_override=every_third,
                                  mode="and")
    if rounds == 1:
        monkeypatch.setattr(port, "AND_FIXPOINT_ROUNDS", 1)
        dir0 = port._pruned_directory(terms, qw, counts, 10, span_row, mode="and")
        capped = port._pruned_directory(terms, qw, counts, 10, span_row,
                                        theta_override=every_third, mode="and")
        cut = np.nonzero(capped[3] != full[3])[0]
        assert np.isfinite(every_third[cut]).any()  # a thresholded row stops short
    probe = port._and_prefix_probe(dir0, terms, qw, counts, 10, tmax, {"probe_rows": 0})
    assert probe is not None and 0 < np.isfinite(probe).sum() < len(counts)
    for theta in (probe, every_third, one_row):
        got, refined = port._refine_and_directory(dir0, terms, qw, counts, 10, theta)
        exp = port._pruned_directory(terms, qw, counts, 10, span_row, theta_override=theta,
                                     mode="and")
        _assert_dirs_equal(got, exp)
        assert refined == np.isfinite(theta).sum()
        if theta is not probe:
            assert len(got[0]) < len(dir0[0])  # the thresholds drop blocks
    none = np.full(len(counts), -np.inf)
    got, refined = port._refine_and_directory(dir0, terms, qw, counts, 10, none)
    assert refined == 0
    _assert_dirs_equal(got, dir0)
    _assert_dirs_equal(port._pruned_directory(terms, qw, counts, 10, span_row,
                                              theta_override=none, mode="and"), dir0)


@pytest.mark.parametrize("ops", [("and",), ("or",)])
def test_prepare_plan_arrays_match_jax(skewed, ops):
    """prepare(prune=True): probe, directory, parts; every plan array
    equals the JAX engine's. The AND plan's probe ran on heavy rows."""
    d, port, ref = skewed
    got = port.prepare(d.qs, k=10, ops=ops, prune=True)
    exp = ref.prepare(d.qs, k=10, ops=ops, prune=True)
    assert _plan_arrays(got) == _plan_arrays(exp)
    c = got["counts"]
    assert c["probe_rows"] > 0
    # the plan's counts: pruning kept some of the terms' blocks, the parts
    # decode them, and nothing is uploaded before dispatch
    assert 0 < c["dir_kept"] < c["dir_blocks"] == int(port._term_blocks(_batch(port, d.qs)[0]).sum())
    assert c["decode_blocks"] > 0 and c["upload_bytes"] == 0


@pytest.mark.parametrize("tname", ["ef", "opt", "block_optpfor", "block_interpolative"])
def test_ranked_and_prune_matches_exhaustive_and_jax(tname):
    """and_skip: the pruned ranked_and equals the port's exhaustive
    ranked_and and the JAX engine's pruned op (equal lengths, rtol
    1e-3), with the AND probe's threshold finite on a heavy row."""
    d = build_skewed(tname, seed=11, num_docs=2000, nterms=60, nqueries=6)
    port = ResidentEngine(*d.port, device="cpu")
    port.build_blockmax(d.lists)
    ref = JaxResidentEngine(*d.ref)
    ref.build_blockmax(d.lists)
    terms, qw, counts, span_row, tmax = _batch(port, d.qs)
    dir0 = port._pruned_directory(terms, qw, counts, 10, span_row, mode="and")
    theta = port._and_prefix_probe(dir0, terms, qw, counts, 10, tmax, {"probe_rows": 0})
    assert theta is not None and np.isfinite(theta).any()
    pruned = port.ranked_and(d.qs, k=10, prune=True)
    _assert_topk_close(pruned, port.ranked_and(d.qs, k=10), d.qs)
    _assert_topk_close(pruned, ref.ranked_and(d.qs, k=10, prune=True), d.qs)
    assert sum(map(len, pruned)) > 0


@pytest.mark.parametrize("k", [1, 10])
def test_wand_and_maxscore_match_ranked_or(skewed, k):
    d, port, _ = skewed
    exact = port.ranked_or(d.qs, k=k)
    for name in ("wand", "maxscore"):
        pruned = getattr(port, name)(d.qs, k=k)
        for i, (a, p) in enumerate(zip(exact, pruned)):
            assert len(a) == len(p), f"{name} k={k} q{i}: result count"
            np.testing.assert_allclose(p, a, rtol=1e-3, err_msg=f"{name} k={k} q{i}")


def _dir_blocks(plan):
    return sum(int((b["dir"] != p["sent_dir"]).sum()) for p in plan["plans"] for b in p["buckets"])


def _slots(plan):
    return sum(b["Bb"] * b["L"] for p in plan["plans"] for b in p["buckets"])


def test_pruned_plans_are_smaller(skewed):
    """maxscore's directory is no larger than wand's and smaller
    somewhere; wand's plan has fewer than 0.9 times the exhaustive
    plan's slots."""
    d, port, _ = skewed
    pe = port.prepare(d.qs, k=10, ops=("or",))
    pw = port.prepare(d.qs, k=10, ops=("or",), prune=True)
    pm = port.prepare(d.qs, k=10, ops=("or",), prune="maxscore")
    bw, bm = _dir_blocks(pw), _dir_blocks(pm)
    assert bm < bw, (bm, bw)
    assert _slots(pw) < 0.9 * _slots(pe), (_slots(pw), _slots(pe))


def test_prune_rejects_unsupported_ops(skewed):
    d, port, _ = skewed
    with pytest.raises(ValueError, match="prune requires"):
        port.prepare(d.qs, k=10, ops=("or", "and"), prune=True)
    with pytest.raises(ValueError, match="prune requires"):
        port.prepare(d.qs, k=10, ops=("counts",), ranked=False, prune=True)
    with pytest.raises(ValueError, match="prune requires"):
        port.prepare(d.qs, k=10, ops=("or",), ranked=False, prune="maxscore")
