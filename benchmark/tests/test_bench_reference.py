"""The plain reference against the port's plain CPU path, its
independence from the port, and the comparison that decides `correct`."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import corpus
import reference
import stream

from conftest import BENCH


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    base = tmp_path_factory.mktemp("ref") / "c"
    corpus.write(base, 1500, 16000, 200_000, 5)
    coll = corpus.Collection(base)
    qs = stream.Stream(coll.lens, 77, [0.25] * 4).batch(0, 400)[0]
    return str(base), coll, qs


@pytest.mark.parametrize("index_type", ["block_optpfor", "opt"])
def test_reference_matches_port_cpu(tiny, index_type):
    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.global_params import GlobalParameters
    from ds2i_torch.index.types import make_index_type
    from ds2i_torch.io import BinaryFreqCollection, read_sizes
    from ds2i_torch.queries import WandData

    base, coll, qs = tiny
    pcoll = BinaryFreqCollection(base)
    b = make_index_type(index_type).builder(pcoll.num_docs, GlobalParameters())
    for docs, freqs in pcoll:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs, np.int64).sum()))
    eng = ResidentEngine(b.build(), WandData.build(read_sizes(base), pcoll), device="cpu")
    ref = reference.Reference(coll)
    exp = [ref.ranked_and(q, 10) for q in qs]
    assert sum(len(e) for e in exp) > 100  # the sample holds real intersections
    for prune in (False, True):
        got = [r[3] for r in eng.execute(eng.prepare(qs, k=10, ops=("and",), prune=prune))]
        numbers = reference.judge(got, exp)
        assert reference.passes(numbers), (prune, numbers)
        if prune:
            assert all(np.array_equal(a, b) for a, b in zip(got, exhaustive))
        exhaustive = got


def test_ranked_or_matches_port_cpu(tiny):
    """The port's exhaustive ranked_or and its WAND against the
    reference's ranked_or."""
    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.global_params import GlobalParameters
    from ds2i_torch.index.types import make_index_type
    from ds2i_torch.io import BinaryFreqCollection, read_sizes
    from ds2i_torch.queries import WandData

    base, coll, qs = tiny
    pcoll = BinaryFreqCollection(base)
    b = make_index_type("block_optpfor").builder(pcoll.num_docs, GlobalParameters())
    for docs, freqs in pcoll:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs, np.int64).sum()))
    eng = ResidentEngine(b.build(), WandData.build(read_sizes(base), pcoll), device="cpu")
    ref = reference.Reference(coll)
    exp = [ref.ranked_or(q, 10) for q in qs]
    assert sum(len(e) == 10 for e in exp) > 300
    for prune in (False, True):
        got = [r[2] for r in eng.execute(eng.prepare(qs, k=10, ops=("or",), prune=prune))]
        numbers = reference.judge(got, exp)
        assert reference.passes(numbers), (prune, numbers)


class _Three:
    """Three documents of equal size (each norm 1, so den = k1 = 1.2) and
    two terms: term 0 in documents 0 and 1, term 1 in documents 1 and 2,
    among num_docs = 10 (idf ln(8.5 / 2.5) for both)."""

    num_docs = 10
    sizes = np.full(10, 4, np.uint32)
    lists = {0: ([0, 1], [1, 2]), 1: ([1, 2], [3, 4])}

    def list(self, t):
        docs, freqs = self.lists[t]
        return np.array(docs, np.uint32), np.array(freqs, np.uint32)


def test_ranked_or_on_a_hand_worked_collection():
    ref = reference.Reference(_Three())
    qw = 2.2 * np.log(8.5 / 2.5)

    def w(f):
        return f / (f + 1.2)

    doc0, doc1, doc2 = qw * w(1), qw * (w(2) + w(3)), qw * w(4)
    got = ref.ranked_or([1, 0], 10)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, [doc1, doc2, doc0], rtol=1e-6)
    np.testing.assert_allclose(ref.ranked_or([0, 1], 2), [doc1, doc2], rtol=1e-6)
    # a document that holds one term only scores that term alone
    np.testing.assert_allclose(ref.ranked_or([0], 10), [qw * w(2), doc0], rtol=1e-6)
    np.testing.assert_allclose(ref.ranked_and([0, 1], 10), [doc1], rtol=1e-6)


def test_reference_imports_nothing_of_the_port():
    names = set()
    for mod in ("reference.py", "corpus.py"):
        with open(os.path.join(BENCH, mod)) as f:
            for node in ast.walk(ast.parse(f.read())):
                if isinstance(node, ast.Import):
                    names |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom):
                    names.add((node.module or "").split(".")[0])
    assert names <= {"numpy"}, names
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {BENCH!r}); import reference; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'ds2i_torch', 'ds2i_tpu', 'jax', 'torch'}))"],
        capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_bf16_rounds_to_nearest_even():
    # 7 stored bits: 1 + 2^-8 and 1 + 3 * 2^-8 are ties, to the even neighbour
    x = np.array([1.0, 1 + 2**-8, 1 + 3 * 2**-8, 1 + 3 * 2**-9, 1 + 2**-9, -2.5, 3.0e38],
                 np.float32)
    got = reference.bf16(x)
    assert got.dtype == np.float32
    assert list(got[:6]) == [1.0, 1.0, 1 + 2**-6, 1 + 2**-7, 1.0, -2.5]
    assert np.all((got.view(np.uint32) & 0xFFFF) == 0)


def test_f16_rounds_to_nearest_even():
    # 10 stored bits: 1 + 2^-11 and 1 + 3 * 2^-11 are ties, to the even neighbour
    x = np.array([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-12, -2.5, 7e4], np.float32)
    with np.errstate(over="ignore"):
        got = reference.f16(x)
    assert got.dtype == np.float32
    assert list(got[:5]) == [1.0, 1.0, 1 + 2**-9, 1.0, -2.5] and np.isinf(got[5])


def test_f16_reference_weights_from_float32(tiny):
    """The f16 reading works each query weight out in float32 and rounds
    it once, so a collection past float16's range still scores."""
    _, coll, _ = tiny
    exact = reference.Reference(coll)
    low = reference.Reference(coll, precision="f16")
    low.num_docs = exact.num_docs = 10**6
    for df in (1, 7, 5000):
        w = exact.query_weight(1, df)
        assert low.query_weight(1, df) == reference.f16(w) and np.isfinite(w)


def test_judge_counts_each_fault():
    exp = [np.array([3.0, 2.0], np.float32), np.array([1.0], np.float32), np.zeros(0, np.float32)]
    ok = [np.array([3.0, 2.0 * (1 + 2e-4), -np.inf], np.float32), np.array([1.0], np.float32),
          np.array([-np.inf], np.float32)]
    n = reference.judge(ok, exp)
    assert n["missing"] == 0 and n["len_mismatch"] == 0 and 1e-4 < n["max_rel_gap"] < 3e-4
    assert reference.passes(n)
    bad = reference.judge([None, np.array([1.0, 0.5], np.float32), ok[2]], exp)
    assert bad == {"missing": 1, "len_mismatch": 1, "max_rel_gap": 0.0}
    assert not reference.passes(bad)
    assert not reference.passes(reference.judge([ok[0], np.array([1.01], np.float32), ok[2]],
                                                exp))
