"""The yardstick's inputs: the vectorised collection generator against
the port's, and the query stream."""

import filecmp

import numpy as np
import pytest

import corpus
import stream


@pytest.mark.parametrize("clustered", [False, True])
def test_generator_byte_equal_to_port(tmp_path, clustered):
    from ds2i_torch.io.gen_collection import generate_collection

    args = dict(num_docs=3000, num_terms=33000, postings_target=400_000, seed=11,
                clustered=clustered)
    generate_collection(tmp_path / "port", num_queries=0, **args)
    corpus.write(tmp_path / "bench", args["num_docs"], args["num_terms"],
                 args["postings_target"], args["seed"], clustered)
    for ext in (".docs", ".freqs", ".sizes"):
        assert filecmp.cmp(tmp_path / f"port{ext}", tmp_path / f"bench{ext}", shallow=False), ext


def test_collection_lists_match_port_reader(tmp_path):
    from ds2i_torch.io import BinaryFreqCollection, read_sizes

    corpus.write(tmp_path / "c", 1000, 11000, 100_000, 3)
    ours, port = corpus.Collection(tmp_path / "c"), BinaryFreqCollection(tmp_path / "c")
    assert ours.num_docs == port.num_docs and len(ours.lens) == len(port)
    for i in range(0, len(port), 37):
        d, f = ours.list(i)
        assert np.array_equal(d, port[i][0]) and np.array_equal(f, port[i][1])
    assert np.array_equal(ours.sizes, read_sizes(tmp_path / "c"))


def test_stream_is_a_function_of_the_seed():
    lens = np.random.default_rng(0).zipf(1.6, 50_000).clip(1, 5000)
    law = [0.25] * 4
    a = stream.Stream(lens, 2**31 + 99, law)
    b = stream.Stream(lens, 2**31 + 99, law)
    # batches that cross a chunk boundary read the same queries as one draw
    q1 = a.batch(stream.CHUNK - 100, 300)
    q2 = b.batch(stream.CHUNK - 100, 100)[0] + b.batch(stream.CHUNK, 200)[0]
    assert q1[0] == q2
    assert len(q1[0]) == len(q1[1]) == len(q1[2]) == 300
    for q, w in zip(q1[0], q1[1]):
        assert 1 <= len(q) <= 4 and len(set(q)) == len(q)
        assert w == lens[q].sum()
    assert (stream.Stream(lens, 5, law).batch(0, 50)[0]
            != stream.Stream(lens, 6, law).batch(0, 50)[0])
    warm = stream.Stream(lens, 2**31 + 99, law, part=stream.WARMUP)
    assert warm.batch(0, 50)[0] != a.batch(0, 50)[0]


def test_train_part_is_read_by_no_run():
    """A transformed configuration's training log (part TRAIN, drawn with
    its corpus_seed) is neither the window's nor the warm-up's queries of
    a run, even of a run whose seed is that corpus_seed."""
    lens = np.random.default_rng(4).zipf(1.5, 40_000).clip(1, 8000)
    law = [0.25] * 4
    assert len({stream.WINDOW, stream.WARMUP, stream.TRAIN}) == 3
    train = stream.Stream(lens, 1729, law, part=stream.TRAIN).batch(0, stream.CHUNK)[0]
    for part in (stream.WINDOW, stream.WARMUP):
        other = stream.Stream(lens, 1729, law, part=part).batch(0, stream.CHUNK)[0]
        assert sum(a == b for a, b in zip(train, other)) < stream.CHUNK // 10


def test_stream_draws_by_square_root_of_length():
    lens = np.random.default_rng(1).zipf(1.4, 20_000).clip(1, 20_000)
    s = stream.Stream(lens, 1, [0.25] * 4)
    u = np.random.default_rng(2).random(100_000)
    want = np.minimum(np.searchsorted(s.cdf, u, side="right"), len(lens) - 1)
    assert np.array_equal(s._lists(u), want)


def test_prefetch_draws_what_batches_read():
    lens = np.random.default_rng(3).zipf(1.5, 30_000).clip(1, 9000)
    a = stream.Stream(lens, 2**33 + 1, [0.1, 0.2, 0.3, 0.4])
    a.prefetch(stream.CHUNK + 10)
    assert sorted(a.chunks) == [0, 1] and a.late == 0
    b = stream.Stream(lens, 2**33 + 1, [0.1, 0.2, 0.3, 0.4])
    got = a.batch(stream.CHUNK - 500, 1000)
    want = b.batch(stream.CHUNK - 500, 1000)
    assert got[0] == want[0] and a.late == 0 and b.late == 2
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    flat = a.terms(stream.CHUNK - 500, 1000)
    assert flat.tolist() == [t for q in got[0] for t in q]
    # the traffic's law: lengths by query_len_p
    n = np.bincount([len(q) for q in a.batch(0, stream.CHUNK)[0]], minlength=5)[1:]
    assert np.allclose(n / n.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.01)
    two = stream.Stream(lens, 9, [0, 1]).batch(0, 200)[0]
    assert {len(q) for q in two} == {2}
