"""The port's persistence (ds2i_torch.index.mapper, tools.common) against
the JAX package's: for all nine index types, an index frozen by
ds2i_tpu.tools.common.save_index loads through
ds2i_torch.tools.common.load_index into the port's own class with a tree
byte-equal to the port's own build, and the reverse; both files are
byte-equal and their size trees equal; wand data likewise; and the
cursor ops (QUERY_OPS, with the port's copies of TopKQueue, wand_query
and maxscore_query) of both packages give equal answers on the log and
on seeded queries.

About 10 s serially."""

import numpy as np
import pytest

from ds2i_tpu import queries as ref_queries
from ds2i_tpu.index import size_tree as ref_size_tree
from ds2i_tpu.tools import common as ref_common

from ds2i_torch import queries as port_queries
from ds2i_torch.index import size_tree as port_size_tree
from ds2i_torch.tools import common as port_common

from test_torch_host_copy import SERVED_TYPES, _assert_tree_equal, build_index, build_wdata


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    from ds2i_tpu.io import generate_collection

    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=500, num_terms=800, postings_target=15_000,
                        num_queries=30, max_query_len=4)
    return base


@pytest.mark.parametrize("name", SERVED_TYPES)
def test_index_files_load_in_either_package(coll, tmp_path, name):
    ref, port = build_index(coll, name, "ref"), build_index(coll, name, "port")
    ref_file, port_file = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    assert ref_common.save_index(ref, ref_file) == port_common.save_index(port, port_file)
    assert open(ref_file, "rb").read() == open(port_file, "rb").read()
    assert ref_size_tree(ref_file) == port_size_tree(port_file)

    into_port = port_common.load_index(ref_file, name)
    assert type(into_port).__module__.startswith("ds2i_torch.")
    _assert_tree_equal(into_port.tree(), port.tree())
    into_ref = ref_common.load_index(port_file)
    assert type(into_ref).__module__.startswith("ds2i_tpu.")
    _assert_tree_equal(into_ref.tree(), ref.tree())
    with pytest.raises(ValueError, match="index file is"):
        port_common.load_index(ref_file, "block_qmx" if name != "block_qmx" else "opt")


def test_wand_data_files_load_in_either_package(coll, tmp_path):
    ref, port = build_wdata(coll, "ref"), build_wdata(coll, "port")
    ref_file, port_file = str(tmp_path / "ref.wand"), str(tmp_path / "port.wand")
    ref_common.save_wand_data(ref, ref_file)
    port_common.save_wand_data(port, port_file)
    assert open(ref_file, "rb").read() == open(port_file, "rb").read()
    _assert_tree_equal(port_common.load_wand_data(ref_file).tree(), port.tree())
    _assert_tree_equal(ref_common.load_wand_data(port_file).tree(), ref.tree())


def test_postings_stats_equal(coll):
    from ds2i_torch.host import BinaryFreqCollection

    for name in ("opt", "block_optpfor"):
        ref, port = build_index(coll, name, "ref"), build_index(coll, name, "port")
        c = BinaryFreqCollection(coll)
        assert port_common.postings_stats(port, c) == ref_common.postings_stats(ref, c)


@pytest.mark.parametrize("op", sorted(ref_queries.QUERY_OPS))
@pytest.mark.parametrize("name", ["opt", "block_optpfor"])
def test_cursor_query_ops_equal(coll, tmp_path, name, op):
    """Each package's cursor op over its own loaded index: equal answers
    (the same numpy arithmetic) on the log and on 30 seeded queries."""
    assert sorted(port_queries.QUERY_OPS) == sorted(ref_queries.QUERY_OPS)
    ref_file = str(tmp_path / "idx.bin")
    ref_common.save_index(build_index(coll, name, "ref"), ref_file)
    ref_idx, port_idx = ref_common.load_index(ref_file), port_common.load_index(ref_file)
    ref_wd, port_wd = build_wdata(coll, "ref"), build_wdata(coll, "port")
    rng = np.random.RandomState(3)
    qs = port_queries.read_queries(coll + ".queries") + [
        [int(t) for t in rng.choice(port_idx.size(), size=rng.randint(1, 5), replace=False)]
        for _ in range(30)]
    ref_fn = ref_queries.QUERY_OPS[op](ref_idx, ref_wd, 10)
    port_fn = port_queries.QUERY_OPS[op](port_idx, port_wd, 10)
    for q in qs:
        got, exp = port_fn(q), ref_fn(q)
        assert np.array_equal(np.asarray(got), np.asarray(exp)), (op, q, got, exp)
