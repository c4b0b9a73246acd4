"""ds2i_torch runs where neither jax nor the JAX package is present: in a
fresh interpreter whose import system refuses every jax and ds2i_tpu
module, import the port, serve a CPU ranked_and over an `opt` index
(pair mode), a `block_optpfor` index and a `block_mixed` index made from
it by the port's rebuild_mixed (split mode) against the numpy oracle
(and, over the block indexes, the pruned ranked_and too; every pass
joins through ds2i_torch.ops.join), save and load the block_optpfor
index through the port's tools and serve it from a 2-shard
DocShardedEngine made by make_engine, and check neither loaded. Each
module a caller may import first loads in a fresh interpreter (no
import cycle breaks it). And no file of the port, nor
chip_smoke.py, names ds2i_tpu in an import."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "ds2i_tpu")

    def blocked(name):
        return name.split(".")[0] in BLOCKED

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _NoJax())

    import numpy as np

    import ds2i_torch
    import ds2i_torch.engine
    import ds2i_torch.host
    import ds2i_torch.engine.block_tiles
    import ds2i_torch.index.hybrid
    import ds2i_torch.kernels
    import ds2i_torch.ops.block_decode
    import ds2i_torch.ops.blockmax
    import ds2i_torch.ops.join
    import ds2i_torch.ops.pair_decode
    import ds2i_torch.tools.pass_timeline
    import ds2i_torch.index.verify
    import ds2i_torch.tools.create_freq_index
    import ds2i_torch.tools.create_wand_data
    import ds2i_torch.tools.gen_collection
    import ds2i_torch.tools.queries
    from ds2i_torch.engine import ResidentEngine, make_engine
    from ds2i_torch.parallel import DocShardedEngine
    from ds2i_torch.queries import QUERY_OPS
    from ds2i_torch.tools.common import load_index, save_index
    from ds2i_torch.host import (
        BinaryFreqCollection, GlobalParameters, WandData, generate_collection,
        make_index_type, ranked_and_query, read_queries, read_sizes, rebuild_mixed,
    )

    base = sys.argv[1]
    generate_collection(base, num_docs=400, num_terms=600, postings_target=8_000,
                        num_queries=12, max_query_len=3)
    c = BinaryFreqCollection(base)
    wdata = WandData.build(read_sizes(base), c)
    queries = read_queries(base + ".queries")
    for name in ("opt", "block_optpfor", "block_mixed"):
        if name == "block_mixed":
            nb = sum(len(index.get_blocks(li)) for li in range(index.size()))
            types = np.random.RandomState(2).randint(0, 3, 2 * nb)
            index = rebuild_mixed(index, types, np.where(types == 0, 10, 0))
        else:
            b = make_index_type(name).builder(c.num_docs, GlobalParameters())
            for docs, freqs in c:
                b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
            index = b.build()
            if name == "block_optpfor":
                save_index(index, base + ".idx")
                loaded = load_index(base + ".idx", name)
                sharded = make_engine(loaded, wdata, limit=len(loaded.lists) // 2, device="cpu")
                assert isinstance(sharded, DocShardedEngine)
                served = sharded.ranked_and(queries, k=10)
        eng = ResidentEngine(index, wdata, device="cpu")
        assert eng.split == (name != "opt")
        got = eng.ranked_and(queries, k=10)
        if name != "opt":
            pruned = eng.ranked_and(queries, k=10, prune=True)
            assert eng.wmax_blk is not None
        for i, (g, q) in enumerate(zip(got, queries)):
            e = ranked_and_query(index, wdata, q, k=10)
            assert len(g) == len(e), (name, q)
            if e:
                np.testing.assert_allclose(g, e, rtol=1e-3)
            if name != "opt":
                assert len(pruned[i]) == len(e), (name, q)
                if e:
                    np.testing.assert_allclose(pruned[i], e, rtol=1e-3)
            if name == "block_optpfor":
                assert len(served[i]) == len(e), q
                if e:
                    np.testing.assert_allclose(served[i], e, rtol=1e-3)
                assert QUERY_OPS["ranked_and"](index, wdata, 10)(q) == e
    loaded = sorted(m for m in sys.modules if blocked(m))
    assert not loaded, loaded
    print("NOJAX_OK", len(queries))
""")


def test_port_imports_and_serves_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path / "c")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


@pytest.mark.parametrize("module", [
    "ds2i_torch.kernels", "ds2i_torch.ops.block_decode", "ds2i_torch.ops.pair_decode",
    "ds2i_torch.ops.blockmax", "ds2i_torch.ops.join", "ds2i_torch.engine",
    "ds2i_torch.engine.block_tiles", "ds2i_torch.host", "ds2i_torch.index.hybrid",
    "ds2i_torch.utils.extsort", "ds2i_torch.tools.pass_timeline", "ds2i_torch.index.mapper",
    "ds2i_torch.index.verify", "ds2i_torch.queries", "ds2i_torch.tools.common",
    "ds2i_torch.tools.gen_collection", "ds2i_torch.tools.create_freq_index",
    "ds2i_torch.tools.create_wand_data", "ds2i_torch.tools.queries",
    "ds2i_torch.parallel.doc_sharded", "ds2i_torch.parallel",
])
def test_module_imports_first(tmp_path, module):
    """chip_smoke.py imports ds2i_torch.kernels, then ds2i_torch.ops: each
    entry module must load as the first of the port in a process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", f"import {module}"], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _names_ds2i_tpu(path):
    """(line, text) of every import of ds2i_tpu in the file at `path`:
    import / from-import statements, and importlib or __import__ calls
    whose string argument names it."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    hit = lambda name: bool(name) and name.split(".")[0] == "ds2i_tpu"  # noqa: E731
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if hit(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and hit(node.module):
            found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if fname in ("import_module", "__import__", "find_spec", "reload"):
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) and hit(arg.value):
                        found.append((node.lineno, arg.value))
    return found


def test_no_file_of_the_port_imports_the_jax_package():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "ds2i_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for module in ("index/hybrid.py", "utils/extsort.py", "ops/join.py", "tools/pass_timeline.py",
                   "index/mapper.py", "index/verify.py", "queries/topk.py", "queries/wand.py",
                   "queries/maxscore.py", "tools/common.py", "tools/gen_collection.py",
                   "tools/create_freq_index.py", "tools/create_wand_data.py", "tools/queries.py",
                   "parallel/doc_sharded.py", "engine/__init__.py"):
        assert os.path.join(_REPO, "ds2i_torch", module) in files
    bad = {os.path.relpath(f, _REPO): hits for f in files if (hits := _names_ds2i_tpu(f))}
    assert not bad, bad
