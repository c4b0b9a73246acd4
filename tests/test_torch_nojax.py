"""ds2i_torch runs where jax is absent: in a fresh interpreter whose
import system refuses every jax module, import the port, serve a CPU
ranked_and over an `opt` index (pair mode) and a `block_optpfor` index
(split mode) against the numpy oracle, and check no jax module loaded."""

import os
import subprocess
import sys
import textwrap

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _NoJax())

    import numpy as np

    import ds2i_torch
    import ds2i_torch.engine
    import ds2i_torch.host
    import ds2i_torch.engine.block_tiles
    import ds2i_torch.kernels
    import ds2i_torch.ops.block_decode
    import ds2i_torch.ops.pair_decode
    from ds2i_torch.engine import ResidentEngine
    from ds2i_torch.host import (
        BinaryFreqCollection, GlobalParameters, WandData, generate_collection,
        make_index_type, ranked_and_query, read_queries, read_sizes,
    )

    base = sys.argv[1]
    generate_collection(base, num_docs=400, num_terms=600, postings_target=8_000,
                        num_queries=12, max_query_len=3)
    c = BinaryFreqCollection(base)
    wdata = WandData.build(read_sizes(base), c)
    queries = read_queries(base + ".queries")
    for name in ("opt", "block_optpfor"):
        b = make_index_type(name).builder(c.num_docs, GlobalParameters())
        for docs, freqs in c:
            b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
        index = b.build()
        eng = ResidentEngine(index, wdata, device="cpu")
        assert eng.split == (name == "block_optpfor")
        got = eng.ranked_and(queries, k=10)
        for g, q in zip(got, queries):
            e = ranked_and_query(index, wdata, q, k=10)
            assert len(g) == len(e), (name, q)
            if e:
                np.testing.assert_allclose(g, e, rtol=1e-3)
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
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
