"""The port's native CPU cursor engine (ds2i_torch.native.
cpu_block_query_native, the `queries --engine native` baseline) against
the numpy oracle: and/or counts and ranked_and/ranked_or top-10 over a
block_optpfor index; and the same run with the library built under
AddressSanitizer, in its own process, which must exit 0. A cursor whose
next_geq passes its list's last block once read the block maxima past
the list's end and decoded a block of negative length on the stack.

About 15 s serially (the sanitized build takes 5-10 s of it)."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys

    import numpy as np

    import ds2i_torch.native as native
    from ds2i_torch.host import (
        BinaryFreqCollection, GlobalParameters, WandData, and_query, generate_collection,
        make_index_type, or_query, ranked_and_query, ranked_or_query, read_queries, read_sizes,
    )
    from ds2i_torch.queries.bm25 import BM25
    from ds2i_torch.queries.parsing import query_freqs

    lib_path, base = sys.argv[1], sys.argv[2]
    if lib_path != "-":
        import ctypes

        native._TRIED, native._LIB = True, ctypes.CDLL(lib_path)
    generate_collection(base, num_docs=2000, num_terms=3000, postings_target=60_000,
                        num_queries=150, max_query_len=4)
    c = BinaryFreqCollection(base)
    wdata = WandData.build(read_sizes(base), c)
    b = make_index_type("block_optpfor").builder(c.num_docs, GlobalParameters())
    for docs, freqs in c:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
    index = b.build()
    # the log, and AND pairs of a short list and a one-block list of 97-127
    # postings: where the short one's docid passes the other's last, that
    # cursor steps past its only block
    lens = np.array([index.list_length(i) for i in range(index.size())])
    short = np.flatnonzero((lens > 1) & (lens < 60))[:12]
    block = np.flatnonzero((lens > 96) & (lens < 128))[:12]
    assert len(short) and len(block)
    qs = read_queries(base + ".queries") + [[int(a), int(b)] for a in short for b in block]
    N = float(index.num_docs())
    terms, qws, offs = [], [], [0]
    for q in qs:
        for t, m in query_freqs(q):
            idf = np.log((N - lens[t] + 0.5) / (lens[t] + 0.5))
            terms.append(t)
            qws.append(m * max(1e-6, idf) * (1 + BM25.k1))
        offs.append(len(terms))
    data, eps = np.asarray(index.lists, np.uint8), np.asarray(index.endpoints(), np.int64)
    for op, oracle in ((0, and_query), (1, or_query), (2, ranked_and_query),
                       (3, ranked_or_query)):
        scores, counts, _ = native.cpu_block_query_native(
            data, eps, index.size(), wdata.norm_lens, index.num_docs(), terms, qws, offs, op, 10)
        for i, q in enumerate(qs):
            if op < 2:
                assert counts[i] == oracle(index, q), (op, q)
            else:
                exp = oracle(index, wdata, q, 10)
                got = scores[i][np.isfinite(scores[i])]
                assert len(got) == len(exp), (op, q)
                if exp:
                    np.testing.assert_allclose(got, exp, rtol=1e-3)
    print("NATIVE_OK", len(qs))
""")


def _run(tmp_path, lib_path, env=None):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", _SCRIPT, lib_path, str(tmp_path / "c")],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=600)


def test_native_cursor_query_equals_oracle(tmp_path):
    from ds2i_torch import native

    if not native.available():
        pytest.skip("the native library does not build here (no g++)")
    proc = _run(tmp_path, "-")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NATIVE_OK" in proc.stdout


def test_native_cursor_query_under_address_sanitizer(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build a sanitized copy of the native library")
    libasan = subprocess.run([gxx, "-print-file-name=libasan.so"], capture_output=True,
                             text=True).stdout.strip()
    if not os.path.isabs(libasan) or not os.path.exists(libasan):
        pytest.skip("g++ has no AddressSanitizer runtime here")
    so = str(tmp_path / "libds2i_native_asan.so")
    subprocess.run([gxx, "-O1", "-g", "-fsanitize=address", "-fno-omit-frame-pointer",
                    "-std=c++17", "-shared", "-fPIC",
                    os.path.join(_REPO, "ds2i_torch", "native", "ds2i_native.cpp"), "-o", so],
                   check=True, capture_output=True, timeout=300)
    env = dict(os.environ, LD_PRELOAD=libasan, ASAN_OPTIONS="detect_leaks=0")
    proc = _run(tmp_path, so, env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NATIVE_OK" in proc.stdout
