"""The port on the card: each CUDA kernel (pair decode, OptPFor and
interpolative block decode) against its plain PyTorch version, and
ResidentEngine on CUDA against the same engine on the CPU.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is False. The card's machine has no jax, so run them there without the
JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ds2i_torch.engine import ResidentEngine
from ds2i_torch.host import (
    BinaryFreqCollection, GlobalParameters, WandData, generate_collection,
    make_index_type, read_queries, read_sizes,
)
from ds2i_torch.ops import block_decode, pair_decode
from ds2i_torch.ops.block_decode import block_stream_torch, interp_decode, optpfor_decode
from ds2i_torch.ops.pair_decode import decode_pair, decode_pair_torch

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
    c = BinaryFreqCollection(coll_base)
    b = make_index_type(name).builder(c.num_docs, GlobalParameters())
    for docs, freqs in c:
        b.add_posting_list(len(docs), docs, freqs, int(np.asarray(freqs).sum()))
    return b.build()


@pytest.mark.parametrize("name", ["ef", "single", "uniform", "opt"])
def test_kernel_matches_plain_on_every_group(cuda, coll, name):
    """Both streams, and the docs-only form the norm cache uses, bit for
    bit; one counted launch per call."""
    eng = ResidentEngine(build(coll, name), device=cuda)
    s = eng.state
    groups, gids, _, _, _ = eng._order_groups(
        np.arange(eng.pad_tile), eng.tile_gid, eng.group_statics)
    ids_all = torch.from_numpy(gids.astype(np.int64)).to(cuda)
    for off, R, (_, W, WL, T) in groups:
        df, ff = s.tiles_docs[ids_all[off:off + R]], s.tiles_freqs[ids_all[off:off + R]]
        before = pair_decode.decode_pair.launches
        doc, freq = decode_pair(s.docs_words, s.freqs_words, df, ff, W, WL, T, eng.num_docs)
        doc_only, none = decode_pair(s.docs_words, None, df, None, W, WL, T, eng.num_docs)
        torch.cuda.synchronize()
        assert pair_decode.decode_pair.launches == before + 2
        assert none is None
        ref_doc, ref_freq = decode_pair_torch(
            s.docs_words, s.freqs_words, df, ff, W, WL, T, eng.num_docs)
        torch.testing.assert_close(doc, ref_doc, rtol=0, atol=0)
        torch.testing.assert_close(freq, ref_freq, rtol=0, atol=0)
        torch.testing.assert_close(doc_only, ref_doc, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, coll):
    eng = ResidentEngine(build(coll, "opt"), device=cuda)
    s = eng.state
    df, ff = s.tiles_docs[:8], s.tiles_freqs[:8]
    with pytest.raises(ValueError, match="int32"):
        decode_pair(s.docs_words.long(), s.freqs_words, df, ff, 4, 4, 32, eng.num_docs)
    with pytest.raises(ValueError, match="T must be"):
        decode_pair(s.docs_words, s.freqs_words, df, ff, 4, 4, 256, eng.num_docs)


@pytest.mark.parametrize("name", ["block_optpfor", "block_interpolative"])
def test_block_kernels_match_plain_on_every_group(cuda, coll, name):
    """Both streams of every split-mode group through its kernel and
    through block_stream_torch on the card, bit for bit; one counted
    launch per call, on the kernel the statics name."""
    eng = ResidentEngine(build(coll, name), device=cuda)
    s = eng.state
    for gid, stats, table, is_docs in (
        (eng.tile_gid_d, eng.group_statics_d, s.tiles_docs, True),
        (eng.tile_gid_f, eng.group_statics_f, s.tiles_freqs, False),
    ):
        groups, gids, _, _, _ = eng._order_groups(np.arange(eng.pad_tile), gid, stats)
        ids_all = torch.from_numpy(gids.astype(np.int64)).to(cuda)
        for off, R, st in groups:
            fld = table[ids_all[off:off + R]]
            wrapper = interp_decode if st[0] == "interp" else optpfor_decode
            before = wrapper.launches
            got = block_decode.block_stream(s.docs_words, fld, st, eng.num_docs, is_docs)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            ref = block_stream_torch(s.docs_words, fld, st, eng.num_docs, is_docs)
            torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_block_wrappers_reject_what_the_kernels_do_not_take(cuda, coll):
    eng = ResidentEngine(build(coll, "block_optpfor"), device=cuda)
    s = eng.state
    fld = s.tiles_docs[:8]
    with pytest.raises(ValueError, match="int32"):
        optpfor_decode(s.docs_words.long(), fld, ("optp", 5, 4, 128), eng.num_docs, True)
    with pytest.raises(ValueError, match="E="):
        optpfor_decode(s.docs_words, fld, ("opt", 5, 4, 128), eng.num_docs, True)
    with pytest.raises(ValueError, match="interp_decode takes"):
        interp_decode(s.docs_words, fld, ("interp", 5, 32), eng.num_docs, True)


@pytest.mark.parametrize("name", ["ef", "opt", "block_optpfor", "block_interpolative"])
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
