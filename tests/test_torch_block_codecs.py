"""The Varint-G8IU and QMX block decoders (K7, K8) and the three block
index types they serve, on the CPU (device="cpu", the plain PyTorch
path), against the JAX package:

  - varint_decode_torch and qmx_decode_torch against the JAX device ops
    (varint_decode, qmx_decode), bit for bit, on host-encoded blocks made
    from a seed with numpy, for every static bucket (G; NI and S);
  - for block_varint, block_qmx and block_mixed (rebuilt from
    block_optpfor, so OptPFor blocks with exceptions, Varint-G8IU and
    interpolative blocks all occur), each engine over an index of its own
    package: tables, statics and words; the norm cache; every tile
    against the host decoder; the all-tiles part against the JAX engine's
    _decode_part (docs32 exactly, w32 bit for bit); the launches
    composing to the part; the CTA tables.

tests/test_torch_block_codecs_parts.py holds every part of a plan against
the JAX engine, tests/test_torch_block_codecs_engine.py the engines'
results. About 110 s serially on the build host's CPU (the JAX engines'
compiles dominate)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ds2i_tpu.codecs.qmx import QMXBlock
from ds2i_tpu.codecs.varint import VarintG8IUBlock
from ds2i_tpu.engine import resident as jax_resident
from ds2i_tpu.io import generate_collection
from ds2i_tpu.ops.qmx_device import qmx_decode
from ds2i_tpu.ops.varint_device import varint_decode

from ds2i_torch.ops.block_decode import (
    qmx_decode_torch, split_decode_part_torch, varint_decode_torch,
)

from test_qmx_device import _walk
from test_torch_block_resident import (
    check_every_tile_decodes_as_the_host, check_norm_cache, check_tables_and_words,
)
from test_torch_split_decode import (
    build_engines, check_all_tiles_part, check_cta_tables, check_launches_compose,
)

NEW_TYPES = ["block_varint", "block_qmx", "block_mixed"]
# the kernels whose CTAs each type's plans carry
KINDS = {"block_varint": {"varint", "interp"}, "block_qmx": {"qmx", "interp"},
         "block_mixed": {"optpfor", "varint", "interp"}}


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Release the JAX executables each test compiled before the next
    one (the fixture of tests/test_wand_device.py): this module's JAX
    engines compile large XLA-CPU programs, and a full suite's
    live-executable population is what crashes XLA-CPU's compiler in a
    worker."""
    yield
    jax.clear_caches()
    gc.collect()


def _pack(streams, rng, max_pad):
    """The block streams laid end to end at random byte offsets (up to
    max_pad bytes apart), padded to whole words: (words, byte offsets)."""
    offs, parts, cur = [], [], 0
    for s in streams:
        pad = int(rng.randint(0, max_pad + 1))
        parts += [np.zeros(pad, np.uint8), s]
        offs.append(cur + pad)
        cur += pad + len(s)
    buf = np.concatenate(parts + [np.zeros(32, np.uint8)])
    buf = np.concatenate([buf, np.zeros((-len(buf)) % 4, np.uint8)])
    return buf.view("<u4"), np.array(offs)


def _encode(codec, values):
    chunk = []
    codec.encode(values, int(values.sum()), 128, chunk)
    return np.concatenate([np.asarray(c, np.uint8).reshape(-1) for c in chunk])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int64).astype(np.int32)))


@pytest.mark.parametrize("G", [24, 40, 64])
def test_varint_decode_matches_jax(G):
    """Blocks of 1- to 4-byte values (up to 2^32 - 1), as test_varint_device
    builds them, at random byte offsets; a block's last group with
    trailing pad bytes; blocks of more than G groups (the JAX op reads G)
    compare too. Rows that fit G also equal the host values."""
    rng = np.random.RandomState(11 + G)
    streams, expect = [], []
    for r in range(24):
        mag = int(rng.choice([6, 8, 14, 22, 30, 32]))
        v = rng.randint(0, 2 ** mag, size=128, dtype=np.uint64).astype(np.uint32)
        if r % 4 == 0:  # 4-byte values among small ones
            v[rng.choice(128, 9, replace=False)] = rng.randint(1 << 24, 1 << 32, 9, dtype=np.uint64)
        streams.append(_encode(VarintG8IUBlock, v))
        expect.append(v)
    words, offs = _pack(streams, rng, 8)
    ng = np.array([len(s) // 9 for s in streams])
    desc_last = np.array([s[-9] for s in streams])
    assert np.any(desc_last < 0x80)  # some last group ends before its 8th byte
    assert np.any(ng > G) == (G < 64) and np.any(ng <= G)
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    exp = np.asarray(varint_decode(jnp.asarray(words), i32(offs >> 2), i32((offs & 3) * 8), i32(ng),
                                   G=G))
    got = varint_decode_torch(torch.from_numpy(words.view(np.int32)), _t(offs >> 2),
                              _t((offs & 3) * 8), _t(ng), G).numpy()
    assert got.dtype == np.int32 and got.shape == (len(streams), 128)
    np.testing.assert_array_equal(got, exp)
    for r in np.flatnonzero(ng <= G):
        np.testing.assert_array_equal(got[r].view(np.uint32), expect[r], err_msg=f"row {r}")


@pytest.mark.parametrize("S", [8, 16, 32])
@pytest.mark.parametrize("NI", [8, 16, 32])
def test_qmx_decode_matches_jax(NI, S):
    """Blocks as test_qmx_device builds them: widths 1-31 bits, mixed
    widths in one block, runs of the value 1 (type 0) covering 64-96
    slots, and 32-instance blocks of 32-bit values. Rows whose instances
    and selectors fit NI and S also equal the host values; the others
    (the JAX op reads NI and S) compare bit for bit all the same."""
    rng = np.random.RandomState(17 + 3 * NI + S)
    streams, expect = [], []
    for r in range(30):
        mag = int(rng.choice([1, 3, 7, 12, 20, 31, 32]))
        v = rng.randint(0, 2 ** mag, size=128, dtype=np.uint64)
        if r % 3 == 0:
            v[rng.choice(128, 20, replace=False)] = rng.randint(0, 2 ** 31, 20)
        if r % 5 == 0:
            v[: 64 + (r % 3) * 16] = 1
        streams.append(_encode(QMXBlock, v))
        expect.append(v.astype(np.uint32))
    words, offs = _pack(streams, rng, 4)
    walk = np.array([_walk(s) for s in streams])  # payload offset, ninst, last byte, nsel
    cols = [(offs + walk[:, 0]) >> 2, ((offs + walk[:, 0]) & 3) * 8, walk[:, 1],
            (offs + walk[:, 2]) >> 2, (offs + walk[:, 2]) & 3, walk[:, 3]]
    fits = (walk[:, 1] <= NI) & (walk[:, 3] <= S)
    assert fits.any() and (NI == 32 or not fits.all())
    assert (walk[:, 1] == 32).any()  # 32-instance blocks occur
    exp = np.asarray(qmx_decode(jnp.asarray(words), *[jnp.asarray(c, jnp.int32) for c in cols],
                                NI=NI, S=S))
    got = qmx_decode_torch(torch.from_numpy(words.view(np.int32)), *[_t(c) for c in cols],
                           NI, S).numpy()
    assert got.dtype == np.int32 and got.shape == (len(streams), 128)
    np.testing.assert_array_equal(got, exp)
    for r in np.flatnonzero(fits):
        np.testing.assert_array_equal(got[r].view(np.uint32), expect[r], err_msg=f"row {r}")


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("coll") / "c")
    generate_collection(base, num_docs=1500, num_terms=4000, postings_target=80_000,
                        num_queries=80, max_query_len=3)
    return base


@pytest.fixture(scope="module")
def engines(coll):
    """name -> (port engine, JAX engine, queries) with small part budgets,
    each over an index of its own package, norm caches built."""
    return build_engines(coll, NEW_TYPES)


@pytest.mark.parametrize("name", NEW_TYPES)
def test_tables_and_words_match_jax(engines, name):
    """The tables and words equal the JAX engine's; block_mixed's OptPFor
    blocks carry exceptions, so "optp" groups (resident patch words)
    occur beside "var" and "interp" ones."""
    port, ref, _ = engines[name]
    kinds = check_tables_and_words(port, ref)
    assert kinds == {"block_varint": {"var", "interp"}, "block_qmx": {"qmx", "interp"},
                     "block_mixed": {"optp", "opt", "var", "interp"}}[name]
    check_norm_cache(port, ref)


@pytest.mark.parametrize("name", NEW_TYPES)
def test_every_tile_decodes_as_the_host(engines, name):
    port = engines[name][0]
    check_every_tile_decodes_as_the_host(port.index, port)
    check_all_tiles_part(port)


@pytest.mark.parametrize("name", NEW_TYPES)
def test_all_tiles_part_equals_jax_decode_part(engines, name):
    """The all-tiles part (every tile, both streams, BM25 weights) against
    the JAX engine's _decode_part over the same rows and groups."""
    port, ref, _ = engines[name]
    s = port.state
    part = port.all_tiles_part()
    lay = part.layout
    docs32, w32 = jax_resident._decode_part(
        ref.docs_words, ref.freqs_words, ref.tiles_docs, ref.tiles_freqs, ref.norm_den,
        jnp.asarray(part.gtile_ids.numpy().astype(np.int32)),
        jnp.asarray(part.gtile_f.numpy().astype(np.int32)),
        jnp.asarray(part.blkperm.numpy().astype(np.int32)), lay.groups, lay.groups_f,
        ref.num_docs, ranked=True, normcache=1, den_blocks=ref.den_blocks,
        tile_gblk0=ref.tile_gblk0)
    got_d, got_w = split_decode_part_torch(
        s.docs_words, s.tiles_docs, s.tiles_freqs, part.gtile_ids, part.gtile_f, part.blkperm,
        lay, port.num_docs, "bm25", s.den_blocks, s.tile_gblk0, out_rows=docs32.shape[0])
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(docs32))
    np.testing.assert_array_equal(got_w.numpy().view(np.int32), np.asarray(w32).view(np.int32))


@pytest.mark.parametrize("name", NEW_TYPES)
def test_cta_tables_cover_every_row_once(engines, name):
    port, _, qs = engines[name]
    assert check_cta_tables(port, qs) == KINDS[name]


@pytest.mark.parametrize("weights", ["bm25", "presence", None])
@pytest.mark.parametrize("name", NEW_TYPES)
def test_launches_compose_to_the_part(engines, name, weights):
    check_launches_compose(engines[name][0], engines[name][2], weights)
