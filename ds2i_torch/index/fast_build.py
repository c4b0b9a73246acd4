"""Native batched construction fast path for the `ef` index type.

The reference parallelizes list encoding across semiasync_queue worker
threads (freq_index.hpp:54-97); here the whole index is laid out with
vectorized numpy bit-size formulas (exclusive scan over per-list slice
sizes) and then written by ONE call into the native batched
compact-Elias-Fano writer (ds2i_native.cpp ds2i_ef_write_batch),
thread-parallel over sequences with atomic-OR word writes.

Bit output is identical to the pure-Python path (asserted by
tests/test_native.py); construction is ~20x faster.
"""

import numpy as np

from ..bitvec import BitVector, BitVectorBuilder
from ..sequences.ef import CompactEliasFano
from .bitvector_collection import BitvectorCollection

_U64 = np.uint64


def _msb_vec(x):
    x = x.astype(np.uint64)
    r = np.zeros(x.shape, np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        m = (x >> _U64(s)) > 0
        r += np.where(m, s, 0)
        x = np.where(m, x >> _U64(s), x)
    return r


def _ceil_log2_vec(x):
    return np.where(x > 1, _msb_vec(np.maximum(x, 2) - 1) + 1, 0)


def ef_bitsize_vec(universe, n, params):
    """Vectorized CompactEliasFano.bitsize (sequences/ef.py EFOffsets)."""
    universe = np.asarray(universe, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    l = np.where(universe > n, _msb_vec(np.maximum(universe // np.maximum(n, 1), 1)), 0)
    hb = n + (universe >> l) + 2
    psize = _ceil_log2_vec(hb)
    p0 = (hb - n) >> params.ef_log_sampling0
    p1 = n >> params.ef_log_sampling1
    return (p0 + p1) * psize + hb + n * l


def header_bitsize_vec(occ):
    """gamma_nonzero(occ) + n-field length (freq_index.hpp:68-73)."""
    occ = np.asarray(occ, dtype=np.int64)
    glen = 2 * _msb_vec(occ) + 1  # gamma(occ-1): nn = occ
    nlen = np.where(occ > 1, _ceil_log2_vec(occ + 1), 0)
    return glen + nlen


def _collection_from_raw(words, nbits, endpoints, params):
    # trim the native writer's spill-guard word so the frozen artifact is
    # byte-identical to the generic builder's output
    nw = (int(nbits) + 63) // 64
    bits_bv = BitVector(np.ascontiguousarray(words[:nw]), int(nbits))
    size = len(endpoints) - 1
    eb = BitVectorBuilder()
    if size:
        CompactEliasFano.write(
            eb, np.asarray(endpoints[:size], dtype=_U64), max(int(nbits), 1), size, params
        )
    return BitvectorCollection(size, eb.build(), bits_bv, params)


def build_seq_collections(kind_name, docs_lists, freqs_lists, occs, num_docs, params, workers=None):
    """Native batched construction for the `single` / `uniform` / `opt`
    index types (ds2i_native.cpp ds2i_seq_write_batch): whole-list docs
    (header + indexed/partitioned sequence) and freqs (positive strict
    sequence) streams encoded in C++ worker threads, bit-identical to the
    Python writers (tests/test_native.py). Returns None to fall back."""
    from ..native import seq_write_batch_native

    count = len(docs_lists)
    ns = np.array([len(d) for d in docs_lists], dtype=np.int64)
    occs = np.asarray(occs, dtype=np.int64)
    voff = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(ns, out=voff[1:])
    docs_v = np.concatenate(docs_lists).astype(_U64) if count else np.zeros(0, _U64)
    freqs_v = np.concatenate(freqs_lists).astype(np.int64) if count else np.zeros(0, np.int64)

    # the native DP takes u32 values (docs and freq prefix sums)
    if num_docs >= 2**32 or (count and int(occs.max()) + 1 >= 2**32):
        return None

    # validation: these types select ranked-bitvector encodings, which
    # reject duplicate docids (CompactRankedBitvector.write) — require
    # strictly increasing docs here, deferring weakly-monotone input to
    # the Python writers so error behavior matches them exactly
    if np.any(docs_v >= _U64(num_docs)):
        raise ValueError("Value out of universe bounds")
    if len(docs_v):
        gaps_ok = np.ones(len(docs_v), dtype=bool)
        gaps_ok[1:] = np.diff(docs_v.astype(np.int64)) > 0
        gaps_ok[voff[:-1][ns > 0]] = True
        if not np.all(gaps_ok):
            return None  # Python path raises (or accepts) per sequence type
    if np.any(freqs_v <= 0):
        raise ValueError("positive_sequence requires positive values")
    # the Python writers raise when a list's freq prefix sum exceeds its
    # declared occurrences+1 universe; the native path does unchecked
    # bit writes at value-derived positions, so catch it here instead of
    # corrupting the heap
    if count and len(freqs_v):
        fsums = np.add.reduceat(freqs_v, np.minimum(voff[:-1], len(freqs_v) - 1))
        fsums = np.where(ns > 0, fsums, 0)
        if np.any(fsums > occs):
            raise ValueError("sum of frequencies exceeds declared occurrences")

    res = seq_write_batch_native(
        kind_name, docs_v, freqs_v.astype(_U64), voff, num_docs, occs.astype(_U64),
        params, workers,
    )
    if res is None:
        return None
    d_words, d_bits, d_off, f_words, f_bits, f_off = res
    return (
        _collection_from_raw(d_words, d_bits, d_off, params),
        _collection_from_raw(f_words, f_bits, f_off, params),
    )


def build_ef_collections(docs_lists, freqs_lists, occs, num_docs, params, workers=None):
    """Build the (docs, freqs) BitvectorCollections of an `ef` index from
    raw per-list arrays in one native batch. Returns None if the native
    library is unavailable (caller falls back to the generic path)."""
    from ..native import ef_write_batch_native, available

    if not available():
        return None

    count = len(docs_lists)
    ns = np.array([len(d) for d in docs_lists], dtype=np.int64)
    occs = np.asarray(occs, dtype=np.int64)
    voff = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(ns, out=voff[1:])

    docs_v = np.concatenate(docs_lists).astype(_U64) if count else np.zeros(0, _U64)
    freqs_raw = np.concatenate(freqs_lists).astype(np.int64) if count else np.zeros(0, np.int64)

    # validation (mirrors CompactEliasFano.write / positive_sequence checks)
    if np.any(docs_v >= _U64(num_docs)):
        raise ValueError("Value out of universe bounds")
    gaps_ok = np.ones(len(docs_v), dtype=bool)
    if len(docs_v):
        gaps_ok[1:] = np.diff(docs_v.astype(np.int64)) >= 0
        gaps_ok[voff[:-1][ns > 0]] = True
        if not np.all(gaps_ok):
            raise ValueError("Sequence is not sorted")
    if np.any(freqs_raw <= 0):
        raise ValueError("positive_sequence requires positive values")
    # (same guard as build_seq_collections: the native writer does
    # unchecked value-positioned bit writes)
    if count and len(freqs_raw):
        fsums = np.add.reduceat(freqs_raw, np.minimum(voff[:-1], len(freqs_raw) - 1))
        fsums = np.where(ns > 0, fsums, 0)
        if np.any(fsums > occs):
            raise ValueError("sum of frequencies exceeds declared occurrences")

    # freq stream: strict EF over (occ+1) - n + 1 of (cumsum within list - i)
    cum = np.cumsum(freqs_raw)
    # within-list cumsum: subtract the running total before each list
    start_totals = np.concatenate([[0], cum[voff[1:] - 1][:-1]]) if count else np.zeros(0, np.int64)
    local_cum = cum - np.repeat(start_totals, ns)
    local_idx = np.arange(len(freqs_raw), dtype=np.int64) - np.repeat(voff[:-1], ns)
    freqs_v = (local_cum - local_idx).astype(_U64)
    f_universe = (occs - ns + 2).astype(_U64)

    # layout: docs slice = header + EF(num_docs); freqs slice = EF(strict u)
    d_sizes = header_bitsize_vec(occs) + ef_bitsize_vec(
        np.full(count, num_docs, dtype=np.int64), ns, params
    )
    f_sizes = ef_bitsize_vec(f_universe.astype(np.int64), ns, params)
    d_ends = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(d_sizes, out=d_ends[1:])
    f_ends = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(f_sizes, out=f_ends[1:])

    d_words = np.zeros((int(d_ends[-1]) + 63) // 64 + 1, dtype=_U64)
    f_words = np.zeros((int(f_ends[-1]) + 63) // 64 + 1, dtype=_U64)

    ef_write_batch_native(
        d_words, docs_v, voff, d_ends[:-1],
        np.full(count, num_docs, dtype=_U64), occs.astype(_U64), params, workers,
    )
    ef_write_batch_native(
        f_words, freqs_v, voff, f_ends[:-1], f_universe, None, params, workers,
    )

    docs_coll = _collection_from_raw(d_words, int(d_ends[-1]), d_ends, params)
    freqs_coll = _collection_from_raw(f_words, int(f_ends[-1]), f_ends, params)
    return docs_coll, freqs_coll
