"""ctypes bindings for the native construction kernels.

Builds ds2i_native.cpp with g++ at first use into
build/ds2i_torch/libds2i_native_<hash>.so at the repository root (keyed
by a hash of the source and the flags; never into the package
directory), one process at a time under a file lock, and loads it;
DS2I_NATIVE=0 or a failed build falls back to the pure-Python
implementations transparently.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ds2i_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "ds2i_torch")
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-ggdb"]


def lib_path():
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libds2i_native_{h.hexdigest()[:16]}.so")


def _build(path):
    """g++ the library into `path` unless another process already has;
    the lock makes concurrent first uses build it once."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libds2i_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.tmp{os.getpid()}"
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DS2I_NATIVE") == "0":
        return None
    path = lib_path()
    if not os.path.exists(path):
        # first run on a fresh machine (a few seconds with g++; a missing
        # compiler falls back to Python)
        try:
            _build(path)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.ds2i_optimal_partition.restype = ctypes.c_long
        lib.ds2i_optimal_partition.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available():
    return _load() is not None


def optimal_partition_native(values, universe, n, params, eps1, eps2, fix_cost, cost_kind=0):
    """Native DP; returns partition endpoint list or None if unavailable.
    cost_kind: 0 = indexed_sequence base, 1 = strict_sequence base."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.uint32)
    out = np.zeros(int(n) + 1, dtype=np.uint32)
    res = lib.ds2i_optimal_partition(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        int(n), int(universe), float(eps1), float(eps2), int(fix_cost), int(cost_kind),
        int(params.ef_log_sampling0), int(params.ef_log_sampling1),
        int(params.rb_log_rank1_sampling), int(params.rb_log_sampling1),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(out),
    )
    if res < 0:
        return None
    return [int(x) for x in out[:res]]


def ef_write_batch_native(words, vals, voff, base_bits, universes, occs, params, workers=None):
    """Batched compact-EF writer (ds2i_ef_write_batch). Writes in place
    into the zeroed u64 `words` buffer; thread-parallel over sequences."""
    lib = _load()
    if lib is None or not hasattr(lib, "ds2i_ef_write_batch"):
        raise RuntimeError("native library unavailable")
    if not hasattr(lib, "_ef_batch_ready"):
        lib.ds2i_ef_write_batch.restype = None
        lib.ds2i_ef_write_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ]
        lib._ef_batch_ready = True
    if workers is None:
        workers = os.cpu_count() or 1
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    voff = np.ascontiguousarray(voff, dtype=np.int64)
    base_bits = np.ascontiguousarray(base_bits, dtype=np.int64)
    universes = np.ascontiguousarray(universes, dtype=np.uint64)
    occs_p = None
    if occs is not None:
        occs = np.ascontiguousarray(occs, dtype=np.uint64)
        occs_p = occs.ctypes.data_as(ctypes.c_void_p)
    lib.ds2i_ef_write_batch(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        voff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        base_bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        universes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        occs_p,
        int(params.ef_log_sampling0), int(params.ef_log_sampling1),
        len(base_bits), int(workers),
    )


BLOCK_CODEC_IDS = {"optpfor": 0, "varint": 1, "interpolative": 2, "qmx": 3}


def block_write_batch_native(docs, freqs, offs, codec_name, workers=None):
    """Batched block posting-list encoder (ds2i_block_write_batch).
    Returns (bytes uint8[total], list_end_offsets int64[count]) or None
    when the library or codec is unavailable. Byte-identical to the
    Python BlockPostingList.write path (tests/test_native.py)."""
    lib = _load()
    cid = BLOCK_CODEC_IDS.get(codec_name)
    if lib is None or cid is None or not hasattr(lib, "ds2i_block_write_batch"):
        return None  # stale .so without the symbol: pure-Python fallback
    if not hasattr(lib, "_block_batch_ready"):
        lib.ds2i_block_write_batch.restype = ctypes.c_int64
        lib.ds2i_block_write_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ds2i_buffer_free.restype = None
        lib.ds2i_buffer_free.argtypes = [ctypes.c_void_p]  # shared with seq writer
        lib._block_batch_ready = True
    if workers is None:
        workers = os.cpu_count() or 1
    docs = np.ascontiguousarray(docs, dtype=np.uint32)
    freqs = np.ascontiguousarray(freqs, dtype=np.uint32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    count = len(offs) - 1
    ends = np.zeros(max(count, 1), dtype=np.int64)
    outp = ctypes.POINTER(ctypes.c_uint8)()
    total = lib.ds2i_block_write_batch(
        docs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        count, cid, int(workers),
        ctypes.byref(outp), ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if total < 0:
        return None
    try:
        buf = np.ctypeslib.as_array(outp, shape=(int(total),)).copy() if total else np.zeros(0, np.uint8)
    finally:
        lib.ds2i_buffer_free(outp)
    return buf, ends[:count]


def block_tables_native(data, list_offsets, codec_id, workers=None):
    """Batched tile-table builder (ds2i_block_tables). Returns
    (docs_fields i32[Nt,11], freqs_fields, tile_list i64, list_tile_start
    i64[size+1], dkey i64[Nt], fkey i64[Nt]) or None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "ds2i_block_tables"):
        return None  # stale .so without the symbol: pure-Python fallback
    if not hasattr(lib, "_block_tables_ready"):
        lib.ds2i_block_tables.restype = ctypes.c_int64
        lib.ds2i_block_tables.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._block_tables_ready = True
    if workers is None:
        workers = os.cpu_count() or 1
    data = np.ascontiguousarray(data, dtype=np.uint8)
    # spill guard: stream walks read up to one u32 past a block's last byte
    padded = np.concatenate([data, np.zeros(8, dtype=np.uint8)])
    offs = np.ascontiguousarray(list_offsets, dtype=np.int64)
    size = len(offs)
    dp = padded.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    op = offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    nt = lib.ds2i_block_tables(dp, op, size, int(codec_id), int(workers),
                               None, None, None, None, None, None)
    if nt < 0:
        return None
    docs_fields = np.zeros((int(nt), 11), dtype=np.int32)
    freqs_fields = np.zeros((int(nt), 11), dtype=np.int32)
    tile_list = np.zeros(int(nt), dtype=np.int64)
    lts = np.zeros(size + 1, dtype=np.int64)
    dkey = np.zeros(int(nt), dtype=np.int64)
    fkey = np.zeros(int(nt), dtype=np.int64)
    lib.ds2i_block_tables(
        dp, op, size, int(codec_id), int(workers),
        docs_fields.ctypes.data_as(ctypes.c_void_p),
        freqs_fields.ctypes.data_as(ctypes.c_void_p),
        tile_list.ctypes.data_as(ctypes.c_void_p),
        lts.ctypes.data_as(ctypes.c_void_p),
        dkey.ctypes.data_as(ctypes.c_void_p),
        fkey.ctypes.data_as(ctypes.c_void_p),
    )
    return docs_fields, freqs_fields, tile_list, lts, dkey, fkey


SEQ_KINDS = {"single": 0, "uniform": 1, "opt": 2}


def seq_write_batch_native(kind_name, docs, freqs, voff, num_docs, occs, params, workers=None):
    """Batched construction for the single/uniform/opt index types
    (ds2i_seq_write_batch_v2): per-list docs (header + selector/
    partitioned sequence) and freqs (positive strict sequence) bit
    streams, encoded by C++ worker threads in ONE pass into malloc'd
    buffers this wrapper copies out and frees. Returns
    (d_words u64, d_bits, d_off[count+1], f_words, f_bits, f_off) or
    None when the library/symbol is unavailable."""
    from ..config import Configuration

    lib = _load()
    kind = SEQ_KINDS.get(kind_name)
    # versioned symbol: the v2 single-pass ABI is incompatible with the
    # original two-pass export, so a stale .so cleanly falls back
    if lib is None or kind is None or not hasattr(lib, "ds2i_seq_write_batch_v2"):
        return None
    if not hasattr(lib, "_seq_batch_ready"):
        lib.ds2i_seq_write_batch_v2.restype = ctypes.c_int64
        lib.ds2i_seq_write_batch_v2.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ds2i_buffer_free.restype = None
        lib.ds2i_buffer_free.argtypes = [ctypes.c_void_p]
        lib._seq_batch_ready = True
    if workers is None:
        workers = os.cpu_count() or 1
    conf = Configuration.get()
    docs = np.ascontiguousarray(docs, dtype=np.uint64)
    freqs = np.ascontiguousarray(freqs, dtype=np.uint64)
    voff = np.ascontiguousarray(voff, dtype=np.int64)
    occs = np.ascontiguousarray(occs, dtype=np.uint64)
    count = len(voff) - 1
    d_ends = np.zeros(max(count, 1), dtype=np.int64)
    f_ends = np.zeros(max(count, 1), dtype=np.int64)
    args_head = (
        kind,
        docs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        voff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        count, int(num_docs),
        occs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(params.ef_log_sampling0), int(params.ef_log_sampling1),
        int(params.rb_log_rank1_sampling), int(params.rb_log_sampling1),
        int(params.log_partition_size),
        float(conf.eps1), float(conf.eps2), int(conf.fix_cost), int(workers),
    )
    de = d_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    fe = f_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    dwp = ctypes.POINTER(ctypes.c_uint64)()
    fwp = ctypes.POINTER(ctypes.c_uint64)()
    d_bits = ctypes.c_int64()
    f_bits = ctypes.c_int64()
    rc = lib.ds2i_seq_write_batch_v2(
        *args_head,
        ctypes.byref(dwp), ctypes.byref(d_bits), de,
        ctypes.byref(fwp), ctypes.byref(f_bits), fe,
    )
    if rc != 0:
        return None
    try:
        nwd = (int(d_bits.value) + 63) // 64 + 1
        nwf = (int(f_bits.value) + 63) // 64 + 1
        d_words = np.ctypeslib.as_array(dwp, shape=(nwd,)).copy()
        f_words = np.ctypeslib.as_array(fwp, shape=(nwf,)).copy()
    finally:
        lib.ds2i_buffer_free(dwp)
        lib.ds2i_buffer_free(fwp)
    d_off = np.zeros(count + 1, dtype=np.int64)
    d_off[:count] = d_ends[:count]
    d_off[count] = int(d_bits.value)
    f_off = np.zeros(count + 1, dtype=np.int64)
    f_off[:count] = f_ends[:count]
    f_off[count] = int(f_bits.value)
    return d_words, int(d_bits.value), d_off, f_words, int(f_bits.value), f_off


def cpu_block_query_native(data, endpoints, num_lists, norm_lens, num_docs,
                           qterms, qweights, qoffs, op, k):
    """Native CPU cursor query over a block_optpfor index (the reference-
    style enumerator path in C++: per-block decode + leapfrog/DAAT +
    scores-only top-k). op: 0 and-count, 1 or-count, 2 ranked_and,
    3 ranked_or. Returns (scores (Q, k) f32 -inf padded, counts (Q,),
    per-query microseconds (Q,)) or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "ds2i_cpu_block_query"):
        return None
    lib.ds2i_cpu_block_query.restype = ctypes.c_int64
    lib.ds2i_cpu_block_query.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
    ]
    data = np.ascontiguousarray(data, dtype=np.uint8)
    # slack so whole-word reads at the stream tail stay in bounds
    data = np.concatenate([data, np.zeros(16, np.uint8)])
    endpoints = np.ascontiguousarray(endpoints, dtype=np.int64)
    norm_lens = np.ascontiguousarray(norm_lens, dtype=np.float32)
    qterms = np.ascontiguousarray(qterms, dtype=np.int64)
    qweights = np.ascontiguousarray(qweights, dtype=np.float32)
    qoffs = np.ascontiguousarray(qoffs, dtype=np.int64)
    nq = len(qoffs) - 1
    scores = np.full((nq, max(k, 1)), -np.inf, dtype=np.float32)
    counts = np.zeros(nq, dtype=np.int64)
    qus = np.zeros(nq, dtype=np.float64)
    res = lib.ds2i_cpu_block_query(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        endpoints.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(num_lists),
        norm_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(num_docs),
        qterms.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qweights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        qoffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nq, int(op), int(max(k, 1)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qus.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if res != 0:
        return None
    return scores, counts, qus


def s16_exception_patches_native(words, w0, boff, nex, b, base, total,
                                 workers=None):
    """Native twin of block_tiles._decode_s16_exception_rows over a whole
    row set: decode OptPFor Simple16 exception streams into interleaved
    (slot position, high<<b) u32 pairs (2*total entries). Returns the
    patch array or None if the library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "ds2i_s16_exception_patches"):
        return None
    lib.ds2i_s16_exception_patches.restype = None
    lib.ds2i_s16_exception_patches.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
    ]
    if workers is None:
        workers = os.cpu_count() or 1
    data = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.uint8)
    # slack so whole-word reads at the stream tail stay in bounds
    data = np.concatenate([data, np.zeros(16, np.uint8)])
    w0 = np.ascontiguousarray(w0, dtype=np.int32)
    boff = np.ascontiguousarray(boff, dtype=np.int32)
    nex = np.ascontiguousarray(nex, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    base = np.ascontiguousarray(base, dtype=np.int64)
    out = np.zeros(2 * int(total), dtype=np.uint32)
    lib.ds2i_s16_exception_patches(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        w0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        boff.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nex.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(w0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), int(workers),
    )
    return out
