"""Build and bind the port's CUDA kernels.

Each kernel source csrc/<name>.cu has a plain C entry point and is built
into a shared library of its own, libds2i_<name>_<hash>.so under
build/ds2i_torch/ at the repository root, keyed by a hash of the source,
the shared headers (csrc/*.cuh) and the flags. The first call to lib()
starts one nvcc for every library not yet built, all together, waits for
them, and loads every library with ctypes (the pattern of
ds2i_torch/native). Nothing is compiled when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ds2i_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]  # never --use_fast_math: the kernels' integer work must stay exact

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PART_ARGS = [
    _p, _ll, _p, _p,  # words, word count, field table (rows, N_FIELDS) int32, row->tile int64
    _p, _i, _i, _i,  # CTA table (n_cta, 6) int32, n_cta, max_w, max_t
    _i, _i,  # mode (csrc/common.cuh Mode), num_docs
    _p, _p,  # out int32 blocks, w f32 blocks (or NULL)
    _p, _p, _p, _p,  # freq blocks, blkperm, den_blocks, tile_gblk0 (bm25 mode, else NULL)
    _p,  # cudaStream_t
]
# pair mode decodes both streams of a part in one launch: the split mode's
# freq blocks and blkperm give way to the freqs stream's words and fields
_PAIR_ARGS = _PART_ARGS[:12] + [
    _p, _ll, _p,  # freqs words, word count, field table (bm25 mode, else NULL)
    _p, _p,  # den_blocks, tile_gblk0 (bm25 mode, else NULL)
    _p,  # cudaStream_t
]
# K8 reads its lane table (ops/block_decode.py:qmx_lane_words), uploaded
# once per device, through one more pointer before the stream
_QMX_ARGS = _PART_ARGS[:-1] + [
    _p,  # lane table, int32 (15 * 256 + 15,)
    _p,  # cudaStream_t
]
_BLOCKMAX_ARGS = [
    _p, _p, _p,  # docs int32 (rows, 32), w or freqs f32 (rows, 32), norm_den f32 (planes form, else NULL)
    _ll, _i,  # rows, num_docs
    _p, _p, _p, _p,  # wmax f32, dmax int32, dmin int32 (rows,), w plane f32 (planes form, else NULL)
    _p,  # cudaStream_t
]
_JOIN_ARGS = [
    _p, _p, _p,  # docs32 int32 (rows, 32), w32 f32 (rows, 32), entries int32
    _p, _p,  # row table int32 (n_rows, 5), qw f32 (n_rows, tmax)
    _p, _i, _p, _i,  # CTA items int32 (n_items, 5), n_items, warp rows int32, n_wrows
    _p, _p, _i,  # merges int32 (n_merge, 3), their arrival counts int32 (n_merge,), n_merge
    _i, _i, _i, _i, _i,  # num_docs, k, ops (bits: counts 1, or 2, and 4), tmax, stage
    _i, ctypes.c_float,  # fetch16, fscale
    _p, _p, _p,  # out (n_rows, width) f16 or f32, scratch top-k lists f32, scratch counts int32
    _p,  # cudaStream_t
]
_SEGMENT_ARGS = [
    _p, _ll, _i,  # words, word count, R
    *[_p] * 9,  # kind, sel_start, sel_len, lb_start, lower_bits, n_vals, base, out_begin, list_row
    _p, _i, _i, _i, _i,  # list_n int32 (rows,), W, Lseg, rows, L_out
    _p,  # out int32 (rows, L_out), filled with the sentinel
    _p,  # cudaStream_t
]
_TILE_GROUP_ARGS = [
    _p, _ll, _p, _i,  # words, word count, field rows int32 (R, N_FIELDS), R
    _i, _i, _i,  # W, WL, T
    _p,  # out int32 (R, T)
    _p,  # cudaStream_t
]
# entry point and argtypes of each kernel library (csrc/<name>.cu)
ENTRY_POINTS = {
    "pair_decode": ("ds2i_pair_decode_part", _PAIR_ARGS),
    "optpfor_decode": ("ds2i_optpfor_decode_part", _PART_ARGS),
    "optpfor_s16_decode": ("ds2i_optpfor_s16_decode_part", _PART_ARGS),
    "varint_decode": ("ds2i_varint_decode_part", _PART_ARGS),
    "qmx_decode": ("ds2i_qmx_decode_part", _QMX_ARGS),
    "interp_decode": ("ds2i_interp_decode_part", _PART_ARGS),
    "blockmax": ("ds2i_blockmax_rows", _BLOCKMAX_ARGS),
    "join": ("ds2i_join_part", _JOIN_ARGS),
    "segment_decode": ("ds2i_segment_decode", _SEGMENT_ARGS),
    "tile_decode": ("ds2i_tile_decode_group", _TILE_GROUP_ARGS),
}

# the kernels whose libraries also export ds2i_<entry>_attributes(int*):
# cudaFuncGetAttributes of the kernel (registers a thread, local bytes a
# thread, static shared bytes a block)
ATTRIBUTES = {"segment_decode": "ds2i_segment_decode_attributes",
              "tile_decode": "ds2i_tile_decode_attributes"}

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA kernels cannot be built")
    return path


def _lib_path(name, headers):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*headers, os.path.join(_CSRC, f"{name}.cu")]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libds2i_{name}_{h.hexdigest()[:16]}.so")


def _build():
    """Build every missing library, one nvcc each, all at once; returns
    {name: path}."""
    headers = sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    paths = {name: _lib_path(name, headers) for name in ENTRY_POINTS}
    todo = {name: so for name, so in paths.items() if not os.path.exists(so)}
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {
            name: subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", f"{so}.tmp{os.getpid()}",
                 os.path.join(_CSRC, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for name, so in todo.items()
        }
        failed = []
        for name, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{err}")
            else:
                os.replace(f"{todo[name]}.tmp{os.getpid()}", todo[name])
        if failed:
            raise RuntimeError("nvcc failed building " + "\n".join(failed))
    return paths


def load(path, name):
    """The library at `path`, built from a csrc/<name>.cu, loaded with its
    entry point's argtypes."""
    handle = ctypes.CDLL(path)
    fn_name, argtypes = ENTRY_POINTS[name]
    fn = getattr(handle, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    handle.ds2i_cuda_error_string.restype = ctypes.c_char_p
    handle.ds2i_cuda_error_string.argtypes = [ctypes.c_int]
    return handle


def lib(name):
    """The loaded library of csrc/<name>.cu; the first call builds and
    loads them all."""
    with _LOCK:
        if not _LIBS:
            for lib_name, path in _build().items():
                _LIBS[lib_name] = load(path, lib_name)
        return _LIBS[name]


def attributes(name):
    """{"registers", "local_bytes", "shared_bytes"} of csrc/<name>.cu's
    kernel on the current device (a name of ATTRIBUTES)."""
    handle = lib(name)
    fn = getattr(handle, ATTRIBUTES[name])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    attrs = (ctypes.c_int * 3)()
    check(handle, fn(ctypes.cast(attrs, ctypes.c_void_p)), f"{name} attributes")
    return dict(zip(("registers", "local_bytes", "shared_bytes"), attrs))


def check(handle, rc, what):
    """Raise if a kernel entry point of `handle` returned a CUDA error."""
    if rc != 0:
        msg = handle.ds2i_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
