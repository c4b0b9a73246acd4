"""Build and bind the port's CUDA kernels.

Each kernel source under csrc/ has a plain C entry point. It is compiled
at first use with nvcc into build/ds2i_torch/ at the repository root,
keyed by a hash of the sources, and loaded with ctypes (the pattern of
ds2i_tpu/native). Nothing is compiled when this module is imported.
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

_LIB = None
_LOCK = threading.Lock()


def _sources():
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA kernels cannot be built")
    return path


def _build():
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode())
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libds2i_torch_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in srcs if s.endswith(".cu")]],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {so}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library; builds it on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(_build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            handle.ds2i_pair_decode.restype = ctypes.c_int
            handle.ds2i_pair_decode.argtypes = [
                p, ll, p, ll,  # docs words, count; freqs words (or NULL), count
                p, p,  # docs / freqs field rows (R, N_FIELDS) int32
                i, i, i, i, i,  # R, W, WL, T, num_docs
                p, p,  # doc_out, freq_out (or NULL)
                p,  # cudaStream_t
            ]
            handle.ds2i_cuda_error_string.restype = ctypes.c_char_p
            handle.ds2i_cuda_error_string.argtypes = [i]
            _LIB = handle
        return _LIB


def check(rc, what):
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().ds2i_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
