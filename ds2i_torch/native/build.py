"""Build the native construction library explicitly:

    python -m ds2i_torch.native.build [--sanitize]

The loader (ds2i_torch.native) builds ds2i_native.cpp with g++ at first
use; this builds it ahead of time, always afresh, into the same place:
build/ds2i_torch/libds2i_native_<hash>.so at the repository root, never
into the package. --sanitize (or sanitize=True) builds a copy under
AddressSanitizer with frame pointers instead, mirroring the reference's
-DUSE_SANITIZERS build (CMakeLists.txt:28-30), into
build/ds2i_torch/libds2i_native_asan_<hash>.so; the loader never loads
that copy: a caller loads it with ctypes in a process started with
LD_PRELOAD=$(g++ -print-file-name=libasan.so), as
tests/test_torch_native_cursor.py does.
"""

import argparse
import fcntl
import os
import subprocess

from . import BUILD_DIR, GXX_FLAGS, _SRC, lib_path

SANITIZE_FLAGS = ["-fsanitize=address", "-fno-omit-frame-pointer"]


def build(verbose=True, sanitize=False):
    """g++ the library and return its path (the loader's lib_path(), or
    the sanitized copy's)."""
    out = lib_path()
    flags = list(GXX_FLAGS)
    if sanitize:
        flags += SANITIZE_FLAGS
        d, name = os.path.split(out)
        out = os.path.join(d, name.replace("libds2i_native_", "libds2i_native_asan_"))
    cmd = ["g++", *flags, _SRC, "-o", f"{out}.tmp{os.getpid()}"]
    if verbose:
        print(" ".join(cmd))
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libds2i_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(cmd, check=True, timeout=600)
        os.replace(cmd[-1], out)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--sanitize", action="store_true",
                    help="build a copy under AddressSanitizer instead")
    args = ap.parse_args()
    print(build(sanitize=args.sanitize))


if __name__ == "__main__":
    main()
