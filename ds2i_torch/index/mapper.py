"""Zero-copy persistence: the succinct::mapper equivalent.

The reference freezes every index/wand structure to an mmap-able file and
re-attaches it zero-copy (`mapper::freeze/map`, used at
create_freq_index.cpp:103, queries.cpp:76-77) and reports a named size tree
(`size_tree_of`, index_build_utils.hpp:37-45).

Format ("flatmap v1"):
  [8B magic "DS2ITPU1"][u64 manifest_len][manifest JSON][pad to 8]
  [array blobs, each 8-byte aligned]
The manifest mirrors the object tree; array leaves carry dtype/shape/offset.
`load` memory-maps arrays (zero copy). Objects expose `tree()` /
`from_tree()` instead of the C++ `map(Visitor&)` member.

The format, magic included, is the JAX package's byte for byte: a file
frozen by either package loads in the other, into that package's own
classes (tools.common.load_index).
"""

import json

import numpy as np

MAGIC = b"DS2ITPU1"
_ALIGN = 8


def freeze(tree, path):
    """Serialize a nested dict of arrays/scalars/strings. Returns total bytes."""
    blobs = []
    cursor = [0]

    def plan(node):
        if isinstance(node, dict):
            return {"t": "dict", "c": {k: plan(v) for k, v in node.items()}}
        if isinstance(node, np.ndarray):
            arr = np.ascontiguousarray(node)
            pad = (-cursor[0]) % _ALIGN
            cursor[0] += pad
            off = cursor[0]
            cursor[0] += arr.nbytes
            blobs.append((pad, arr))
            return {
                "t": "arr",
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "offset": off,
                "nbytes": arr.nbytes,
            }
        if isinstance(node, (bool, int, float, str)):
            return {"t": "val", "v": node}
        if isinstance(node, (np.integer, np.floating)):
            return {"t": "val", "v": node.item()}
        raise TypeError(f"cannot freeze node of type {type(node)}")

    manifest = plan(tree)
    mbytes = json.dumps(manifest).encode()
    header = MAGIC + np.array([len(mbytes)], dtype="<u8").tobytes() + mbytes
    header += b"\0" * ((-len(header)) % _ALIGN)

    with open(path, "wb") as f:
        f.write(header)
        for pad, arr in blobs:
            if pad:
                f.write(b"\0" * pad)
            f.write(arr.tobytes())
    return len(header) + cursor[0]


def load(path, mmap=True):
    """Attach a frozen tree; arrays are memory-mapped views."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"bad magic in {path}")
        (mlen,) = np.frombuffer(f.read(8), dtype="<u8")
        manifest = json.loads(f.read(int(mlen)))
        header_len = 16 + int(mlen)
        header_len += (-header_len) % _ALIGN

    buf = np.memmap(path, dtype=np.uint8, mode="r") if mmap else np.fromfile(path, dtype=np.uint8)

    def build(node):
        t = node["t"]
        if t == "dict":
            return {k: build(v) for k, v in node["c"].items()}
        if t == "arr":
            start = header_len + node["offset"]
            raw = buf[start : start + node["nbytes"]]
            return raw.view(node["dtype"]).reshape(node["shape"])
        return node["v"]

    return build(manifest)


def size_tree(path):
    """Named size breakdown in bytes (size_tree_of equivalent)."""
    with open(path, "rb") as f:
        f.read(8)
        (mlen,) = np.frombuffer(f.read(8), dtype="<u8")
        manifest = json.loads(f.read(int(mlen)))

    def sizes(node):
        t = node["t"]
        if t == "dict":
            out = {k: sizes(v) for k, v in node["c"].items()}
            out["__total__"] = sum(v["__total__"] if isinstance(v, dict) else v for v in out.values())
            return out
        if t == "arr":
            return node["nbytes"]
        return 0

    return sizes(manifest)
