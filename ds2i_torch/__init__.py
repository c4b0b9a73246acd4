"""ds2i_torch — the PyTorch/CUDA port of ds2i_tpu for NVIDIA Hopper.

The JAX package `ds2i_tpu` is the reference. This package serves the
same queries on an H100: the numpy layers (bitvec, sequences, codecs,
index, io, queries, native, utils) are imported from `ds2i_tpu`, and
everything that runs on the device is redone here in PyTorch, with the
Pallas kernels and the block decode ops rewritten by hand in CUDA C++
(`csrc/`).

Layer map (mirrors ds2i_tpu's module names):
  device             resolve_device: CUDA unless "cpu" is asked for by name
  ops.segments       host segment tables (numpy copy)
  ops.pair_decode    EF-family pair decode: plain PyTorch + CUDA kernel
  ops.block_decode   OptPFor and interpolative block decode: plain
                     PyTorch + two CUDA kernels
  engine.tiles       host tile tables (numpy copy; tiles_fast for plain ef)
  engine.block_tiles host block tile tables and exception patches (copy)
  engine.state       the resident device tensors
  engine.resident    ResidentEngine: host planner + device decode/join
  kernels            nvcc build at first use (one per source, in
                     parallel), ctypes binding

This package never loads JAX.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
