"""ds2i_torch — the PyTorch/CUDA port of ds2i_tpu for NVIDIA Hopper.

The JAX package `ds2i_tpu` is the reference. This package serves the
same queries on an H100 and imports nothing of it: the host layers
(bitvec, sequences, codecs, index, io, queries, parallel.build_pool,
utils, native, global_params, config) are its own copies of ds2i_tpu's,
under the same module names, and everything that runs on the device is
redone here in PyTorch, with the Pallas kernel and the block decode ops
rewritten by hand in CUDA C++ (`csrc/`).

Layer map (mirrors ds2i_tpu's module names):
  device             resolve_device: CUDA unless "cpu" is asked for by name
  ops.segments       host segment tables (numpy copy)
  ops.pair_decode    EF-family pair decode of a part: plain PyTorch +
                     CUDA kernel, one launch a part for both streams
  ops.block_decode   split-mode decode of a part (OptPFor and
                     interpolative blocks): plain PyTorch + two CUDA
                     kernels, one launch per stream of a part each; the
                     CTA tables of both modes (PartLayout)
  engine.tiles       host tile tables (numpy copy; tiles_fast for plain ef)
  engine.block_tiles host block tile tables and exception patches (copy)
  engine.state       the resident device tensors
  engine.resident    ResidentEngine: host planner + device decode/join
  kernels            nvcc build at first use (one per source, in
                     parallel), ctypes binding
  native             the host C++ library (g++ at first use, into
                     build/ds2i_torch/)
  host               the host layers' entry points, re-exported

This package never loads JAX.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
