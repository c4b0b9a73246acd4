"""Device ops of the port: each hand-written kernel beside its plain
PyTorch version. Exports what the JAX package's ops exports: the segment
kinds and tables, and the batched segment decode (K9)."""
from .segments import SEG_EF, SEG_EF_STRICT, SEG_RB, SEG_AO, SegmentTable, sequence_segments
from .decode import decode_segments_device, decode_segments_numpy
