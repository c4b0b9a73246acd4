"""The port's copy of ds2i_tpu/ops/segments.py (numpy only), over the
port's own sequences.

The port imports nothing of the JAX package, so it carries this copy;
tests/test_torch_tiles.py pins it to the original.

Host-side segment tables: the bridge from bit-packed lists to batched
device decode.

TPU-first reformulation of the reference's cursor hierarchy: every posting
list of every EF-family index type flattens into a table of *segments*,
each one of four primitive kinds:

  SEG_EF        compact Elias-Fano     value = ((sel_j - j - 1) << l) | low_j
  SEG_EF_STRICT strict Elias-Fano      value = EF value + j
  SEG_RB        ranked bitvector       value = sel_j
  SEG_AO        implicit all-ones      value = j

(sel_j = position of the j-th 1-bit in the segment's select window, relative
to the window start; every kind finally adds the partition base.)

A partitioned list is just many small segments with different bases and
output offsets; a plain EF list is one segment. One batched select+gather
kernel (ops.decode) therefore decodes ANY mix of lists from ANY of the
ef/single/uniform/opt index types — replacing the reference's
per-type enumerator switch (indexed_sequence.hpp:129-163) with data.

Only directories/headers are parsed on the host (cheap, once per index
load); posting data bits are never touched until the device kernel reads
them from HBM.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..sequences.ef import (
    AllOnesSequence,
    CompactEliasFano,
    CompactRankedBitvector,
    EFOffsets,
    RBOffsets,
    StrictEliasFano,
)
from ..sequences.partitioned import _PartitionedBase
from ..sequences.selectors import (
    ALL_ONES,
    ELIAS_FANO,
    RANKED_BITVECTOR,
    TYPE_BITS,
    IndexedSequence,
    PositiveSequence,
    StrictSequence,
    strict_params,
)

SEG_EF = 0
SEG_EF_STRICT = 1
SEG_RB = 2
SEG_AO = 3


@dataclass
class SegmentTable:
    """Struct-of-arrays segment table (append-only builder)."""

    kind: List[int] = field(default_factory=list)
    sel_start: List[int] = field(default_factory=list)  # abs bit offset of select window
    sel_len: List[int] = field(default_factory=list)  # window length in bits
    lb_start: List[int] = field(default_factory=list)  # abs bit offset of low bits
    lower_bits: List[int] = field(default_factory=list)
    n_vals: List[int] = field(default_factory=list)
    base: List[int] = field(default_factory=list)
    out_begin: List[int] = field(default_factory=list)
    list_id: List[int] = field(default_factory=list)  # caller-assigned row

    def add(self, kind, sel_start, sel_len, lb_start, lower_bits, n_vals, base, out_begin, list_id):
        self.kind.append(kind)
        self.sel_start.append(sel_start)
        self.sel_len.append(sel_len)
        self.lb_start.append(lb_start)
        self.lower_bits.append(lower_bits)
        self.n_vals.append(n_vals)
        self.base.append(base)
        self.out_begin.append(out_begin)
        self.list_id.append(list_id)

    def __len__(self):
        return len(self.kind)

    def arrays(self):
        return {k: np.asarray(v, dtype=np.int64) for k, v in vars(self).items()}


def _ef_segment(table, offset, universe, n, params, base, out_begin, list_id, strict):
    if strict:
        universe = universe - n + 1
    of = EFOffsets(offset, universe, n, params)
    table.add(
        SEG_EF_STRICT if strict else SEG_EF,
        of.higher_bits_offset,
        of.higher_bits_length,
        of.lower_bits_offset,
        of.lower_bits,
        n,
        base,
        out_begin,
        list_id,
    )


def _rb_segment(table, offset, universe, n, params, base, out_begin, list_id):
    of = RBOffsets(offset, universe, n, params)
    table.add(SEG_RB, of.bits_offset, of.universe, 0, 0, n, base, out_begin, list_id)


def sequence_segments(seq_type, bv, offset, universe, n, params, table, base=0, out_begin=0, list_id=0):
    """Append the segments of one encoded sequence to `table`."""
    if issubclass(seq_type, PositiveSequence):
        # prefix-sum domain; caller diffs after assembly
        return sequence_segments(
            seq_type.base_sequence_type, bv, offset, universe, n, params, table, base, out_begin, list_id
        )

    if issubclass(seq_type, _PartitionedBase):
        meta = seq_type.parse(bv, offset, universe, n, params)
        for p in range(meta.partitions):
            sequence_segments(
                seq_type.base_sequence_type,
                bv,
                meta.data_offsets[p],
                meta.rel_universes[p],
                meta.ends[p] - meta.begins[p],
                params,
                table,
                base=base + meta.bases[p],
                out_begin=out_begin + meta.begins[p],
                list_id=list_id,
            )
        return

    if seq_type is IndexedSequence or seq_type is StrictSequence:
        is_strict = seq_type is StrictSequence
        sparams = strict_params(params) if is_strict else params
        if AllOnesSequence.bitsize(params, universe, n) == 0:
            table.add(SEG_AO, 0, 0, 0, 0, n, base, out_begin, list_id)
            return
        t = bv.get_bits(offset, TYPE_BITS)
        inner = offset + TYPE_BITS
        if t == ELIAS_FANO:
            _ef_segment(table, inner, universe, n, sparams, base, out_begin, list_id, strict=is_strict)
        else:
            _rb_segment(table, inner, universe, n, sparams, base, out_begin, list_id)
        return

    if seq_type is CompactEliasFano:
        _ef_segment(table, offset, universe, n, params, base, out_begin, list_id, strict=False)
        return
    if seq_type is StrictEliasFano:
        _ef_segment(table, offset, universe, n, params, base, out_begin, list_id, strict=True)
        return
    if seq_type is CompactRankedBitvector:
        _rb_segment(table, offset, universe, n, params, base, out_begin, list_id)
        return
    if seq_type is AllOnesSequence:
        table.add(SEG_AO, 0, 0, 0, 0, n, base, out_begin, list_id)
        return

    raise TypeError(f"no segment builder for {seq_type}")
