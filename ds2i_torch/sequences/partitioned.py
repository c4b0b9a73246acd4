"""Partitioned Elias-Fano: the SIGIR'14 optimal partitioner + containers.

- ``optimal_partition``: (1+eps)-approximate shortest-path DP over geometric
  cost classes (optimal_partition.hpp:70-121). Build-time only; a C++
  fast path can replace it transparently (same outputs).
- ``PartitionedSequence``: variable partitions; layout
  gamma(#partitions), then either the singleton-partition fast path
  [base in ceil_log2(universe) bits; delta(universe encoding) if n>1; base
  sequence] or [gamma(endpoint_bits); EF(sizes: first partitions-1
  endpoints, universe n); EF(upper_bounds: partitions+1 values, universe
  universe); fixed-width endpoints; concatenated base encodings]
  (partitioned_sequence.hpp:22-119).
- ``UniformPartitionedSequence``: fixed 2^log_partition_size partitions, no
  sizes stream (uniform_partitioned_sequence.hpp).

Partition-relative semantics: partition p holds values - base_p where
base_0 = first value and base_p = upper_bound_{p-1} + 1, encoded with
relative universe last_rel + 1.
"""

from dataclasses import dataclass
from typing import List

import numpy as np

from ..bitvec import BitReader, BitVectorBuilder, read_delta, read_gamma, read_gamma_nonzero, write_delta, write_gamma, write_gamma_nonzero
from ..bitvec.bitvector import ceil_div, ceil_log2
from ..config import Configuration
from .base import Enumerator
from .ef import CompactEliasFano
from .selectors import IndexedSequence, StrictSequence

_U64 = np.uint64


@dataclass
class OptimalPartition:
    partition: List[int]
    cost_opt: int


class _CostWindow:
    __slots__ = ("start", "end", "min_p", "max_p", "cost_upper_bound")

    def __init__(self, first_value, cost_upper_bound):
        self.start = 0
        self.end = 0
        self.min_p = int(first_value)
        self.max_p = 0
        self.cost_upper_bound = cost_upper_bound

    def universe(self):
        return self.max_p - self.min_p + 1

    def size(self):
        return self.end - self.start


def optimal_partition(values, universe, size, cost_fun, eps1, eps2):
    """DP partitioner; `values` indexable, cost_fun(universe, n) -> bits."""
    values = np.asarray(values)
    size = int(size)
    single_block_cost = cost_fun(int(universe), size)
    min_cost = [single_block_cost] * (size + 1)
    min_cost[0] = 0

    windows = []
    cost_lb = cost_fun(1, 1)
    cost_bound = cost_lb
    while eps1 == 0 or cost_bound < cost_lb / eps1:
        windows.append(_CostWindow(values[0], cost_bound))
        if cost_bound >= single_block_cost:
            break
        cost_bound = int(cost_bound * (1 + eps2))  # matches uint64 truncation

    path = [0] * (size + 1)
    for i in range(size):
        last_end = i + 1
        for w in windows:
            while w.end < last_end:
                w.max_p = int(values[w.end])
                w.end += 1
            while True:
                window_cost = cost_fun(w.universe(), w.size())
                if min_cost[i] + window_cost < min_cost[w.end]:
                    min_cost[w.end] = min_cost[i] + window_cost
                    path[w.end] = i
                last_end = w.end
                if w.end == size:
                    break
                if window_cost >= w.cost_upper_bound:
                    break
                w.max_p = int(values[w.end])
                w.end += 1
            w.min_p = int(values[w.start]) + 1
            w.start += 1

    partition = []
    cur = size
    while cur != 0:
        partition.append(cur)
        cur = path[cur]
    partition.reverse()
    return OptimalPartition(partition, min_cost[size])


@dataclass
class PartitionMeta:
    """Parsed partition directory (white-box view used by decode/tests/stats)."""

    partitions: int
    begins: List[int]
    ends: List[int]
    bases: List[int]
    upper_bounds: List[int]
    rel_universes: List[int]
    data_offsets: List[int]  # absolute bit offset of each partition's base encoding


class _PartitionedBase:
    """Shared write/parse/decode machinery; subclasses pin partitioning."""

    base_sequence_type = IndexedSequence

    # -- subclass hooks ------------------------------------------------------

    @classmethod
    def _partition_points(cls, values, universe, n, params):
        raise NotImplementedError

    @classmethod
    def _write_sizes(cls, bvb, partition, n, params):
        pass

    @classmethod
    def _parse_sizes(cls, bv, reader_pos, partitions, n, params):
        """returns (ends list, bits consumed)"""
        raise NotImplementedError

    # -- write ---------------------------------------------------------------

    @classmethod
    def write(cls, bvb, values, universe, n, params):
        assert n > 0
        v = np.asarray(values, dtype=_U64)
        partition = cls._partition_points(v, universe, n, params)
        partitions = len(partition)
        assert partitions > 0 and partition[0] != 0 and partition[-1] == n
        write_gamma_nonzero(bvb, partitions)

        if partitions == 1:
            cur_base = int(v[0])
            rel = v - _U64(cur_base)
            universe_bits = ceil_log2(universe)
            bvb.append_bits(cur_base, universe_bits)
            if n > 1:
                if cur_base + int(rel[-1]) + 1 == universe:
                    write_delta(bvb, 0)  # tight universe
                else:
                    write_delta(bvb, int(rel[-1]))
            cls.base_sequence_type.write(bvb, rel, int(rel[-1]) + 1, n, params)
            return

        bv_sequences = BitVectorBuilder()
        endpoints = []
        upper_bounds = [int(v[0])]
        cur_base = int(v[0])
        cur_i = 0
        for p_end in partition:
            part = v[cur_i:p_end] - _U64(cur_base)
            ub = int(v[p_end - 1])
            cls.base_sequence_type.write(bv_sequences, part, int(part[-1]) + 1, len(part), params)
            endpoints.append(bv_sequences.size)
            upper_bounds.append(ub)
            cur_base = ub + 1
            cur_i = p_end

        endpoint_bits = ceil_log2(bv_sequences.size + 1)
        write_gamma(bvb, endpoint_bits)
        cls._append_streams(bvb, partition, upper_bounds, universe, n, params)
        for e in endpoints[:-1]:
            bvb.append_bits(e, endpoint_bits)
        bvb.append_builder(bv_sequences)

    @classmethod
    def _append_streams(cls, bvb, partition, upper_bounds, universe, n, params):
        raise NotImplementedError

    # -- parse / decode -------------------------------------------------------

    @classmethod
    def parse(cls, bv, offset, universe, n, params):
        r = BitReader(bv, offset)
        partitions = read_gamma_nonzero(r)
        if partitions == 1:
            universe_bits = ceil_log2(universe)
            cur_base = r.take(universe_bits)
            ub = 0
            if n > 1:
                universe_delta = read_delta(r)
                ub = universe_delta if universe_delta else (universe - cur_base - 1)
            return PartitionMeta(
                partitions=1,
                begins=[0],
                ends=[n],
                bases=[cur_base],
                upper_bounds=[cur_base + ub],
                rel_universes=[ub + 1],
                data_offsets=[r.position()],
            )

        endpoint_bits = read_gamma(r)
        cur = r.position()
        ends, consumed = cls._parse_sizes(bv, cur, partitions, n, params)
        cur += consumed
        ubs_seq = CompactEliasFano.decode(bv, cur, universe, partitions + 1, params)
        cur += CompactEliasFano.bitsize(params, universe, partitions + 1)
        endpoints_offset = cur
        cur += endpoint_bits * (partitions - 1)
        sequences_offset = cur

        if endpoint_bits:
            eps = bv.get_fields(
                endpoints_offset + np.arange(partitions - 1, dtype=_U64) * _U64(endpoint_bits),
                endpoint_bits,
            )
            endpoints = [0] + [int(e) for e in eps]
        else:
            endpoints = [0] * partitions

        begins = [0] + ends[:-1]
        bases = [int(ubs_seq[0])] + [int(ubs_seq[p]) + 1 for p in range(1, partitions)]
        ubs = [int(ubs_seq[p + 1]) for p in range(partitions)]
        return PartitionMeta(
            partitions=partitions,
            begins=begins,
            ends=ends,
            bases=bases,
            upper_bounds=ubs,
            rel_universes=[ubs[p] - bases[p] + 1 for p in range(partitions)],
            data_offsets=[sequences_offset + endpoints[p] for p in range(partitions)],
        )

    @classmethod
    def decode(cls, bv, offset, universe, n, params):
        meta = cls.parse(bv, offset, universe, n, params)
        out = np.empty(n, dtype=_U64)
        for p in range(meta.partitions):
            b, e = meta.begins[p], meta.ends[p]
            rel = cls.base_sequence_type.decode(
                bv, meta.data_offsets[p], meta.rel_universes[p], e - b, params
            )
            out[b:e] = rel + _U64(meta.bases[p])
        return out

    @classmethod
    def enumerator(cls, bv, offset, universe, n, params):
        e = Enumerator(cls.decode(bv, offset, universe, n, params), universe)
        return e

    @classmethod
    def num_partitions(cls, bv, offset, universe, n, params):
        return cls.parse(bv, offset, universe, n, params).partitions


class PartitionedSequence(_PartitionedBase):
    _native_cost_kind = 0  # indexed_sequence cost

    @classmethod
    def _partition_points(cls, values, universe, n, params):
        conf = Configuration.get()

        # native DP fast path (identical output; tests/test_native.py)
        from ..native import optimal_partition_native

        if universe < 2**32 and n < 2**32:
            part = optimal_partition_native(
                values, universe, n, params, conf.eps1, conf.eps2, conf.fix_cost,
                cost_kind=cls._native_cost_kind,
            )
            if part is not None:
                return part

        def cost_fun(u, nn):
            return cls.base_sequence_type.bitsize(params, u, nn) + conf.fix_cost

        return optimal_partition(values, universe, n, cost_fun, conf.eps1, conf.eps2).partition

    @classmethod
    def _append_streams(cls, bvb, partition, upper_bounds, universe, n, params):
        bv_sizes = BitVectorBuilder()
        CompactEliasFano.write(bv_sizes, np.asarray(partition[:-1], dtype=_U64), n, len(partition) - 1, params)
        bv_ubs = BitVectorBuilder()
        CompactEliasFano.write(bv_ubs, np.asarray(upper_bounds, dtype=_U64), universe, len(upper_bounds), params)
        bvb.append_builder(bv_sizes)
        bvb.append_builder(bv_ubs)

    @classmethod
    def _parse_sizes(cls, bv, pos, partitions, n, params):
        sizes = CompactEliasFano.decode(bv, pos, n, partitions - 1, params)
        ends = [int(s) for s in sizes] + [n]
        return ends, CompactEliasFano.bitsize(params, n, partitions - 1)


class UniformPartitionedSequence(_PartitionedBase):
    @classmethod
    def _partition_points(cls, values, universe, n, params):
        psize = 1 << params.log_partition_size
        partitions = ceil_div(n, psize)
        return [min((p + 1) * psize, n) for p in range(partitions)]

    @classmethod
    def _append_streams(cls, bvb, partition, upper_bounds, universe, n, params):
        bv_ubs = BitVectorBuilder()
        CompactEliasFano.write(bv_ubs, np.asarray(upper_bounds, dtype=_U64), universe, len(upper_bounds), params)
        bvb.append_builder(bv_ubs)

    @classmethod
    def _parse_sizes(cls, bv, pos, partitions, n, params):
        psize = 1 << params.log_partition_size
        ends = [min((p + 1) * psize, n) for p in range(partitions)]
        return ends, 0


class PartitionedSequenceStrict(PartitionedSequence):
    """partitioned_sequence<strict_sequence> — used for `opt` freq streams."""

    base_sequence_type = StrictSequence
    _native_cost_kind = 1  # strict_sequence cost


class UniformPartitionedSequenceStrict(UniformPartitionedSequence):
    """uniform_partitioned_sequence<strict_sequence> — `uniform` freq streams."""

    base_sequence_type = StrictSequence
