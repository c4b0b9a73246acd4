"""Per-block codec switching (mixed_block.hpp): one type byte prepended to
full blocks choosing among {pfor=0, varint=1, interpolative=2}; partial
blocks are always interpolative. Provides the space/time enumeration used
by the optimal hybrid index (WSDM'15)."""

from dataclasses import dataclass

import numpy as np

from .interpolative import UNKNOWN_SUM, InterpolativeBlock
from .optpfor import POSS_LOGS, OptPForBlock
from .time_prediction import FeatureVector, values_statistics
from .varint import VarintG8IUBlock

PFOR = 0
VARINT = 1
INTERPOLATIVE = 2
BLOCK_TYPES = 3

BLOCK_CODECS_BY_TYPE = {
    PFOR: OptPForBlock,
    VARINT: VarintG8IUBlock,
    INTERPOLATIVE: InterpolativeBlock,
}


def compr_params(block_type):
    return len(POSS_LOGS) if block_type == PFOR else 1


@dataclass
class SpaceTimePoint:
    time: float
    space: int
    type: int
    param: int

    def sort_key(self):
        return (self.space, self.time)


class MixedBlock:
    block_size = 128
    overflow = 512  # qmx-free but keep room for decoder overshoot parity

    @staticmethod
    def encode(values, sum_of_values, n, out_list):
        raise RuntimeError("Mixed block indexes can only be created by transformation")

    @staticmethod
    def encode_type(block_type, param, values, sum_of_values, n, out_list):
        if n < MixedBlock.block_size:
            if block_type != INTERPOLATIVE:
                raise ValueError("Partial blocks can only be encoded with interpolative")
        else:
            out_list.append(np.array([block_type], dtype=np.uint8))
        if block_type == PFOR:
            OptPForBlock.encode(values, sum_of_values, n, out_list, force_b=POSS_LOGS[param])
        elif block_type == VARINT:
            VarintG8IUBlock.encode(values, sum_of_values, n, out_list)
        elif block_type == INTERPOLATIVE:
            InterpolativeBlock.encode(values, sum_of_values, n, out_list)
        else:
            raise ValueError("Unsupported block type")

    @staticmethod
    def compression_stats(block_type, param, values, sum_of_values, n, fv):
        """Returns encoded bytes or None if (type,param) is not applicable
        (mixed_block.hpp:68-104)."""
        if n != MixedBlock.block_size and block_type != INTERPOLATIVE:
            return None
        fv["pfor_b"] = 0
        fv["pfor_exceptions"] = 0
        if block_type == PFOR:
            b = POSS_LOGS[param]
            max_b = int(fv["max_b"])
            if b > max_b and (param > 0 and POSS_LOGS[param - 1] >= max_b):
                return None  # useless
            if max_b - b > 28:
                return None  # exception coder can't handle this
            exceptions = int((np.asarray(values[:n], dtype=np.uint32) >= np.uint32(1) << np.uint32(min(b, 31))).sum()) if b < 32 else 0
            fv["pfor_b"] = b
            fv["pfor_exceptions"] = exceptions
        out = []
        MixedBlock.encode_type(block_type, param, values, sum_of_values, n, out)
        buf = np.concatenate([np.asarray(o, dtype=np.uint8) for o in out]) if out else np.zeros(0, np.uint8)
        fv["size"] = len(buf)
        return buf

    @staticmethod
    def compute_space_time(values, sum_of_values, predictors, access_count):
        """All viable (type,param) points with predicted decode time
        (mixed_block.hpp:119-150)."""
        points = []
        fv = FeatureVector()
        values_statistics(values, fv)
        for t in range(BLOCK_TYPES):
            for param in range(compr_params(t)):
                buf = MixedBlock.compression_stats(t, param, values, sum_of_values, len(values), fv)
                if buf is None:
                    continue
                time = 0.0
                if len(values) == MixedBlock.block_size:
                    time = predictors[t](fv) * access_count
                points.append(SpaceTimePoint(time, len(buf), t, param))
        return points

    @staticmethod
    def decode(buf, pos, sum_of_values, n):
        if n == MixedBlock.block_size:
            block_type = int(buf[pos])
            pos += 1
        else:
            block_type = INTERPOLATIVE
        if block_type == VARINT:
            return VarintG8IUBlock.decode(buf, pos, sum_of_values, n)
        if block_type == PFOR:
            return OptPForBlock.decode(buf, pos, sum_of_values, n)
        if block_type == INTERPOLATIVE:
            return InterpolativeBlock.decode(buf, pos, sum_of_values, n)
        raise ValueError(f"bad block type {block_type}")
