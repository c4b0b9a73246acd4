"""Decode-time prediction features and linear predictors
(dec_time_prediction.hpp): feature set (n, size, sum_of_logs, entropy,
nonzeros, max_b, pfor_b, pfor_exceptions), linear predictor with bias,
block statistics from sorted values, and the TSV predictor format
produced by the offline regression tool."""

import numpy as np

FEATURES = ["n", "size", "sum_of_logs", "entropy", "nonzeros", "max_b", "pfor_b", "pfor_exceptions"]
_FIDX = {name: i for i, name in enumerate(FEATURES)}


class FeatureVector:
    __slots__ = ("v",)

    def __init__(self):
        self.v = np.zeros(len(FEATURES), dtype=np.float32)

    def __getitem__(self, name):
        return float(self.v[_FIDX[name]])

    def __setitem__(self, name, value):
        self.v[_FIDX[name]] = value

    def dump(self):
        return {name: float(self.v[i]) for i, name in enumerate(FEATURES)}


class Predictor:
    def __init__(self, values=None):
        self.bias = 0.0
        self.w = np.zeros(len(FEATURES), dtype=np.float32)
        for name, value in values or []:
            if name == "bias":
                self.bias = float(value)
            else:
                self.w[_FIDX[name]] = value

    def __call__(self, fv):
        return float(self.bias + float(self.w @ fv.v))


def values_statistics(values, fv):
    """Populate n/entropy/sum_of_logs/nonzeros/max_b from block values
    (dec_time_prediction.hpp:108-143)."""
    v = np.sort(np.asarray(values, dtype=np.uint32))
    fv["n"] = len(v)
    if len(v) == 0:
        return fv
    uniq, counts = np.unique(v, return_counts=True)
    n = float(len(v))
    fv["entropy"] = float((counts * np.log2(n / counts)).sum())
    fv["sum_of_logs"] = float((counts * np.log2(uniq.astype(np.float64) + 1)).sum())
    fv["nonzeros"] = float(counts[uniq != 0].sum())
    fv["max_b"] = float(int(uniq[-1]).bit_length())
    return fv


def load_predictors(path, num_types=3):
    """Parse the 'type t bias b feat w...' TSV (mixed_block.hpp:222-249)."""
    predictors = [Predictor() for _ in range(num_types)]
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] != "type":
                raise ValueError("Invalid input format")
            t = int(parts[1])
            kv = [(parts[i], float(parts[i + 1])) for i in range(2, len(parts), 2)]
            if t >= num_types:
                raise ValueError("Invalid type while loading predictors")
            predictors[t] = Predictor(kv)
    return predictors


def read_block_stats(stream):
    """Yield (list_id, [block access counts]) from profile_queries output."""
    for line in stream:
        parts = line.split()
        if not parts:
            continue
        yield int(parts[0]), [int(c) for c in parts[1:]]
