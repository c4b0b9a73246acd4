"""BM25 scorer with the reference's exact constants and float32 arithmetic
(bm25.hpp: k1 = 1.2, b = 0.5, idf epsilon = 1e-6)."""

import numpy as np

_F32 = np.float32


class BM25:
    b = _F32(0.5)
    k1 = _F32(1.2)
    epsilon_score = _F32(1.0e-6)

    @classmethod
    def doc_term_weight(cls, freq, norm_len):
        """Vectorized over freq/norm_len arrays; float32 like the reference."""
        f = np.asarray(freq, dtype=_F32)
        nl = np.asarray(norm_len, dtype=_F32)
        return f / (f + cls.k1 * (_F32(1.0) - cls.b + cls.b * nl))

    @classmethod
    def norm_denominator(cls, norm_len):
        """Per-doc denominator k1*(1-b+b*norm_len) in f32, precomputed once
        so the serving weight is a single add + divide from one table (the
        resident engine's norm_den; see engine/resident.py)."""
        nl = np.asarray(norm_len, dtype=_F32)
        return cls.k1 * (_F32(1.0) - cls.b + cls.b * nl)

    @classmethod
    def query_term_weight(cls, freq, df, num_docs):
        f = _F32(freq)
        fdf = _F32(df)
        idf = np.log((_F32(num_docs) - fdf + _F32(0.5)) / (fdf + _F32(0.5))).astype(_F32)
        return f * np.maximum(cls.epsilon_score, idf) * (_F32(1.0) + cls.k1)
