"""The plain reference: top-k BM25 ranked AND and ranked OR over the
generated postings.

It reads the collection's raw files (`corpus.Collection`) and nothing
that the program derived: no index, no wand data, no plan. BM25 is
ds2i's (bm25.hpp): k1 = 1.2, b = 0.5, idf floored at 1e-6, document
norms len / mean len recomputed here from the generated document sizes,
float32 throughout. A query's lists are intersected, each surviving
document scored as the sum of qw * f / (f + k1 * (1 - b + b * norm))
over the lists in increasing length (ds2i's ranked_and_query), and the
k largest scores returned in decreasing order (ds2i keeps no docids).
Ranked OR scores every document of the lists' union the same way, each
over the lists that hold it (ds2i's ranked_or_query): what WAND and
MaxScore return too.

`rnd` rounds the result of every operation: float32 for the reference,
`bf16` for the control, the same arithmetic a precision below the one
the configuration states. `f16` is read beside it, since the program's
scores come back from the card in float16: every operation of the
scoring rounded to float16, each term's query weight worked out in
float32 and rounded once (a collection's document counts pass float16's
largest value, 65,504). PRECISIONS names them.

The comparison (`judge`) is the one that decides a run's `correct`.
"""

import numpy as np

_F32 = np.float32


def f32(x):
    return np.asarray(x, dtype=_F32)


def bf16(x):
    """float32 values rounded to bfloat16 (nearest, ties to even), held
    in float32."""
    u = np.asarray(x, dtype=_F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(_F32)


def f16(x):
    """float32 values rounded to float16 (nearest, ties to even), held in
    float32."""
    return np.asarray(x, dtype=_F32).astype(np.float16).astype(_F32)


# name: (rounding of the scoring, rounding of the query weights' arithmetic)
PRECISIONS = {"f32": (f32, f32), "bf16": (bf16, bf16), "f16": (f16, f32)}


class Reference:
    def __init__(self, coll, k1=1.2, b=0.5, precision="f32"):
        self.coll = coll
        rnd, self.wrnd = PRECISIONS[precision]
        self.rnd = rnd
        self.k1, self.b, self.k1_w = rnd(k1), rnd(b), self.wrnd(k1)
        self.num_docs = coll.num_docs
        sizes = np.asarray(coll.sizes, dtype=_F32)
        avg = rnd(float(sizes.sum(dtype=np.float64)) / len(sizes))
        norm = rnd(rnd(sizes) / avg)
        self.den = rnd(self.k1 * rnd(rnd(_F32(1.0) - self.b) + rnd(self.b * norm)))

    def query_weight(self, mult, df):
        rnd, n = self.wrnd, _F32(self.num_docs)
        idf = rnd(np.log(rnd(rnd(n - _F32(df) + _F32(0.5)) / rnd(_F32(df) + _F32(0.5)))))
        return self.rnd(rnd(rnd(_F32(mult) * np.maximum(_F32(1e-6), idf))
                            * rnd(_F32(1.0) + self.k1_w)))

    def _lists(self, terms):
        """(docs, freqs, query weight) of each distinct term, a repeated
        term weighted by its count, in increasing list length."""
        uniq, mult = np.unique(np.asarray(terms, dtype=np.int64), return_counts=True)
        lists = []
        for t, m in zip(uniq.tolist(), mult.tolist()):
            docs, freqs = self.coll.list(t)
            lists.append((docs, freqs, self.query_weight(m, len(docs))))
        lists.sort(key=lambda x: len(x[0]))
        return lists

    def ranked_and(self, terms, k):
        rnd = self.rnd
        lists = self._lists(terms)
        inter = np.asarray(lists[0][0])
        for docs, _, _ in lists[1:]:
            inter = np.intersect1d(inter, docs, assume_unique=True)
        if len(inter) == 0:
            return np.zeros(0, dtype=_F32)
        den = self.den[inter.astype(np.int64)]
        score = np.zeros(len(inter), dtype=_F32)
        for docs, freqs, qw in lists:
            f = np.asarray(freqs[np.searchsorted(docs, inter)], dtype=_F32)
            w = rnd(f / rnd(f + den))
            score = rnd(score + rnd(qw * w))
        return np.sort(score)[::-1][:k]

    def ranked_or(self, terms, k):
        """Top-k ranked OR (ds2i's ranked_or_query): every document of the
        union scored as the sum of qw * f / (f + den) over the lists that
        hold it, added in increasing list length as ranked_and adds them,
        and the k largest scores in decreasing order."""
        rnd = self.rnd
        lists = self._lists(terms)
        union = np.unique(np.concatenate([docs for docs, _, _ in lists]))
        score = np.zeros(len(union), dtype=_F32)
        for docs, freqs, qw in lists:
            at = np.searchsorted(union, docs)
            f = np.asarray(freqs, dtype=_F32)
            w = rnd(f / rnd(f + self.den[np.asarray(docs, dtype=np.int64)]))
            score[at] = rnd(score[at] + rnd(qw * w))
        if len(score) > k:
            score = np.partition(score, len(score) - k)[len(score) - k:]
        return np.sort(score)[::-1]


# The limits, each between the program's largest reading and the
# control's smallest (PERF.md gives the readings they were set from).
LIMITS = {"missing": 0, "len_mismatch": 0, "max_rel_gap": 1e-3}


def judge(got, exp):
    """The numbers compared over a sample: answers that never came or are
    not a score list (`missing`), answers whose number of results differs
    from the reference's (`len_mismatch`), and the widest relative gap
    between a returned score and the reference's at the same rank
    (`max_rel_gap`)."""
    missing = mismatch = 0
    gap = 0.0
    for g, e in zip(got, exp):
        if g is None or np.ndim(g) != 1:
            missing += 1
            continue
        g = np.asarray(g, dtype=np.float64)
        g = g[np.isfinite(g)]
        if len(g) != len(e):
            mismatch += 1
            continue
        if len(e):
            e = np.asarray(e, dtype=np.float64)
            gap = max(gap, float(np.max(np.abs(g - e) / np.abs(e))))
    return {"missing": missing, "len_mismatch": mismatch, "max_rel_gap": gap}


def passes(numbers):
    return all(numbers[name] <= limit for name, limit in LIMITS.items())
