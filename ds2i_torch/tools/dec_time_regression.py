"""CLI: train the decode-time linear model (dec_time_regression.py + l1l1.py
equivalents, rewritten for Python 3 / numpy — the reference used Python 2
pandas + Theano).

Usage: python -m ds2i_torch.tools.dec_time_regression <profile.jsonl>
           [--out linear_weights.tsv] [--l1 LAMBDA]

Per block type: Huber-robust L1-regularized linear regression with
nonnegative weights, fit by IRLS + projected coordinate steps (no scipy
dependency). Features `type, time, n, entropy` are dropped like the
reference (dec_time_regression.py:44-52); output format is the TSV
`type t bias b <feature> <weight> ...` consumed by load_predictors.
"""

import argparse
import json

import numpy as np

from ..codecs.time_prediction import FEATURES
from ..utils import logger

DROP = {"type", "time", "n", "entropy"}


def huber_weights(resid, delta):
    a = np.abs(resid)
    return np.where(a <= delta, 1.0, delta / np.maximum(a, 1e-12))


def fit_huber_nonneg(X, y, l1=1e-3, iters=25, delta=None):
    """Huber IRLS on standardized features, then nonnegativity projection
    (weights >= 0 like l1l1.py's bound constraints) with a bias refit."""
    n, d = X.shape
    mu = X.mean(axis=0)
    sd = np.maximum(X.std(axis=0), 1e-9)
    Xs = np.column_stack([(X - mu) / sd, np.ones(n)])
    delta = delta if delta is not None else max(1.4826 * np.median(np.abs(y - np.median(y))), 1e-9)

    w = np.linalg.lstsq(Xs, y, rcond=None)[0]
    for _ in range(iters):
        resid = y - Xs @ w
        sw = huber_weights(resid, delta)
        A = (Xs * sw[:, None]).T @ Xs + l1 * np.eye(d + 1)
        b = (Xs * sw[:, None]).T @ y
        w = np.linalg.solve(A, b)

    # back to original scale, project weights >= 0, refit bias robustly
    w_orig = w[:d] / sd
    bias = float(w[d] - (w[:d] * mu / sd).sum())
    w_orig = np.maximum(w_orig, 0.0)
    resid = y - X @ w_orig
    bias = float(np.median(resid))
    return bias, w_orig


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("profile")
    ap.add_argument("--out")
    ap.add_argument("--l1", type=float, default=1e-3)
    args = ap.parse_args()

    rows = [json.loads(line) for line in open(args.profile) if line.strip()]
    feats = [f for f in FEATURES if f not in DROP]
    out_lines = []
    for t in sorted(set(r["type"] for r in rows)):
        sub = [r for r in rows if r["type"] == t]
        X = np.array([[r[f] for f in feats] for r in sub], dtype=np.float64)
        y = np.array([r["time"] for r in sub], dtype=np.float64)
        bias, w = fit_huber_nonneg(X, y, l1=args.l1)
        parts = [f"type {t}", f"bias {bias:.6g}"]
        parts += [f"{f} {wi:.6g}" for f, wi in zip(feats, w)]
        line = " ".join(parts)
        out_lines.append(line)
        resid = y - X @ w - bias
        logger(f"type {t}: n={len(sub)} mae={np.abs(resid).mean():.1f}ns")

    text = "\n".join(out_lines) + "\n"
    if args.out:
        open(args.out, "w").write(text)
        logger(f"weights written to {args.out}")
    else:
        print(text, end="")


if __name__ == "__main__":
    main()
