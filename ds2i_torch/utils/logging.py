"""Logging / metrics utilities.

Equivalents of the reference's util.hpp:35-49 (timestamped logger to stderr),
util.hpp:148-255 (`stats_line`: one JSON object per line to stdout — the
metrics system every CLI tool emits), and index_build_utils.hpp:9-31
(progress logger every 1M items).
"""

import json
import sys
import time


def logger(msg):
    ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    print(f"{ts}: {msg}", file=sys.stderr, flush=True)


def stats_line(**kwargs):
    """Emit one JSON object per line on stdout (stats_line parity)."""

    def _clean(v):
        if isinstance(v, (list, tuple)):
            return [_clean(x) for x in v]
        if isinstance(v, dict):
            return {str(k): _clean(x) for k, x in v.items()}
        if hasattr(v, "item"):
            return v.item()
        return v

    print(json.dumps({k: _clean(v) for k, v in kwargs.items()}), flush=True)


class ProgressLogger:
    def __init__(self, name="items", every=1_000_000):
        self.name = name
        self.every = every
        self.count = 0
        self.t0 = time.time()

    def done_item(self, n=1):
        self.count += n
        if self.count % self.every < n:
            logger(f"processed {self.count} {self.name} in {time.time() - self.t0:.1f}s")

    def log(self):
        logger(f"processed {self.count} {self.name} in {time.time() - self.t0:.1f}s")
