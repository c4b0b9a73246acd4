"""Process-level configuration from environment variables.

Equivalent of the reference's env-var configuration singleton
(configuration.hpp:10-47). Same variable names and defaults so existing
run scripts keep working.
"""

import os


def _env(name, default, cast):
    val = os.environ.get(name)
    if not val:
        return default
    if cast is bool:
        return val.lower() in ("1", "true", "yes", "on")
    return cast(val)


class Configuration:
    _instance = None

    def __init__(self):
        self.eps1 = _env("DS2I_EPS1", 0.03, float)
        self.eps2 = _env("DS2I_EPS2", 0.3, float)
        self.fix_cost = _env("DS2I_FIXCOST", 64, int)
        self.log_partition_size = _env("DS2I_LOG_PART", 7, int)
        self.worker_threads = _env("DS2I_THREADS", os.cpu_count() or 1, int)
        self.heuristic_greedy = _env("DS2I_HEURISTIC_GREEDY", False, bool)
        # out-of-core sort budget for the hybrid lambda stream; mirrors the
        # reference's fixed 16 GiB stxxl::sort budget
        # (optimal_hybrid_index.cpp:54)
        self.sort_budget = _env("DS2I_SORT_BUDGET", 16 << 30, int)

    @classmethod
    def get(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls):
        """Re-read env vars (used by tests)."""
        cls._instance = None
