"""join_dev_us_per_query: the profiler's device time of K3, the join and
pack (csrc/join.cu), over the traced window, per query answered."""

JOIN_KERNELS = ("join_kernel",)


def read(run):
    if run.trace is None or not run.queries:
        return None
    hits = [v for name, v in run.trace["kernels"].items() if any(k in name for k in JOIN_KERNELS)]
    return sum(s for _, s in hits) / run.queries * 1e6 if hits else None
