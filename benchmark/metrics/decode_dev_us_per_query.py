"""decode_dev_us_per_query: the profiler's device time of the decode
kernels (csrc/{pair,optpfor,optpfor_s16,interp,varint,qmx}_decode.cu)
over the traced window, per query answered. The kernels are told from
the others by their names."""

DECODE_KERNELS = ("pair_part_kernel", "optpfor_part_kernel", "optpfor_s16_part_kernel",
                  "interp_part_kernel", "varint_part_kernel", "qmx_part_kernel")


def decode_seconds(trace):
    """(launches, seconds) of the decode kernels in a trace's reading."""
    hits = [v for name, v in trace["kernels"].items()
            if any(k in name for k in DECODE_KERNELS)]
    return sum(n for n, _ in hits), sum(s for _, s in hits)


def read(run):
    if run.trace is None or not run.queries:
        return None
    n, s = decode_seconds(run.trace)
    return s / run.queries * 1e6 if n else None
