"""dispatch_us_per_query: host seconds in ResidentEngine.dispatch over
the window (the plan arrays' uploads, the decode and join launches, the
download's enqueue), per query answered."""


def read(run):
    return sum(run.dispatch_s) / run.queries * 1e6 if run.queries else None
