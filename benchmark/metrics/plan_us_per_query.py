"""plan_us_per_query: host seconds in ResidentEngine.prepare over the
window (the host planner, and in pruned plans the probe's sub-plan on
the device), per query answered."""


def read(run):
    return sum(run.prepare_s) / run.queries * 1e6 if run.queries else None
