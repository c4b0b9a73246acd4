"""collect_us_per_query: host seconds in ResidentEngine.collect over the
window, per query answered. The traced run synchronises the device just
before each collect, so this is the download's unpack alone."""


def read(run):
    return sum(run.collect_s) / run.queries * 1e6 if run.queries else None
