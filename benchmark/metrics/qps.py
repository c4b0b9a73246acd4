"""qps: every query answered in the window over the window's seconds
(host clock, from the first batch's draw to the last batch's results)."""


def read(run):
    return run.queries / run.seconds if run.seconds > 0 else None
