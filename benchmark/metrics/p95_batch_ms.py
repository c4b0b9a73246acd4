"""p95_batch_ms: the 95th percentile, over every batch of the window, of
the host-clock time from the start of prepare until the results are in
hand; in a closed loop every query of a batch waits exactly that long."""

import numpy as np


def read(run):
    return float(np.percentile(run.batch_ms, 95)) if run.batch_ms else None
