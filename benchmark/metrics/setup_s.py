"""setup_s: process start to the first timed batch (imports, the kernels
from their cache, the built index, wand data and engine state, the
warm-up batches, the window's queries drawn ahead). A checkout's first
run builds the configuration in a child process; that build is timed
apart and left out."""


def read(run):
    return run.setup_s
