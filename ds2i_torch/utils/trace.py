"""Spans of the serving path on torch.profiler's clock.

The engine marks its stages with `span(name)`. Under a running
`torch.profiler.profile` a span is a `record_function`, so the stages
land in the profiler's chrome trace beside the CUPTI kernel and copy
events, on one clock and nested as they ran. With no profiler recording,
`span` returns one shared no-op context: no allocation and no
`record_function` call (which costs microseconds even with no profiler),
only a check of the profiler's flag. Tracing is turned on by running the
engine under `torch.profiler.profile`; there is no other switch.

Every name starts with "ds2i." so that the program's spans never collide
with a caller's own.
"""

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name):
    """A context marking the stage `name` in a running profiler's trace;
    the shared no-op context when no profiler is recording."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
