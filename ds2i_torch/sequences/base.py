"""Sequence-layer protocol and the generic enumerator.

Every sequence type exposes the reference's uniform static contract
(SURVEY.md §1 L2): ``bitsize(params, universe, n)``,
``write(bvb, values, universe, n, params)``, ``decode(bv, offset, universe,
n, params) -> np.ndarray`` and ``enumerator(...)``.

TPU-first design note: the reference implements stateful skip-pointer
cursors per type (compact_elias_fano.hpp:138-417 etc.). Here every type
provides a *vectorized full decode* (the operation the batched device
kernels perform per superblock), and cursor semantics are provided by ONE
generic `Enumerator` over the decoded array. Observable behavior matches
the reference exactly:

- fresh enumerator is positioned at ``(n, universe)``
- ``move(pos)``  -> (pos, values[pos]) or (n, universe) at the end
- ``next()``     -> advance one
- ``next_geq(lb)``: if lb equals the current value, stays put (the
  reference's early-out, compact_elias_fano.hpp:183-185); otherwise the
  first-of-run successor via binary search; ``(n, universe)`` if none.
- ``prev_value()`` -> values[pos-1], 0 at position 0.
"""

import numpy as np

INF_BITS = 1 << 62  # stands in for the reference's uint64(-1) "impossible" cost


class Enumerator:
    __slots__ = ("values", "universe", "n", "pos", "val")

    def __init__(self, values, universe):
        self.values = np.asarray(values, dtype=np.uint64)
        self.universe = int(universe)
        self.n = len(self.values)
        self.pos = self.n
        self.val = self.universe

    def size(self):
        return self.n

    def position(self):
        return self.pos

    def value(self):
        return (self.pos, self.val)

    def _at(self, pos):
        self.pos = pos
        self.val = int(self.values[pos]) if pos < self.n else self.universe
        return (self.pos, self.val)

    def move(self, position):
        assert position <= self.n
        return self._at(int(position))

    def next(self):
        assert self.pos < self.n
        return self._at(self.pos + 1)

    def next_geq(self, lower_bound):
        lower_bound = int(lower_bound)
        if lower_bound == self.val:
            return (self.pos, self.val)
        return self._at(int(np.searchsorted(self.values, lower_bound, side="left")))

    def prev_value(self):
        if self.pos == 0:
            return 0
        return int(self.values[self.pos - 1])
