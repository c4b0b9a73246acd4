"""Scores-only top-k queue (queries.hpp:152-197). The reference keeps no
docids — parity target is the sorted descending score list."""

import heapq


class TopKQueue:
    def __init__(self, k):
        self.k = k
        self.q = []  # min-heap of scores

    def insert(self, score):
        if len(self.q) < self.k:
            heapq.heappush(self.q, score)
            return True
        if score > self.q[0]:
            heapq.heapreplace(self.q, score)
            return True
        return False

    def would_enter(self, score):
        return len(self.q) < self.k or score > self.q[0]

    def threshold(self):
        return self.q[0] if len(self.q) >= self.k else None

    def finalize(self):
        return sorted(self.q, reverse=True)

    def clear(self):
        self.q = []
