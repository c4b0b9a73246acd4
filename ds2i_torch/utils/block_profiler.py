"""Per-block access profiler (block_profiler.hpp): term_id -> counts[2 *
num_blocks] (docs, freqs interleaved), dumped as `term\\tc0 c1...` TSV.

Divergence note: the reference counts individual block decodes of its
cursor enumerators (block_posting_list.hpp:316-330). The resident engine
decodes whole lists per query batch — which is its true cost model — so
every block of an accessed list is counted once per access (docs always,
freqs when the op scores). The λ optimizer consumes the same format.
"""

import numpy as np


class BlockProfiler:
    def __init__(self):
        self.counts = {}

    def open_list(self, term_id, blocks):
        if term_id not in self.counts:
            self.counts[term_id] = np.zeros(2 * blocks, dtype=np.uint32)
        return self.counts[term_id]

    def count_list(self, term_id, codec, n=None, with_freqs=True):
        if n is None:
            return
        blocks = -(-n // codec.block_size)
        c = self.open_list(term_id, blocks)
        c[0::2] += 1
        if with_freqs:
            c[1::2] += 1

    def dump(self, stream):
        for term_id in sorted(self.counts):
            c = self.counts[term_id]
            stream.write(f"{term_id}\t" + " ".join(str(int(x)) for x in c) + "\n")
