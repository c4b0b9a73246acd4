"""Binary collection formats (reference README.md:152-174).

A binary sequence is `<len u32><u32 ...>` little-endian. A collection is
`<basename>.docs` (first a singleton sequence holding num_docs, then one
docid sequence per term), `<basename>.freqs` (one aligned sequence per
term), `<basename>.sizes` (one sequence of per-document lengths).

Reader is a numpy memmap (zero-copy, like the reference's
boost mapped_file, binary_collection.hpp:19-33); sequences come out as
numpy views. Empty sequences are skipped on iteration, matching
binary_collection.hpp:127-142.
"""

import numpy as np

_U32 = np.uint32


class BinaryCollection:
    def __init__(self, filename):
        self.data = np.memmap(filename, dtype="<u4", mode="r")
        self._offsets = None  # lazy: (start, length) pairs per non-empty sequence

    def offsets(self):
        """List of (start, n) for each non-empty sequence."""
        if self._offsets is None:
            out = []
            data = self.data
            size = len(data)
            pos = 0
            while pos < size:
                n = int(data[pos])
                pos += 1
                if n == 0:
                    continue  # skip empty seqs
                n = min(n, size - pos)  # file might be truncated
                out.append((pos, n))
                pos += n
            self._offsets = out
        return self._offsets

    def __len__(self):
        return len(self.offsets())

    def __getitem__(self, i):
        pos, n = self.offsets()[i]
        return self.data[pos : pos + n]

    def __iter__(self):
        for pos, n in self.offsets():
            yield self.data[pos : pos + n]


class BinaryFreqCollection:
    """Paired .docs/.freqs (binary_freq_collection.hpp:14-41)."""

    def __init__(self, basename):
        self.docs = BinaryCollection(str(basename) + ".docs")
        self.freqs = BinaryCollection(str(basename) + ".freqs")
        first = self.docs[0]
        if len(first) != 1:
            raise ValueError("First sequence should only contain number of documents")
        self.num_docs = int(first[0])

    def __len__(self):
        return len(self.docs) - 1

    def __getitem__(self, i):
        return self.docs[i + 1], self.freqs[i]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def read_sizes(basename):
    """Document sizes from `<basename>.sizes` (single binary sequence)."""
    return np.asarray(BinaryCollection(str(basename) + ".sizes")[0])


def write_binary_collection(filename, sequences):
    """Write sequences (iterable of int arrays) in `<len><data...>` format."""
    with open(filename, "wb") as f:
        for seq in sequences:
            arr = np.asarray(seq, dtype="<u4")
            np.array([len(arr)], dtype="<u4").tofile(f)
            arr.tofile(f)
