"""freq_index: the Elias-Fano-family index container (freq_index.hpp:11-251).

Two bitvector collections (docs, freqs). Per-list header inside the docs
slice: gamma_nonzero(occurrences), then n in ceil_log2(occurrences+1) bits
if occurrences > 1. Docs written with universe = num_docs; freqs written as
a positive sequence with universe = occurrences + 1.

TPU-first addition: ``decode_list(i)`` returns the full (docs, freqs)
arrays in one vectorized shot — the primitive the batched device query
engine consumes — while ``__getitem__`` provides the reference's cursor
(document_enumerator) semantics for the oracle query layer.
"""

import numpy as np

from ..bitvec import BitReader, BitVectorBuilder, read_gamma_nonzero, write_gamma_nonzero
from ..bitvec.bitvector import ceil_log2
from ..global_params import GlobalParameters
from ..parallel import OrderedBuildPool
from .bitvector_collection import BitvectorCollection

_U64 = np.uint64


class DocumentEnumerator:
    """Couples a docs enumerator with lazy freq access (freq_index.hpp:116-189)."""

    __slots__ = ("_docs", "_freqs", "_pos", "_docid")

    def __init__(self, docs_enum, freqs_enum):
        self._docs = docs_enum
        self._freqs = freqs_enum
        self.reset()

    def reset(self):
        pos, docid = self._docs.move(0)
        self._pos, self._docid = pos, docid

    def next(self):
        self._pos, self._docid = self._docs.next()

    def next_geq(self, lower_bound):
        self._pos, self._docid = self._docs.next_geq(lower_bound)

    def move(self, position):
        self._pos, self._docid = self._docs.move(position)

    def docid(self):
        return self._docid

    def freq(self):
        return self._freqs.move(self._pos)[1]

    def position(self):
        return self._pos

    def size(self):
        return self._docs.size()


class FreqIndex:
    """Parameterized by (docs_sequence_type, freqs_sequence_type); see
    index.types for the registry mirroring index_types.hpp:18-32."""

    docs_sequence_type = None
    freqs_sequence_type = None

    def __init__(self, params, num_docs, docs_sequences, freqs_sequences):
        self.params = params
        self._num_docs = num_docs
        self.docs_sequences = docs_sequences
        self.freqs_sequences = freqs_sequences
        self._header_cache = {}

    class Builder:
        def __init__(self, index_cls, num_docs, params, workers=None):
            self.index_cls = index_cls
            self.num_docs = num_docs
            self.params = params
            self.workers = workers
            self.docs_builder = BitvectorCollection.Builder(params)
            self.freqs_builder = BitvectorCollection.Builder(params)
            self.pool = OrderedBuildPool(workers=workers)
            self._fast_mode = self._fast_eligible()
            self._fast = [] if self._fast_mode else False
            self._fast_occs = []

        def _fast_eligible(self):
            """Returns the native fast-path mode ("ef" via the batched EF
            writer; "single"/"uniform"/"opt" via the batched sequence
            writer) or False for the generic OrderedBuildPool path."""
            import os

            if os.environ.get("DS2I_NATIVE") == "0":
                return False
            from ..native import available
            from ..sequences.ef import CompactEliasFano, StrictEliasFano
            from ..sequences.selectors import PositiveSequence

            cls = self.index_cls
            if not available():
                return False
            if (
                cls.docs_sequence_type is CompactEliasFano
                and isinstance(cls.freqs_sequence_type, type)
                and issubclass(cls.freqs_sequence_type, PositiveSequence)
                and cls.freqs_sequence_type.base_sequence_type is StrictEliasFano
            ):
                return "ef"
            name = getattr(cls, "index_type_name", None)
            if name in ("single", "uniform", "opt"):
                return name
            return False

        def add_posting_list(self, n, docs, freqs, occurrences):
            if not n:
                raise ValueError("List must be nonempty")
            docs = np.asarray(docs, dtype=_U64)
            freqs = np.asarray(freqs, dtype=_U64)
            if self._fast is not False and self._fast is not None:
                self._fast.append((docs, freqs))
                self._fast_occs.append(int(occurrences))
                return
            cls, num_docs, params = self.index_cls, self.num_docs, self.params

            def prepare():
                docs_bits = BitVectorBuilder()
                write_gamma_nonzero(docs_bits, occurrences)
                if occurrences > 1:
                    docs_bits.append_bits(n, ceil_log2(occurrences + 1))
                cls.docs_sequence_type.write(docs_bits, docs, num_docs, n, params)
                freqs_bits = BitVectorBuilder()
                cls.freqs_sequence_type.write(freqs_bits, freqs, occurrences + 1, n, params)
                return docs_bits, freqs_bits

            def commit(result):
                docs_bits, freqs_bits = result
                self.docs_builder.append(docs_bits)
                self.freqs_builder.append(freqs_bits)

            self.pool.add_job(prepare, commit, 2 * n)

        def build(self):
            if self._fast:
                from .fast_build import build_ef_collections, build_seq_collections

                args = (
                    [d for d, _ in self._fast],
                    [f for _, f in self._fast],
                    self._fast_occs,
                    self.num_docs,
                    self.params,
                )
                if self._fast_mode == "ef":
                    built = build_ef_collections(*args, workers=self.workers)
                else:
                    built = build_seq_collections(self._fast_mode, *args, workers=self.workers)
                if built is not None:
                    docs_coll, freqs_coll = built
                    return self.index_cls(self.params, self.num_docs, docs_coll, freqs_coll)
                # native batch unavailable after all: replay through the pool
                deferred, self._fast = self._fast, False
                for (docs, freqs), occ in zip(deferred, self._fast_occs):
                    self.add_posting_list(len(docs), docs, freqs, occ)
            self.pool.complete()
            return self.index_cls(
                self.params,
                self.num_docs,
                self.docs_builder.build(),
                self.freqs_builder.build(),
            )

    @classmethod
    def builder(cls, num_docs, params=None, workers=None):
        return cls.Builder(cls, num_docs, params or GlobalParameters(), workers)

    def __len__(self):
        return self.docs_sequences.size()

    def size(self):
        return self.docs_sequences.size()

    def num_docs(self):
        return self._num_docs

    def _header(self, i):
        """(occurrences, n, docs_data_offset) for list i."""
        h = self._header_cache.get(i)
        if h is None:
            r = BitReader(self.docs_sequences.bits(), self.docs_sequences.get_offset(i))
            occurrences = read_gamma_nonzero(r)
            n = 1
            if occurrences > 1:
                n = r.take(ceil_log2(occurrences + 1))
            h = (occurrences, n, r.position())
            self._header_cache[i] = h
        return h

    def __getitem__(self, i):
        occurrences, n, docs_offset = self._header(i)
        docs_enum = self.docs_sequence_type.enumerator(
            self.docs_sequences.bits(), docs_offset, self._num_docs, n, self.params
        )
        freqs_enum = self.freqs_sequence_type.enumerator(
            self.freqs_sequences.bits(),
            self.freqs_sequences.get_offset(i),
            occurrences + 1,
            n,
            self.params,
        )
        return DocumentEnumerator(docs_enum, freqs_enum)

    def decode_list(self, i):
        """Vectorized full decode: (docids u64[n], freqs u64[n])."""
        occurrences, n, docs_offset = self._header(i)
        docs = self.docs_sequence_type.decode(
            self.docs_sequences.bits(), docs_offset, self._num_docs, n, self.params
        )
        freqs = self.freqs_sequence_type.decode(
            self.freqs_sequences.bits(),
            self.freqs_sequences.get_offset(i),
            occurrences + 1,
            n,
            self.params,
        )
        return docs, freqs

    def list_length(self, i):
        return self._header(i)[1]

    def occurrences(self, i):
        return self._header(i)[0]

    def warmup(self, i):
        self._header(i)

    # -- persistence ---------------------------------------------------------

    def tree(self):
        return {
            "m_params": self.params.tree(),
            "m_num_docs": self._num_docs,
            "m_docs_sequences": self.docs_sequences.tree(),
            "m_freqs_sequences": self.freqs_sequences.tree(),
        }

    @classmethod
    def from_tree(cls, t):
        params = GlobalParameters.from_tree(t["m_params"])
        return cls(
            params,
            int(t["m_num_docs"]),
            BitvectorCollection.from_tree(t["m_docs_sequences"], params),
            BitvectorCollection.from_tree(t["m_freqs_sequences"], params),
        )
