"""Blocked posting lists + block_freq_index container.

Same layout as the reference (block_posting_list.hpp:13-53):
  vbyte(n); u32 block_maxs[blocks] (last docid per block);
  u32 block_endpoints[blocks-1] (byte offset after each block, relative to
  the first block's start); per block: codec(docs d-gaps, sum_of_values =
  last - base - (size-1)), then codec(freqs - 1, sum unknown).
d-gaps: docs[i] - prev - 1 (first gap = docid itself).

Container (block_freq_index.hpp): one flat byte array of all lists + an
EF-coded endpoint directory. `get_blocks`/`write_blocks` expose raw block
bytes for re-encoding — the mechanism the WSDM'15 hybrid optimizer uses.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..bitvec import BitVector, BitVectorBuilder
from ..bitvec.bitvector import ceil_div
from ..codecs import BLOCK_CODECS
from ..codecs.interpolative import UNKNOWN_SUM
from ..codecs.vbyte import TightVariableByte
from ..global_params import GlobalParameters
from ..sequences.base import Enumerator
from ..sequences.ef import CompactEliasFano
from .freq_index import DocumentEnumerator

_U32 = np.uint32


@dataclass
class BlockData:
    """Raw block bytes + metadata (block_posting_list.hpp:213-284)."""

    index: int
    max: int
    size: int
    doc_gaps_universe: int
    docs_bytes: np.ndarray
    freqs_bytes: np.ndarray


class BlockPostingList:
    @staticmethod
    def write(out_list, n, docs, freqs, codec):
        docs = np.asarray(docs, dtype=np.int64)
        freqs = np.asarray(freqs, dtype=np.int64)
        block_size = codec.block_size
        blocks = ceil_div(n, block_size)

        gaps = np.diff(docs, prepend=-1) - 1  # docs[i] - prev - 1
        body = []
        block_maxs = np.empty(blocks, dtype=_U32)
        endpoints = np.empty(max(blocks - 1, 0), dtype=_U32)
        cursor = 0
        block_base = 0
        for b in range(blocks):
            lo = b * block_size
            hi = min(lo + block_size, n)
            cur = hi - lo
            last_doc = int(docs[hi - 1])
            block_maxs[b] = last_doc
            chunk = []
            codec.encode(gaps[lo:hi].astype(_U32), last_doc - block_base - (cur - 1), cur, chunk)
            codec.encode((freqs[lo:hi] - 1).astype(_U32), UNKNOWN_SUM, cur, chunk)
            blk = np.concatenate([np.asarray(c, dtype=np.uint8).reshape(-1) for c in chunk])
            body.append(blk)
            cursor += len(blk)
            if b != blocks - 1:
                endpoints[b] = cursor
            block_base = last_doc + 1

        out_list.append(TightVariableByte.encode([n]))
        out_list.append(block_maxs.view(np.uint8))
        out_list.append(endpoints.view(np.uint8))
        out_list.extend(body)

    @staticmethod
    def write_blocks(out_list, n, blocks_data, codec):
        """Reassemble a list from (possibly re-encoded) blocks; blocks_data
        must be complete and start with index 0 (write order may differ —
        endpoints are patched, matching block_posting_list.hpp:55-82)."""
        assert blocks_data[0].index == 0
        blocks = len(blocks_data)
        block_maxs = np.zeros(blocks, dtype=_U32)
        endpoints = np.zeros(max(blocks - 1, 0), dtype=_U32)
        chunks = [None] * blocks
        for bd in blocks_data:
            block_maxs[bd.index] = bd.max
            chunks[bd.index] = np.concatenate([bd.docs_bytes, bd.freqs_bytes])
        cursor = 0
        for b in range(blocks):
            cursor += len(chunks[b])
            if b != blocks - 1:
                endpoints[b] = cursor
        out_list.append(TightVariableByte.encode([n]))
        out_list.append(block_maxs.view(np.uint8))
        out_list.append(endpoints.view(np.uint8))
        out_list.extend(chunks)

    @staticmethod
    def parse(data, offset, codec):
        """Returns (n, blocks, maxs, endpoints, blocks_data_offset)."""
        vals, pos = TightVariableByte.decode(data, offset, 1)
        n = int(vals[0])
        blocks = ceil_div(n, codec.block_size)
        maxs = np.frombuffer(bytes(data[pos : pos + 4 * blocks]), dtype="<u4")
        pos += 4 * blocks
        endpoints = np.frombuffer(bytes(data[pos : pos + 4 * (blocks - 1)]), dtype="<u4")
        pos += 4 * (blocks - 1)
        return n, blocks, maxs, endpoints, pos

    @staticmethod
    def decode_list(data, offset, codec):
        """Full vectorized-ish decode -> (docs, freqs) uint64 arrays."""
        n, blocks, maxs, endpoints, pos = BlockPostingList.parse(data, offset, codec)
        block_size = codec.block_size
        docs = np.empty(n, dtype=np.uint64)
        freqs = np.empty(n, dtype=np.uint64)
        block_base = 0
        p = pos
        for b in range(blocks):
            lo = b * block_size
            hi = min(lo + block_size, n)
            cur = hi - lo
            last_doc = int(maxs[b])
            gaps, p = codec.decode(data, p, last_doc - block_base - (cur - 1), cur)
            f1, p = codec.decode(data, p, UNKNOWN_SUM, cur)
            d = np.cumsum(gaps[:cur].astype(np.int64) + 1) - 1 + block_base
            docs[lo:hi] = d
            freqs[lo:hi] = f1[:cur].astype(np.int64) + 1
            block_base = last_doc + 1
        return docs, freqs

    @staticmethod
    def get_blocks(data, offset, codec):
        """Raw per-block byte ranges + metadata for re-encoding."""
        n, blocks, maxs, endpoints, pos = BlockPostingList.parse(data, offset, codec)
        block_size = codec.block_size
        out = []
        block_base = 0
        p = pos
        for b in range(blocks):
            lo = b * block_size
            hi = min(lo + block_size, n)
            cur = hi - lo
            last_doc = int(maxs[b])
            gaps_universe = last_doc - block_base - (cur - 1)
            docs_start = p
            _, p = codec.decode(data, p, gaps_universe, cur)
            freqs_start = p
            _, p = codec.decode(data, p, UNKNOWN_SUM, cur)
            out.append(
                BlockData(
                    index=b,
                    max=last_doc,
                    size=cur,
                    doc_gaps_universe=gaps_universe,
                    docs_bytes=np.array(data[docs_start:freqs_start], dtype=np.uint8),
                    freqs_bytes=np.array(data[freqs_start:p], dtype=np.uint8),
                )
            )
            block_base = last_doc + 1
        return out


class BlockFreqIndex:
    """block_freq_index<Codec> (block_freq_index.hpp:18-143)."""

    codec = None
    index_type_name = None
    profile = False

    def __init__(self, params, num_docs, lists_bytes, endpoints_bv, size):
        self.params = params
        self._num_docs = num_docs
        self.lists = np.asarray(lists_bytes, dtype=np.uint8)
        self.endpoints_bv = endpoints_bv
        self._size = size
        self._endpoints_cache = None
        self.profiler = None  # set by tools/profile_queries

    class Builder:
        def __init__(self, index_cls, num_docs, params, workers=None):
            self.index_cls = index_cls
            self.num_docs = num_docs
            self.params = params
            self.workers = workers
            # ops preserve add order: ("plain", n, docs, freqs) encodes in
            # the native batch at build() when available, ("bytes", chunks)
            # is an eagerly-encoded list (write_blocks / raw / fallback)
            self.ops = []
            self._native_codec = self._native_codec_name()

        def _native_codec_name(self):
            import os

            if os.environ.get("DS2I_NATIVE") == "0":
                return None
            from ..native import BLOCK_CODEC_IDS, available

            if not available():
                return None
            for name, cls in BLOCK_CODECS.items():
                if cls is self.index_cls.codec and name in BLOCK_CODEC_IDS:
                    return name
            return None

        def add_posting_list(self, n, docs, freqs=None, occurrences=None, blocks=None, raw=None):
            if raw is not None:
                self.ops.append(("bytes", [np.asarray(raw, dtype=np.uint8)]))
                return
            if not n:
                raise ValueError("List must be nonempty")
            if blocks is not None:
                out = []
                BlockPostingList.write_blocks(out, n, blocks, self.index_cls.codec)
                self.ops.append(("bytes", out))
                return
            if self._native_codec:
                self.ops.append((
                    "plain", n,
                    np.ascontiguousarray(np.asarray(docs, dtype=np.uint32)[:n]),
                    np.ascontiguousarray(np.asarray(freqs, dtype=np.uint32)[:n]),
                ))
                return
            out = []
            BlockPostingList.write(out, n, docs, freqs, self.index_cls.codec)
            self.ops.append(("bytes", out))

        def _encode_all(self):
            """Encode every pending op into (chunks, endpoints). Plain ops
            go through ONE thread-parallel native batch (the reference
            encodes inside semiasync_queue worker threads; here whole-index
            batching replaces the queue, like the EF fast path)."""
            plain = [op for op in self.ops if op[0] == "plain"]
            slices = None
            if plain:
                from ..native import block_write_batch_native

                offs = np.zeros(len(plain) + 1, dtype=np.int64)
                offs[1:] = np.cumsum([op[1] for op in plain])
                res = block_write_batch_native(
                    np.concatenate([op[2] for op in plain]) if plain else np.zeros(0, np.uint32),
                    np.concatenate([op[3] for op in plain]) if plain else np.zeros(0, np.uint32),
                    offs, self._native_codec, self.workers,
                )
                if res is not None:
                    buf, ends = res
                    starts = np.concatenate([[0], ends[:-1]])
                    slices = [buf[s:e] for s, e in zip(starts, ends)]
            chunks = []
            endpoints = [0]
            nbytes = 0
            pi = 0
            for op in self.ops:
                if op[0] == "plain":
                    if slices is not None:
                        out = [slices[pi]]
                        pi += 1
                    else:  # native missing: pure-Python fallback
                        out = []
                        BlockPostingList.write(out, op[1], op[2], op[3], self.index_cls.codec)
                else:
                    out = op[1]
                for c in out:
                    chunks.append(c)
                    nbytes += len(c)
                endpoints.append(nbytes)
            return chunks, endpoints

        def build(self):
            self.chunks, self.endpoints = self._encode_all()
            lists_bytes = (
                np.concatenate(self.chunks) if self.chunks else np.zeros(0, dtype=np.uint8)
            )
            size = len(self.endpoints) - 1
            eb = BitVectorBuilder()
            if size:
                CompactEliasFano.write(
                    eb,
                    np.asarray(self.endpoints[:size], dtype=np.uint64),
                    max(len(lists_bytes), 1),
                    size,
                    self.params,
                )
            return self.index_cls(
                self.params, self.num_docs, lists_bytes, eb.build(), size
            )

    @classmethod
    def builder(cls, num_docs, params=None, workers=None):
        return cls.Builder(cls, num_docs, params or GlobalParameters(), workers)

    def __len__(self):
        return self._size

    def size(self):
        return self._size

    def num_docs(self):
        return self._num_docs

    def endpoints(self):
        if self._endpoints_cache is None:
            if self._size == 0:
                self._endpoints_cache = np.zeros(0, dtype=np.uint64)
            else:
                self._endpoints_cache = CompactEliasFano.decode(
                    self.endpoints_bv, 0, max(len(self.lists), 1), self._size, self.params
                )
        return self._endpoints_cache

    def get_offset(self, i):
        return int(self.endpoints()[i])

    def decode_list(self, i):
        docs, freqs = BlockPostingList.decode_list(self.lists, self.get_offset(i), self.codec)
        if self.profiler is not None:
            self.profiler.count_list(i, self.codec, n=len(docs))
        return docs, freqs

    def list_length(self, i):
        vals, _ = TightVariableByte.decode(self.lists, self.get_offset(i), 1)
        return int(vals[0])

    def occurrences(self, i):
        return int(self.decode_list(i)[1].sum())

    def get_blocks(self, i):
        return BlockPostingList.get_blocks(self.lists, self.get_offset(i), self.codec)

    def __getitem__(self, i):
        docs, freqs = self.decode_list(i)
        docs_enum = Enumerator(docs, self._num_docs)

        class _Freqs:
            def move(self, pos):
                return (pos, int(freqs[pos]))

        return DocumentEnumerator(docs_enum, _Freqs())

    def warmup(self, i):
        _ = self.lists[self.get_offset(i)]

    # -- persistence ---------------------------------------------------------

    def tree(self):
        return {
            "m_params": self.params.tree(),
            "m_size": self._size,
            "m_num_docs": self._num_docs,
            "m_endpoints": self.endpoints_bv.tree(),
            "m_lists": self.lists,
        }

    @classmethod
    def from_tree(cls, t):
        params = GlobalParameters.from_tree(t["m_params"])
        return cls(
            params,
            int(t["m_num_docs"]),
            np.asarray(t["m_lists"], dtype=np.uint8),
            BitVector.from_tree(t["m_endpoints"]),
            int(t["m_size"]),
        )


from .types import INDEX_TYPES  # noqa: E402  (registry extension)

for _name, _codec_name in [
    ("block_optpfor", "optpfor"),
    ("block_varint", "varint"),
    ("block_interpolative", "interpolative"),
    ("block_qmx", "qmx"),
    ("block_mixed", "mixed"),
]:
    INDEX_TYPES[_name] = type(
        f"BlockFreqIndex_{_codec_name}",
        (BlockFreqIndex,),
        {"codec": BLOCK_CODECS[_codec_name], "index_type_name": _name},
    )
