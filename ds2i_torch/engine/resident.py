"""Resident-table batched query engine on PyTorch: decode-unique +
block-gather + row-sort join, with block-max pruning.

Port of ds2i_tpu/engine/resident.py for EF-family indexes (ef, single,
uniform, opt) in pair mode and for the block indexes (block_optpfor,
block_varint, block_interpolative, block_qmx, block_mixed) in split mode. Ops: and_counts, or_counts,
ranked_or, ranked_and (exhaustive, or prune=True: intersection block
skipping, bench.py's and_skip), wand and maxscore (block-max pruned top-k
OR). Everything static lives on the device from engine init: the
compressed words, the per-tile decode fields and, once ranked ops run,
the norm cache. A query batch uploads only its layout and downloads only
results.

Per part (one host plan each), on the device:

  1. decode each UNIQUE tile once, by hand-written CUDA kernels on the
     card, from CTA tables built with the plan (ops.block_decode.
     PartLayout), each row reading its tile's fields from the resident
     tables: pair mode, one launch over every (W, WL, T) group of the
     part, both streams (ops.pair_decode.pair_decode_part); split mode,
     each stream in its own group-major order, one launch per kernel
     (OptPFor with resident exception patches or, past
     RESIDENT_WORD_LIMIT, with its exceptions decoded in the pass;
     Varint-G8IU, QMX, interpolative) and stream (ops.block_decode.
     split_decode_part): freqs first, then docs, whose launches also
     realign the freqs to the docs order (blkperm). Either way the docs
     launch writes the doc-term weights f/(f+den) from the init-time
     norm cache (or presence flags) beside the docids
  2. join and pack (ops.join.join_part, K3: one launch of csrc/join.cu,
     a second where a row spans several CTAs): each query row's real
     directory entries name its terms' 32-slot blocks; each posting finds
     its docid in the row's other term slots by binary search, the
     highest slot holding it sums the run in the JAX engine's shifted-add
     order, AND/OR counts and top-k per row, the real rows packed
     (scaled f16 when the plan allows)
  3. download

Pruned plans decode only the tiles whose blocks survive the host
planner's block-max directory (_pruned_directory). Its metadata (per
32-slot block: max weight, max and first docid) comes from one pass of
the blockmax kernel (ops.blockmax), either over every tile decoded with
the served weights (_ensure_blockmax) or over the original collection's
slot planes (build_blockmax); both give byte-identical tables. The
probes that set the thresholds run one-shot sub-plans on the device
inside prepare.

The host planner (prepare/_part_plan/_pruned_directory/_order_groups) is
numpy, copied from the JAX engine as it stands with its knobs fixed at
their defaults; its plan arrays and directories equal the JAX engine's
(tests/test_torch_resident.py, tests/test_torch_prune.py). Semantics
match the oracle layer: same doc sets and counts, f32 scores accumulated
in query term order.

Scale-out and restarts, as in the JAX engine: devices= replicates the
resident state and round-robins the parts over the replicas; query_dfs=
and term_remap= serve one doc-range shard of a larger collection
(parallel.doc_sharded); cache_dir= keeps what the engine derives from
the index (tile tables, exception patches, the norm cache, the block-max
tables, the probe thresholds) in files keyed by the index, the norm
lengths and the backend, so a restart loads instead of walking and
decoding again.

Tracing: the stages of prepare, dispatch and collect are marked by
utils.trace.span ("ds2i.parse", "ds2i.prune", "ds2i.probe",
"ds2i.theta_cache", "ds2i.split", "ds2i.layout", "ds2i.upload",
"ds2i.decode", "ds2i.join", "ds2i.download", "ds2i.wait",
"ds2i.unpack"), which record only under a running torch.profiler; every
plan carries its counters in plan["counts"] (PLAN_COUNTS).
"""

import contextlib
import hashlib
import json
import math
import os
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..queries.bm25 import BM25
from ..queries.parsing import query_freqs
from ..utils.logging import logger
from ..utils.trace import span

from ..ops import block_decode, blockmax, join, pair_decode
from .block_tiles import BF_EX_BASE, build_block_tables, build_exception_patches
from .state import resident_state_from_arrays
from .tiles import F_NVALS, N_FIELDS, TILE, TileTables, build_tile_tables

_F32 = np.float32
_I32 = np.int32
_PACKAGE = __name__.split(".")[0]
BLOCK = 32
# A block index's resident words (index bytes, then the exception patch
# pairs) are addressed by the int32 word cursors of the field tables: the
# index alone must stay under this many words, and past it with its patch
# pairs the engine decodes the exceptions in the pass instead ("opt"
# statics, K1s), as the JAX engine does (its ex_patch = 0 there).
RESIDENT_WORD_LIMIT = 2**31
# a plan's counters (plan["counts"]), from host arrays the planner holds
# (none reads the device): the blocks of the batch's query terms before
# any pruning, the final directory's entries, the rows the probe's
# sub-plan ran, the rows whose final AND directory was recomputed with
# the probe's threshold (_refine_and_directory), the blocks the part
# layouts decode, and the bytes dispatch copies to the device for the
# plan. The probe's sub-plan keeps counts of its own.
PLAN_COUNTS = ("dir_blocks", "dir_kept", "probe_rows", "refined_rows", "decode_blocks",
               "upload_bytes")


def _plan(plans, n, k, ops, **counts):
    """A plan over its parts: its counts (PLAN_COUNTS) as given,
    decode_blocks summed over the parts, the others 0."""
    counts = {**dict.fromkeys(PLAN_COUNTS, 0), **counts,
              "decode_blocks": sum(p["decode_blocks"] for p in plans)}
    return {"plans": plans, "n": n, "k": k, "ops": ops, "counts": counts}


def _pow2_at_least(x, lo=1):
    v = lo
    while v < int(x):
        v *= 2
    return v


def _concat_collection(collection):
    """Concatenate a collection's postings list-major: returns
    (docs_all, freqs_all, list_n) int64 arrays. Vectorized for
    BinaryFreqCollection (one fancy-index per memmapped stream); any
    iterable of (docs, freqs) pairs works as a fallback."""
    docs_obj = getattr(collection, "docs", None)
    freqs_obj = getattr(collection, "freqs", None)
    if docs_obj is not None and hasattr(docs_obj, "offsets"):
        def flat(bc, skip_first=False):
            offs = bc.offsets()[1:] if skip_first else bc.offsets()
            starts = np.fromiter((p for p, _ in offs), dtype=np.int64, count=len(offs))
            lens = np.fromiter((n for _, n in offs), dtype=np.int64, count=len(offs))
            tot = int(lens.sum())
            ex = np.cumsum(lens) - lens
            idx = np.repeat(starts - ex, lens) + np.arange(tot, dtype=np.int64)
            return np.asarray(bc.data[idx], dtype=np.int64), lens

        docs_all, dl = flat(docs_obj, skip_first=True)
        freqs_all, fl = flat(freqs_obj)
        if not np.array_equal(dl, fl):
            raise ValueError("docs/freqs sequence lengths differ")
        return docs_all, freqs_all, dl
    ds, fs, ln = [], [], []
    for docs, freqs in collection:
        ds.append(np.asarray(docs, dtype=np.int64))
        fs.append(np.asarray(freqs, dtype=np.int64))
        ln.append(len(ds[-1]))
    if not ds:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    return np.concatenate(ds), np.concatenate(fs), np.array(ln, dtype=np.int64)


def _on(device):
    """Make `device` the current CUDA device (the kernels launch on the
    thread's current device); a no-op on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _bm_chunk_rows(max_part_slots, total):
    """Rows per chunk of build_blockmax's collection pass, a function of
    the engine's slot budget and the total block count (the JAX engine's
    canonical chunk; here it bounds the device memory of one chunk)."""
    budget = max(min(int(max_part_slots), 1 << 25), 1 << 12)
    return min(max(budget // BLOCK, 1), _pow2_at_least(max(total, 1)))


# -- device functions (plain functions on tensors) ---------------------------


def _norm_cache_step(docs_words, tiles_docs, norm_den, gtile_ids, layout, num_docs):
    """One-time decode of EVERY tile's docids -> per-slot BM25
    denominators, (total_blocks, 32) f32 in the canonical group-major
    block order (docs stream only, one docs-mode launch of the part's
    kernels). layout: the PartLayout of the docs groups."""
    if layout.pair:
        d, _ = pair_decode.pair_decode_part(
            docs_words, None, tiles_docs, None, gtile_ids, layout, num_docs, None)
    else:
        d, _ = block_decode.split_decode_part(
            docs_words, tiles_docs, None, gtile_ids, None, None, layout, num_docs, None)
    return norm_den[d.long().clamp(0, num_docs - 1)]


def _decode_part(state, gtile_ids, gtile_f, blkperm, layout, num_docs, ranked, pow2_rows=True):
    """Decode stage of one part, written by its kernels straight into slot
    tables padded to a power-of-two row count (pad rows: docid num_docs,
    weight 0), as in the JAX engine (pow2_rows=False: the part's blocks
    alone): (docs32 int32, w32 f32), doc-term weights (ranked) or 1.0
    presence flags. layout: the part's PartLayout (pair mode: one
    pair_decode launch for both streams; split mode: gtile_f and blkperm
    are the freqs-order rows and realign)."""
    weights = "bm25" if ranked else "presence"
    rows = _pow2_at_least(layout.nb_d) if pow2_rows else layout.nb_d
    if layout.pair:
        return pair_decode.pair_decode_part(
            state.docs_words, state.freqs_words, state.tiles_docs, state.tiles_freqs, gtile_ids,
            layout, num_docs, weights, state.den_blocks, state.tile_gblk0, out_rows=rows)
    return block_decode.split_decode_part(
        state.docs_words, state.tiles_docs, state.tiles_freqs, gtile_ids, gtile_f, blkperm,
        layout, num_docs, weights, state.den_blocks, state.tile_gblk0, out_rows=rows)


def _decode_slots_step(state, part, num_docs):
    """One decode of a run of tiles (a TilesPart) for the block-max
    metadata pass: the part's BM25 launches (the served weight
    expression, den from the norm cache), then the blockmax kernel in rows
    form. Returns (docs32, w32, wmax, dmax, dmin) in the part's
    group-major block order, its pad rows included."""
    docs32, w32 = _decode_part(state, part.gtile_ids, part.gtile_f, part.blkperm, part.layout,
                               num_docs, True, pow2_rows=False)
    wmax, dmax, dmin, _ = blockmax.blockmax_rows(docs32, w32, num_docs)
    return docs32, w32, wmax, dmax, dmin


def _resident_step(state, gtile_ids, gtile_f, blkperm, layout, join_layout, num_docs, fetch16,
                   fscale):
    """One part: decode -> join and pack (ops.join.join_part: one K3
    launch on the card, two where a row spans several CTAs). gtile_f and
    blkperm are the split-mode freqs layout (placeholders in pair mode)."""
    ops = join_layout.ops
    ranked = ("or" in ops) or ("and" in ops)
    with span("ds2i.decode"):
        docs32, w32 = _decode_part(state, gtile_ids, gtile_f, blkperm, layout, num_docs, ranked)
    with span("ds2i.join"):
        return join.join_part(docs32, w32, join_layout, num_docs, fetch16, fscale)


# -- engine ------------------------------------------------------------------


class TilesPart(NamedTuple):
    """ResidentEngine.all_tiles_part: every tile as one part. gtile_ids
    maps the part's docs-order rows to tiles, tblk gives each tile's first
    docs-order block. Split mode: gtile_f, blkperm and tblk_f are the
    freqs-order rows, the docs->freqs block realign and each tile's first
    freqs-order block. Pair mode, where both streams share the docs-order
    rows: gtile_f and blkperm are the plan's one-entry placeholders, and
    tblk_f is tblk."""

    gtile_ids: torch.Tensor
    gtile_f: torch.Tensor
    blkperm: torch.Tensor
    layout: "block_decode.PartLayout"  # a string: ops.block_decode imports this module
    tblk: np.ndarray
    tblk_f: np.ndarray


class ResidentEngine:
    """Resident-table engine over an EF-family index (pair mode) or a
    block index of any codec (split mode); minimal per-batch transfer,
    one decode group set per part, decode shared across queries."""

    MIN_L = 64
    # the largest k the pruning threshold tables support (per-list sorted
    # block maxes are truncated here; a larger k disables the static
    # per-term threshold)
    PRUNE_KMAX = 128
    # the AND probe (_and_prefix_probe): rows with more kept blocks than
    # AND_PROBE_MIN_BLOCKS are probed over the blocks up to their rarest
    # span's AND_PROBE_BLOCKS-th kept block (the JAX engine's defaults of
    # DS2I_AND_PROBE_MIN_BLOCKS and DS2I_AND_PROBE_BLOCKS)
    AND_PROBE_MIN_BLOCKS = 128
    AND_PROBE_BLOCKS = 64
    # rounds of the AND directory's overlap fixpoint (DS2I_AND_FIXPOINT's
    # default)
    AND_FIXPOINT_ROUNDS = 3
    # bump when anything the cache files hold changes layout (a new
    # version never reads an older one's files)
    CACHE_VERSION = 1

    def __init__(self, index, wdata=None, max_part_slots=1 << 21,
                 max_part_queries=16384, device=None, devices=None, query_dfs=None,
                 term_remap=None, cache_dir=None):
        """device: where the resident state lives (None: the CUDA card;
        "cpu": the plain PyTorch path). devices: replicas of the state
        instead, one per entry, the parts of a plan round-robin over them
        (the JAX engine's devices=); not together with device.
        query_dfs: i64[global terms] document frequencies for the BM25
        query weights in place of this index's list lengths, and
        term_remap: i64[global terms] -> this index's list id, -1 where it
        holds no postings (the term still counts toward AND targets):
        a doc-range shard of parallel.doc_sharded. cache_dir: a directory
        for the derived state (see _cache_id)."""
        if device is not None and devices:
            raise ValueError("ResidentEngine takes device= or devices= (replicas), not both")
        devs = [resolve_device(d) for d in devices] if devices else None
        self._set_options(query_dfs, term_remap, cache_dir)
        docs_words, freqs_words = self._init_host(index, max_part_slots, max_part_queries)
        t = self.tiles
        norm_lens = (
            np.asarray(wdata.norm_lens, dtype=np.float32)
            if wdata is not None else np.ones(self.num_docs, np.float32)
        )
        self._attach(resident_state_from_arrays(
            docs_words, freqs_words, self._with_pad(t.docs), self._with_pad(t.freqs),
            BM25.norm_denominator(norm_lens), device=devs[0] if devs else device,
        ))
        self.devices = devs
        # replica 0 is self.state; the others are copies of it
        self._replicas = [self.state] + [self.state.replica(d) for d in devs[1:]] if devs else None

    def _set_options(self, query_dfs=None, term_remap=None, cache_dir=None):
        self.query_dfs = None if query_dfs is None else np.asarray(query_dfs, dtype=np.int64)
        self.term_remap = None if term_remap is None else np.asarray(term_remap, dtype=np.int64)
        self.cache_dir = cache_dir
        self._cache_key = None  # _cache_id, computed once
        self.devices = self._replicas = None

    @classmethod
    def from_state(cls, index, state, max_part_slots=1 << 21, max_part_queries=16384):
        """An engine serving over an existing ResidentState (for example
        resident_state_from_arrays of a JAX engine's arrays). The host
        planner tables come from `index`; the state's tile tables must
        be this index's."""
        eng = cls.__new__(cls)
        eng._set_options()
        eng._init_host(index, max_part_slots, max_part_queries)
        for name, rows in (("tiles_docs", eng.tiles.docs), ("tiles_freqs", eng.tiles.freqs)):
            got = getattr(state, name).cpu().numpy()
            if not np.array_equal(got, eng._with_pad(rows)):
                raise ValueError(f"state.{name} does not belong to this index")
        eng._attach(state)
        return eng

    def _init_host(self, index, max_part_slots, max_part_queries):
        """Host tables and plan state; returns the (docs, freqs) word
        arrays to upload (one array for both in split mode)."""
        if type(index).__module__.split(".")[0] != _PACKAGE:
            raise TypeError(
                f"ResidentEngine serves indexes built by {_PACKAGE}; got a "
                f"{type(index).__module__}.{type(index).__qualname__}"
            )
        self.index = index
        self.num_docs = index.num_docs()
        self.max_part_slots = max_part_slots
        self.max_part_queries = max_part_queries
        self.wmax_blk = None  # the block-max metadata, once built (_install_blockmax)
        num_lists = index.size()
        if hasattr(index, "docs_sequences"):
            t, words = self._init_ef(index)
        else:
            t, words = self._init_block(index)
        self.tiles = t
        nt = len(t.tile_list)
        self.pad_tile = nt
        # host-side layout tables
        self.list_tile_start = t.list_tile_start
        self.list_tiles = np.diff(t.list_tile_start)
        nvals = t.docs[:, F_NVALS].astype(np.int64)
        self.tile_blocks = (nvals + BLOCK - 1) // BLOCK  # 32-slot blocks per tile
        self.list_n = np.zeros(num_lists, dtype=np.int64)
        np.add.at(self.list_n, t.tile_list, nvals)
        self.list_blocks = np.zeros(num_lists, dtype=np.int64)
        np.add.at(self.list_blocks, t.tile_list, self.tile_blocks)
        return words

    def _with_pad(self, a):
        """Resident field table: the tile rows plus one trailing pad row
        (kind=-1, n_vals=0)."""
        out = np.zeros((self.pad_tile + 1, N_FIELDS), dtype=_I32)
        out[: self.pad_tile] = a
        out[self.pad_tile, 0] = -1
        return out

    def _attach(self, state):
        self.state = state
        self.device = state.device
        norm_den = self._norm_den_host = state.norm_den.cpu().numpy()
        if norm_den.shape != (self.num_docs,):
            raise ValueError(f"norm_den has shape {norm_den.shape}, index has {self.num_docs} docs")
        # provable lower bound on any bm25 doc-term weight (f>=1, den<=max),
        # with 1-ULP slack for the divide: plans the f16 download scaling
        den_max = float(np.max(norm_den)) if self.num_docs else 1.0
        self._wmin = (1.0 / (1.0 + den_max)) * (1.0 - 1e-6)

    # -- derived-state persistence (the JAX engine's cache_dir) ---------------

    def _cache_id(self):
        """The key of this engine's cache files: a hash of the backend
        ("torch"), CACHE_VERSION and the index (its first and last MiB of
        words and its sizes, as the JAX engine hashes it). The block
        maxima and probe thresholds come from this backend's arithmetic,
        so the port and the JAX package never read each other's files."""
        if self._cache_key is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(f"torch-v{self.CACHE_VERSION}".encode())
            index = self.index
            if hasattr(index, "docs_sequences"):
                for coll in (index.docs_sequences, index.freqs_sequences):
                    w = np.asarray(coll.bits_bv.words)
                    h.update(w[: 1 << 17].tobytes())
                    h.update(w[-(1 << 17):].tobytes())
                    h.update(str((int(coll.bits_bv.nbits), coll.size())).encode())
                h.update(str(self.num_docs).encode())
            else:
                data = index.lists
                h.update(np.asarray(data[: 1 << 20]).tobytes())
                h.update(np.asarray(data[-(1 << 20):]).tobytes())
                h.update(str((len(data), index.size(), self.num_docs)).encode())
            self._cache_key = h.hexdigest()
        return self._cache_key

    def _cache_path(self, part, with_norms=False):
        """The file of one cached piece, or None without cache_dir.
        with_norms: the piece depends on the BM25 denominators too."""
        if not self.cache_dir:
            return None
        key = self._cache_id()
        if with_norms:
            hn = hashlib.blake2b(digest_size=8)
            hn.update(self._norm_den_host.tobytes())
            key = f"{key}_{hn.hexdigest()}"
        os.makedirs(self.cache_dir, exist_ok=True)
        return os.path.join(self.cache_dir, f"torch_resident_{key}_{part}.npz")

    def _cache_load(self, part, with_norms=False, names=()):
        """{name: array} of a cached piece, None when it is not cached. A
        file that cannot be read whole, or lacks one of `names`, raises:
        it is never rebuilt over in silence."""
        p = self._cache_path(part, with_norms)
        if p is None or not os.path.exists(p):
            return None
        try:
            with np.load(p, allow_pickle=False) as z:
                out = {name: z[name] for name in z.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            raise RuntimeError(f"engine cache file {p} is unreadable: {e}") from e
        missing = sorted(set(names) - set(out))
        if missing:
            raise RuntimeError(f"engine cache file {p} lacks {missing}")
        return out

    def _cache_save(self, part, with_norms=False, **arrays):
        p = self._cache_path(part, with_norms)
        if p is None:
            return
        tmp = p + f".tmp{os.getpid()}.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, p)

    @staticmethod
    def _statics_to_json(statics):
        return json.dumps([list(s) for s in statics])

    @staticmethod
    def _statics_from_json(s):
        return [tuple(x if isinstance(x, str) else int(x) for x in row)
                for row in json.loads(str(s))]

    def _cached_tables(self, build, extra=()):
        """The tile tables and the arrays named in `extra`: from the
        cache when there, else build() -> (TileTables, {name: array}),
        saved."""
        names = ("docs", "freqs", "tile_list", "list_tile_start", "win_words", "lb_words")
        cached = self._cache_load("tables", names=names + tuple(extra))
        if cached is not None:
            return TileTables(**{n: cached[n] for n in names}), cached
        t, extra = build()
        self._cache_save("tables", **{n: getattr(t, n) for n in names}, **extra)
        return t, extra

    def _init_ef(self, index):
        # EF-family tiles: group statics are ("ef", W, WL, T)
        t, _ = self._cached_tables(lambda: (build_tile_tables(index), {}))
        nvals = t.docs[:, F_NVALS].astype(np.int64)
        ww = np.maximum(t.win_words, 1)
        wl = np.maximum(t.lb_words, 1)
        wb = 1 << (2 * np.ceil(np.log2(np.maximum(ww, 4)) / 2).astype(np.int64))
        lb = 1 << (2 * np.ceil(np.log2(np.maximum(wl, 4)) / 2).astype(np.int64))
        tT = np.clip(2 ** np.ceil(np.log2(np.maximum(nvals, 1))).astype(np.int64), BLOCK, TILE)
        key = tT * (1 << 22) + wb * 1024 + lb
        uniq, inv = np.unique(key, return_inverse=True)
        self.group_statics = [
            ("ef", int((int(kv) >> 10) & 1023), int(int(kv) & 1023), int(int(kv) >> 22))
            for kv in uniq
        ]
        self.tile_gid = inv.astype(np.int64)
        self._empty_statics = ("ef", 4, 4, TILE)
        self.split = False
        for coll_bv in (index.docs_sequences.bits_bv, index.freqs_sequences.bits_bv):
            if coll_bv.nbits >= 2**36:
                raise ValueError(
                    "device engine limit: 8GB per resident stream (i32 WORD "
                    "cursors in the tile tables); shard larger indexes by doc range "
                    "(make_engine, parallel.DocShardedEngine)"
                )
        return t, (index.docs_sequences.bits_bv.words, index.freqs_sequences.bits_bv.words)

    def _init_block(self, index):
        """block_freq_index tiles of any block codec (resident.py:
        _init_block): one tile per 128-int block, per-stream group statics
        ("opt", b, E, 128), ("var", G, 128), ("qmx", NI, S, 128) or
        ("interp", W, T) (block_mixed picks OptPFor, Varint-G8IU or
        interpolative per block and stream; partial blocks are always
        interpolative), and ONE word stream for docs and freqs: the index
        bytes, then the resident OptPFor exception patch pairs (none past
        RESIDENT_WORD_LIMIT, where the exceptions decode in the pass)."""
        self.split = True

        def build():
            t, slist_d, gid_d, slist_f, gid_f = build_block_tables(index)
            return t, {"gid_d": gid_d, "gid_f": gid_f,
                       "statics_d": np.array(self._statics_to_json(slist_d)),
                       "statics_f": np.array(self._statics_to_json(slist_f))}

        # the tables are kept as the walk builds them; the patch bases
        # below are set in memory after the load or save
        t, extra = self._cached_tables(build, ("gid_d", "gid_f", "statics_d", "statics_f"))
        slist_d = self._statics_from_json(extra["statics_d"])
        slist_f = self._statics_from_json(extra["statics_f"])
        gid_d, gid_f = extra["gid_d"], extra["gid_f"]
        self._empty_statics = ("interp", 4, BLOCK)
        data = np.asarray(index.lists, dtype=np.uint8)
        pad = (-len(data)) % 4
        words = np.concatenate([data, np.zeros(pad + 8, np.uint8)]).view("<u4")
        if len(words) >= RESIDENT_WORD_LIMIT:
            raise ValueError(
                "device engine limit: 8GB per resident stream (i32 word cursors); "
                "shard larger indexes by doc range (make_engine, "
                "parallel.DocShardedEngine)"
            )
        # resident exception patch tables (the JAX engine's default): the
        # Simple16 exception streams decode ONCE here into (position,
        # high<<b) pairs appended to the stream; BF_EX_BASE holds each
        # row's first pair word and those groups become "optp". Where the
        # pairs would pass the word limit the groups stay "opt" and their
        # exceptions decode in the pass (BF_EX_W0/BF_EX_BOFF, K1s).
        if any(s[0] == "opt" and s[2] > 0 for s in slist_d + slist_f):
            cached = self._cache_load("expatch", names=("patch", "base_d", "base_f"))
            if cached is not None:
                patch, base_d, base_f = cached["patch"], cached["base_d"], cached["base_f"]
            else:
                patch, (base_d, base_f) = build_exception_patches(words, [t.docs, t.freqs])
                self._cache_save("expatch", patch=patch, base_d=base_d, base_f=base_f)
            nw0 = np.int64(len(words))
            if nw0 + len(patch) < RESIDENT_WORD_LIMIT:
                t.docs[:, BF_EX_BASE] = np.where(base_d >= 0, nw0 + 2 * base_d, 0).astype(np.int32)
                t.freqs[:, BF_EX_BASE] = np.where(base_f >= 0, nw0 + 2 * base_f, 0).astype(np.int32)
                words = np.concatenate([words, patch.astype(np.uint32)])
                remap = lambda s: ("optp",) + s[1:] if s[0] == "opt" and s[2] > 0 else s  # noqa: E731
                slist_d = [remap(s) for s in slist_d]
                slist_f = [remap(s) for s in slist_f]
        self.group_statics_d = slist_d
        self.tile_gid_d = gid_d
        self.group_statics_f = slist_f
        self.tile_gid_f = gid_f
        return t, (words, words)

    def _ensure_norm_cache(self):
        """Materialize the per-slot BM25-denominator cache (one decode of
        every tile's docs stream, or its cache file), then copy it to
        every other replica. Lazy: only ranked execution pays it."""
        s = self.state
        if s.den_blocks is not None:
            return
        cached = self._cache_load("norms", with_norms=True, names=("den_blocks", "tile_gblk0"))
        if cached is not None:
            s.tile_gblk0 = torch.from_numpy(cached["tile_gblk0"]).to(self.device)
            s.den_blocks = torch.from_numpy(cached["den_blocks"]).to(self.device)
        else:
            nt = self.pad_tile
            utidx = np.arange(nt, dtype=np.int64)
            groups, gtile_ids, tblk, sent_blk, _ = self._order_groups(
                utidx, *self._docs_grouping())
            g0 = np.full(nt + 1, sent_blk, dtype=np.int64)
            if nt:
                g0[:nt] = tblk
            s.tile_gblk0 = torch.from_numpy(g0).to(self.device)
            with _on(self.device):
                s.den_blocks = _norm_cache_step(
                    s.docs_words, s.tiles_docs, s.norm_den,
                    torch.from_numpy(gtile_ids.astype(np.int64)).to(self.device),
                    block_decode.PartLayout(groups), self.num_docs,
                )
            if self.cache_dir:
                self._cache_save("norms", with_norms=True, den_blocks=s.den_blocks.cpu().numpy(),
                                 tile_gblk0=g0)
        for r in (self._replicas or [])[1:]:
            r.den_blocks = s.den_blocks.to(r.device, copy=True)
            r.tile_gblk0 = s.tile_gblk0.to(r.device, copy=True)

    def _docs_grouping(self):
        """(tile gids, statics) of the docs-order decode groups."""
        if self.split:
            return self.tile_gid_d, self.group_statics_d
        return self.tile_gid, self.group_statics

    # -- block-max pruning metadata ---------------------------------------------

    def _ensure_blockmax(self):
        """Materialize the WAND/MaxScore pruning metadata by one decode of
        every tile (lazy like the norm cache, and a no-op once present):
          wmax_blk   f32[total_blocks]  per-32-block max doc-term weight,
                                        global (tile-major) block order
          list_wmax  f32[num_lists]     per-list max
          kth CSR    per-list block maxes sorted descending (<= PRUNE_KMAX):
                     the j-th entry is an ACHIEVED doc-term weight of j
                     distinct docs, so qw * vals[k-1] lower-bounds the true
                     k-th best score of any query containing the term.
        The tiles decode in contiguous runs of at most the slot budget,
        each run through its part launches with the served BM25 weights,
        then the blockmax kernel (rows form); the tile-major metadata
        assembles on the host (the global blocks of tiles [lo, hi) are
        gblk0[lo]:gblk0[hi])."""
        if self.wmax_blk is not None or self._attach_blockmax_cache():
            return
        with _on(self.device):
            self._blockmax_decode_pass()

    def _blockmax_decode_pass(self):
        """_ensure_blockmax's pass over every tile."""
        self._ensure_norm_cache()
        nt = self.pad_tile
        tb = self.tile_blocks
        gblk0 = self._tile_gblk0()
        total = int(gblk0[-1])

        # short lists get posting-exact planner metadata (their blocks span
        # wide docid ranges)
        self._pick_short_lists()
        short_gblks, short_list_of_blk = self._short_block_ids(gblk0)

        wmax_all = np.zeros(total, dtype=np.float32)
        dmax_all = np.full(total, -1, dtype=np.int64)
        dmin_all = np.zeros(total, dtype=np.int64)
        sdocs = np.full((len(short_gblks), BLOCK), np.iinfo(np.int32).max, dtype=np.int32)
        sw = np.zeros((len(short_gblks), BLOCK), dtype=np.float32)
        budget = max(min(int(self.max_part_slots), 1 << 25), 1 << 12)
        slots_tile = tb * BLOCK
        cid = (np.cumsum(slots_tile) - slots_tile) // budget if nt else np.zeros(0, np.int64)
        cuts = np.concatenate([[0], np.nonzero(np.diff(cid))[0] + 1, [nt]]).astype(np.int64)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            lo, hi = int(lo), int(hi)
            if hi <= lo:
                continue
            part = self._full_tile_orders(np.arange(lo, hi, dtype=np.int64))
            tb_c = tb[lo:hi]
            tot_c = int(tb_c.sum())
            if not tot_c:
                continue
            # tile-major block b of the run -> its group-major decode row;
            # the decode's pad rows are never addressed
            bex_c = np.cumsum(tb_c) - tb_c
            src_c = np.repeat(part.tblk, tb_c) + (
                np.arange(tot_c, dtype=np.int64) - np.repeat(bex_c, tb_c))
            sidx = np.nonzero((short_gblks >= gblk0[lo]) & (short_gblks < gblk0[hi]))[0]
            docs_d, w_d, wmax_c, dmax_c, dmin_c = _decode_slots_step(
                self.state, part, self.num_docs)
            if len(sidx):
                rows_c = torch.from_numpy(src_c[short_gblks[sidx] - gblk0[lo]]).to(self.device)
                sdocs[sidx] = docs_d[rows_c].cpu().numpy()
                sw[sidx] = w_d[rows_c].cpu().numpy()
            wmax_all[gblk0[lo]:gblk0[hi]] = wmax_c.cpu().numpy()[src_c]
            dmax_all[gblk0[lo]:gblk0[hi]] = dmax_c.cpu().numpy()[src_c]
            dmin_all[gblk0[lo]:gblk0[hi]] = dmin_c.cpu().numpy()[src_c]
        self._install_blockmax(wmax_all, dmax_all, dmin_all, gblk0,
                               *self._short_csr(sdocs, sw, short_list_of_blk))

    # what _install_blockmax sets from the passes' results, as the cache
    # file holds it (the leading underscore dropped in the file)
    BLOCKMAX_CACHED = ("wmax_blk", "dmax_blk", "dmin_blk", "gblk0", "tile_of_gblk",
                       "list_gblk0", "list_wmax", "_kth_vals", "_kth_start", "rank_blk",
                       "is_short", "_short_keys", "_short_w")

    def _attach_blockmax_cache(self):
        """Install the block-max tables from the cache (True), or False
        when they are not cached. A hit launches no kernel."""
        names = tuple(n.lstrip("_") for n in self.BLOCKMAX_CACHED)
        cached = self._cache_load("blockmax", with_norms=True, names=names + ("short_stride",))
        if cached is None:
            return False
        for name in self.BLOCKMAX_CACHED:
            setattr(self, name, cached[name.lstrip("_")])
        self._short_stride = np.int64(cached["short_stride"])
        self._derive_prune_tables()
        return True

    def _tile_gblk0(self):
        """First global (tile-major) block of each tile, and the total
        block count last: (num_tiles + 1,) int64."""
        gblk0 = np.zeros(self.pad_tile + 1, dtype=np.int64)
        np.cumsum(self.tile_blocks, out=gblk0[1:])
        return gblk0

    def _short_csr(self, sdocs, sw, short_list_of_blk):
        """(short_keys, short_w): the short lists' postings keyed by
        list * (num_docs + 1) + docid (globally sorted, since blocks come
        list-major in docid order), and their weights."""
        if not len(sdocs):
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32)
        valid = sdocs < self.num_docs
        lists_rep = np.repeat(short_list_of_blk, BLOCK).reshape(-1, BLOCK)
        short_keys = lists_rep[valid].astype(np.int64) * np.int64(self.num_docs + 1) + sdocs[valid]
        return short_keys, sw[valid].astype(np.float32)

    def _short_block_ids(self, gblk0):
        """Global block ids (and owning lists) of every short list's
        blocks: the rows whose (docid, weight) slots the planner keeps for
        posting-exact bounds. Shared by both metadata passes so their
        selection is identical."""
        lgb0_all = gblk0[self.list_tile_start]
        short_lists = np.nonzero(self.is_short)[0]
        if not len(short_lists):
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        s_nb = lgb0_all[short_lists + 1] - lgb0_all[short_lists]
        s_tot = int(s_nb.sum())
        s_ex = np.cumsum(s_nb) - s_nb
        short_gblks = np.repeat(lgb0_all[short_lists] - s_ex, s_nb) + np.arange(s_tot, dtype=np.int64)
        return short_gblks, np.repeat(short_lists, s_nb)

    def _pick_short_lists(self):
        """Short lists: at most 256 postings, the cap halved (down to 8)
        while their postings pass 2^26, so host memory stays bounded.
        Deterministic in the list sizes alone, so both passes pick the
        same set."""
        short_max = 256
        while short_max > 8 and int(self.list_n[self.list_n <= short_max].sum()) > (1 << 26):
            short_max //= 2
        self.is_short = self.list_n <= short_max

    def _install_blockmax(self, wmax_all, dmax_all, dmin_all, gblk0, short_keys, short_w):
        """Install the per-block metadata and every planner table derived
        from it. Shared by both passes, so their tables are identical by
        construction."""
        nt = self.pad_tile
        tb = self.tile_blocks
        total = int(gblk0[-1])
        self.wmax_blk = wmax_all
        self.dmax_blk = dmax_all
        self.dmin_blk = dmin_all
        self.gblk0 = gblk0
        self.tile_of_gblk = np.repeat(np.arange(nt, dtype=np.int64), tb)
        self._short_stride = np.int64(self.num_docs + 1)
        self._short_keys = short_keys
        self._short_w = short_w

        # per-list ranges in global block space (a list's tiles, hence its
        # blocks, are contiguous)
        lgb0 = gblk0[self.list_tile_start]  # (num_lists+1,)
        self.list_gblk0 = lgb0
        nl = len(lgb0) - 1
        if total:
            nblk_l = np.diff(lgb0)
            list_of_blk = np.repeat(np.arange(nl, dtype=np.int64), nblk_l)
            self.list_wmax = np.zeros(nl, dtype=np.float32)
            ne = nblk_l > 0
            if np.any(ne):
                self.list_wmax[ne] = np.maximum.reduceat(
                    self.wmax_blk, np.minimum(lgb0[:-1][ne], total - 1))
            # per-list descending block maxes, truncated to PRUNE_KMAX
            order = np.lexsort((-self.wmax_blk, list_of_blk))
            rank = np.arange(total, dtype=np.int64) - lgb0[list_of_blk[order]]
            keep = rank < self.PRUNE_KMAX
            self._kth_vals = self.wmax_blk[order][keep]
            kept_per_list = np.bincount(list_of_blk[order][keep], minlength=nl)
            self._kth_start = np.zeros(nl + 1, dtype=np.int64)
            np.cumsum(kept_per_list, out=self._kth_start[1:])
            # rank of each block within its list (desc by wmax): drives the
            # probe directory (top-P blocks per term)
            self.rank_blk = np.zeros(total, dtype=np.int64)
            self.rank_blk[order] = rank
        else:
            self.list_wmax = np.zeros(nl, dtype=np.float32)
            self._kth_vals = np.zeros(0, dtype=np.float32)
            self._kth_start = np.zeros(nl + 1, dtype=np.int64)
            self.rank_blk = np.zeros(0, dtype=np.int64)
        self._derive_prune_tables()
        if self.cache_dir:
            self._cache_save("blockmax", with_norms=True, short_stride=self._short_stride,
                             **{n.lstrip("_"): getattr(self, n) for n in self.BLOCKMAX_CACHED})

    def build_blockmax(self, collection):
        """Build the pruning metadata from the ORIGINAL collection (the
        build-time-artifact path of the reference's ranking metadata,
        create_wand_data.cpp, wand_data.hpp:20-53): the host lays out
        every block's docids and freqs as (total_blocks, 32) slot planes,
        uploaded in chunks of _bm_chunk_rows rows, and the blockmax kernel
        (planes form) evaluates the weights with the served expression and
        takes the per-block maxima; no tile is decoded. Byte-identical
        tables to _ensure_blockmax's (tested).

        collection: a BinaryFreqCollection or any iterable of (docs,
        freqs) pairs in index list order; one whose per-list posting
        counts differ from the index's raises ValueError. A no-op when
        the metadata is already present or cached (a cache hit launches
        no kernel)."""
        if self.wmax_blk is not None or self._attach_blockmax_cache():
            return
        with _on(self.device):
            self._blockmax_planes_pass(collection)

    def _blockmax_planes_pass(self, collection):
        """build_blockmax's pass over the collection's slot planes."""
        doc_plane, freq_plane = self._collection_planes(collection)
        total = len(doc_plane)
        gblk0 = self._tile_gblk0()
        self._pick_short_lists()
        short_gblks, short_list_of_blk = self._short_block_ids(gblk0)

        wmax_all = np.zeros(total, dtype=np.float32)
        dmax_all = np.zeros(total, dtype=np.int64)
        dmin_all = np.zeros(total, dtype=np.int64)
        sw = np.zeros((len(short_gblks), BLOCK), dtype=np.float32)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        CB = _bm_chunk_rows(self.max_part_slots, total)
        for lo in range(0, total, CB):
            hi = min(lo + CB, total)
            wmax_c, dmax_c, dmin_c, w = blockmax.blockmax_rows(
                put(doc_plane[lo:hi]), put(freq_plane[lo:hi]), self.num_docs, self.state.norm_den)
            wmax_all[lo:hi] = wmax_c.cpu().numpy()
            dmax_all[lo:hi] = dmax_c.cpu().numpy()
            dmin_all[lo:hi] = dmin_c.cpu().numpy()
            sidx = np.nonzero((short_gblks >= lo) & (short_gblks < hi))[0]
            if len(sidx):
                sw[sidx] = w[put(short_gblks[sidx] - lo)].cpu().numpy()
        self._install_blockmax(wmax_all, dmax_all, dmin_all, gblk0,
                               *self._short_csr(doc_plane[short_gblks], sw, short_list_of_blk))

    def _collection_planes(self, collection):
        """The (total_blocks, 32) docid (int32) and raw-freq (f32) slot
        planes of the collection's postings in the engine's tile-major
        block order, pad slots (num_docs, 0) as the decode pass writes
        them; ValueError when the per-list posting counts differ from the
        index's."""
        docs_all, freqs_all, list_n = _concat_collection(collection)
        if not np.array_equal(list_n, self.list_n):
            raise ValueError(
                "collection does not match the index (per-list posting "
                "counts differ); build_blockmax needs the collection the "
                "index was built from"
            )
        nt = self.pad_tile
        nvals = self.tiles.docs[:, F_NVALS].astype(np.int64)
        tb = self.tile_blocks
        total = int(tb.sum())
        # block b = a 32-slot run of its tile; a list's tiles cover its
        # postings contiguously in order, so block j of tile t covers
        # postings [pbase[t] + 32 j, min(+32, pbase[t] + nvals[t]))
        pbase = np.cumsum(nvals) - nvals
        bex = np.cumsum(tb) - tb
        block_tile = np.repeat(np.arange(nt, dtype=np.int64), tb)
        bstart = pbase[block_tile] + BLOCK * (np.arange(total, dtype=np.int64) - bex[block_tile])
        bend = np.minimum(bstart + BLOCK, pbase[block_tile] + nvals[block_tile])
        idx = bstart[:, None] + np.arange(BLOCK, dtype=np.int64)[None, :]
        validp = idx < bend[:, None]
        idxc = np.minimum(idx, max(len(docs_all) - 1, 0))
        doc_plane = np.where(validp, docs_all[idxc], self.num_docs).astype(np.int32)
        freq_plane = np.where(validp, freqs_all[idxc], 0).astype(np.float32)
        return doc_plane.reshape(total, BLOCK), freq_plane.reshape(total, BLOCK)

    def _derive_prune_tables(self):
        """Planner tables derived from the block metadata:

          _dmax_keys / _dlo_keys  i64[total_blocks], globally sorted
              (list-major, docids increase within a list): two
              searchsorted calls give the EXACT range of a list's blocks
              overlapping any docid interval, the planner analogue of the
              reference cursor's next_geq block walk
              (block_posting_list.hpp skipping).
          _pyr (+ _pyr_off/_pyr_q)  per-list binary max-pyramid over
              block maxes: max(wmax) over any block range [b0,b1] in two
              gathers, outward-rounded to the enclosing power-of-two
              cells (a valid upper bound; <= 4x range dilation)."""
        total = len(self.wmax_blk)
        lgb0 = self.list_gblk0
        nl = len(lgb0) - 1
        stride = np.int64(self.num_docs + 1)
        nb = np.diff(lgb0)
        list_of_blk = np.repeat(np.arange(nl, dtype=np.int64), nb)
        # the TRUE first docid per block (not prev-max+1): a list's block
        # ranges then leave gaps between blocks, so block-exact overlap
        # prunes against lists of every length
        dlo = self.dmin_blk
        self._blk_dlo = dlo
        self._dmax_keys = list_of_blk * stride + self.dmax_blk
        self._dlo_keys = list_of_blk * stride + dlo

        Q = np.ones(nl, dtype=np.int64)
        pos = nb > 0
        Q[pos] = 2 ** np.ceil(np.log2(nb[pos])).astype(np.int64)
        off = np.zeros(nl + 1, dtype=np.int64)
        np.cumsum(2 * Q - 1, out=off[1:])
        pyr = np.zeros(int(off[-1]), dtype=np.float32)
        if total:
            rel = np.arange(total, dtype=np.int64) - lgb0[list_of_blk]
            pyr[off[list_of_blk] + rel] = self.wmax_blk
        # level s of list l starts at off[l] + 2*Q[l] - 2*(Q[l] >> s)
        depth = int(np.log2(int(Q.max()))) if nl else 0
        for s in range(1, depth + 1):
            m = (Q >> s) >= 1
            cells = (Q >> s)[m]
            loff = off[:-1][m]
            Ql = Q[m]
            tot_c = int(cells.sum())
            ex = np.cumsum(cells) - cells
            j = np.arange(tot_c, dtype=np.int64) - np.repeat(ex, cells)
            par = np.repeat(loff + 2 * Ql - 2 * cells, cells) + j
            ch = np.repeat(loff + 2 * Ql - 4 * cells, cells) + 2 * j
            pyr[par] = np.maximum(pyr[ch], pyr[ch + 1])
        self._pyr = pyr
        self._pyr_off = off[:-1]
        self._pyr_q = Q

    def _blk_overlap(self, lists, dlo_e, dhi_e):
        """First/last block of each list whose docid range intersects
        [dlo_e, dhi_e] (global block ids; empty iff bf > bl). Exact at
        block granularity for ANY list length."""
        stride = np.int64(self.num_docs + 1)
        bf = np.searchsorted(self._dmax_keys, lists * stride + dlo_e)
        bl = np.searchsorted(self._dlo_keys, lists * stride + dhi_e, side="right") - 1
        return bf, bl

    def _range_ub(self, lists, b0, b1):
        """Upper bound on the max doc-term weight over blocks [b0, b1] of
        each list (global ids within the list) via the max-pyramid."""
        r0 = b0 - self.list_gblk0[lists]
        r1 = b1 - self.list_gblk0[lists]
        d = r1 - r0
        s = np.zeros(len(d), dtype=np.int64)
        m = d > 0
        if np.any(m):
            s[m] = np.floor(np.log2(d[m])).astype(np.int64) + 1
        Q = self._pyr_q[lists]
        start = self._pyr_off[lists] + 2 * Q - 2 * (Q >> s)
        return np.maximum(self._pyr[start + (r0 >> s)], self._pyr[start + (r1 >> s)])

    # -- host batch layout ----------------------------------------------------

    def _prep_terms(self, queries, ranked):
        tf = [query_freqs(t) for t in queries]
        counts = np.array([len(x) for x in tf], dtype=np.int64)
        terms = np.array([t for q in tf for t, _ in q], dtype=np.int64)
        qmult = np.array([m for q in tf for _, m in q], dtype=np.int64)
        if ranked and len(terms):
            # a shard scores with the collection's idf (query_dfs)
            src = self.query_dfs if self.query_dfs is not None else self.list_n
            dfs = src[terms].astype(_F32)
            N = _F32(self.num_docs)
            idf = np.log((N - dfs + _F32(0.5)) / (dfs + _F32(0.5))).astype(_F32)
            qw = qmult.astype(_F32) * np.maximum(_F32(1e-6), idf) * (_F32(1.0) + BM25.k1)
        else:
            qw = np.ones(len(terms), dtype=_F32)
        if self.term_remap is not None and len(terms):
            terms = self.term_remap[terms]  # -1: no postings in this index
        return terms, qw, counts

    def _term_tiles(self, terms):
        """(tile_start, tile_count) per term; -1 terms own none."""
        t = np.clip(terms, 0, None)
        missing = terms < 0
        return (
            np.where(missing, 0, self.list_tile_start[t]),
            np.where(missing, 0, self.list_tiles[t]),
        )

    def _term_blocks(self, terms):
        return np.where(terms < 0, 0, self.list_blocks[np.clip(terms, 0, None)])

    def _order_groups(self, utidx, tile_gid, statics_list):
        """Group-major ordering of the part's tiles for one decode pass.
        Returns (groups, gtile_ids, tblk, sent_blk, total_blocks)."""
        ntiles = len(utidx)
        bkey = tile_gid[utidx] if ntiles else np.zeros(0, np.int64)
        order = np.argsort(bkey, kind="stable")
        sk = bkey[order]
        bnd = (np.nonzero(np.diff(sk))[0] + 1) if ntiles else np.zeros(0, np.int64)
        gstarts = np.concatenate([[0], bnd, [ntiles]]).astype(np.int64)

        groups = []
        tblk = np.zeros(ntiles, dtype=np.int64)  # first block of each utile
        gids_parts = []
        off = 0
        gblk = 0
        ngroups = len(gstarts) - 1
        sent_blk = 0
        for gi in range(ngroups):
            lo_i, hi_i = int(gstarts[gi]), int(gstarts[gi + 1])
            if hi_i <= lo_i:
                continue
            sel = order[lo_i:hi_i]
            cnt = hi_i - lo_i
            st = statics_list[int(bkey[sel[0]])]
            T = st[-1]
            bpt = max(T // BLOCK, 1)
            # last group gets one guaranteed pad row (the sentinel block)
            need = cnt + (1 if gi == ngroups - 1 else 0)
            R = _pow2_at_least(need, lo=8)
            if R > 8:
                # quarter-pow2 ladder: row padding <= 1.25x (the JAX
                # engine's default, DS2I_R_FINE=1)
                for c in (R // 2 * 5 // 4, R // 2 * 6 // 4, R // 2 * 7 // 4):
                    if need <= c:
                        R = c
                        break
            ids = np.full(R, self.pad_tile, dtype=_I32)
            ids[:cnt] = utidx[sel]
            tblk[sel] = gblk + np.arange(cnt) * bpt
            groups.append((off, R, st))
            gids_parts.append(ids)
            sent_blk = gblk + cnt * bpt  # first pad row's block (last group)
            off += R
            gblk += R * bpt
        if not groups:
            groups = [(0, 8, self._empty_statics)]
            gids_parts = [np.full(8, self.pad_tile, dtype=_I32)]
            gblk = 8 * max(self._empty_statics[-1] // BLOCK, 1)
            sent_blk = 0
        gtile_ids = np.concatenate(gids_parts)
        return tuple(groups), gtile_ids, tblk, sent_blk, gblk

    def _split_layout(self, utidx, tblk, nb_d):
        """Freqs-order groups + docs->freqs block permutation for split
        (block-index) parts; trivial placeholders for pair mode."""
        if not self.split:
            return (), np.zeros(1, dtype=_I32), np.zeros(1, dtype=_I32)
        groups_f, gtile_f, tblk_f, sent_f, _ = self._order_groups(
            utidx, self.tile_gid_f, self.group_statics_f)
        blkperm = np.full(nb_d, sent_f, dtype=_I32)
        if len(utidx):
            bpt = self.tile_blocks[utidx]
            tot_b = int(bpt.sum())
            bex = np.cumsum(bpt) - bpt
            blkperm[np.repeat(tblk - bex, bpt) + np.arange(tot_b, dtype=np.int64)] = (
                np.repeat(tblk_f - bex, bpt) + np.arange(tot_b, dtype=np.int64)
            )
        return groups_f, gtile_f, blkperm

    def all_tiles_part(self):
        """Every tile as one part, laid out as a plan's part is (a
        TilesPart): (gtile_ids, gtile_f, blkperm) int64 on the engine's
        device, the part's PartLayout, and each tile's first docs-order
        and freqs-order block (host arrays)."""
        return self._full_tile_orders()

    def _full_tile_orders(self, utidx=None):
        """A TilesPart over the tiles utidx (default: every tile), laid
        out as a plan's part is: the tile-set analogue of _part_plan's
        layout, for the init passes."""
        if utidx is None:
            utidx = np.arange(self.pad_tile, dtype=np.int64)
        groups, gtile, tblk, _, nb_d = self._order_groups(utidx, *self._docs_grouping())
        groups_f, gtile_f, blkperm = self._split_layout(utidx, tblk, nb_d)
        tblk_f = tblk
        if self.split:
            _, _, tblk_f, _, _ = self._order_groups(utidx, self.tile_gid_f, self.group_statics_f)
        put = lambda a: torch.from_numpy(a.astype(np.int64)).to(self.device)  # noqa: E731
        return TilesPart(put(gtile), put(gtile_f), put(blkperm),
                         block_decode.PartLayout(groups, groups_f), tblk, tblk_f)

    # -- block-max pruned directories ------------------------------------------

    def _entry_score_ub(self, t, qw, missing, counts, span_row, span_of_blk, gblk_flat):
        """Range-aware score upper bound per directory entry: entry e (one
        block of one span, docid range [dlo, dhi]) takes its own
        qw-weighted block max plus, for every OTHER span s of its row,
        qw_s * max doc-term weight of t_s over the blocks overlapping
        [dlo, dhi] (block-max WAND's docid alignment, exact at block
        granularity via _blk_overlap and the pyramid range max;
        posting-exact for short other-terms). Valid for any doc in the
        block under both OR and AND semantics (same score sum)."""
        tot = len(gblk_flat)
        rowe = span_row[span_of_blk]
        sexcl = np.cumsum(counts) - counts
        cnt_e = counts[rowe]
        P = int(cnt_e.sum())
        ent_of_pair = np.repeat(np.arange(tot, dtype=np.int64), cnt_e)
        pexcl = np.cumsum(cnt_e) - cnt_e
        s_pair = sexcl[rowe][ent_of_pair] + (np.arange(P, dtype=np.int64) - pexcl[ent_of_pair])
        ts_pair = t[s_pair]
        dlo_e = self._blk_dlo[gblk_flat][ent_of_pair]
        dhi_e = self.dmax_blk[gblk_flat][ent_of_pair]
        bf, bl = self._blk_overlap(ts_pair, dlo_e, dhi_e)
        has = bf <= bl
        v = np.zeros(P, dtype=np.float32)
        if np.any(has):
            v[has] = self._range_ub(ts_pair[has], bf[has], bl[has])
        # short other-terms: posting-exact overlap against the entry's
        # docid range (their blocks span wide docid ranges)
        sp = self.is_short[ts_pair] & ~missing[s_pair]
        if np.any(sp):
            base = ts_pair[sp] * self._short_stride
            lo = np.searchsorted(self._short_keys, base + dlo_e[sp])
            hi = np.searchsorted(self._short_keys, base + dhi_e[sp] + 1)
            cnt = hi - lo
            v[sp] = np.where(
                cnt == 0, np.float32(0.0),
                np.where(cnt == 1,
                         self._short_w[np.clip(lo, 0, max(len(self._short_w) - 1, 0))],
                         v[sp]))
        v = np.where(missing[s_pair], 0.0, v)
        own = s_pair == span_of_blk[ent_of_pair]
        contrib = np.where(own, 0.0, qw[s_pair].astype(np.float64) * v)
        rest_ub = np.add.reduceat(contrib, pexcl) if P else np.zeros(tot)
        return rest_ub + qw.astype(np.float64)[span_of_blk] * self.wmax_blk[gblk_flat]

    def _pruned_directory(self, terms, qw, counts, k, span_row, theta_override=None,
                          probe_rank=None, mode="or", essential=False):
        """Block-max pruned flat directory (WAND/MaxScore,
        queries.hpp:200-319/:478-591 semantics, batched):

        theta[row] = max over terms of qw * (k-th largest block max), an
        ACHIEVED lower bound on the true k-th best score (each block max
        is a real doc's doc-term weight; distinct blocks, distinct docs).
        An entry (query, term t, block b) is dropped when
            ub = qw_t*bmax(t,b) + sum_{t' != t} qw_t'*rmax(t', b) < theta
        (rmax = max doc-term weight of t' over b's docid range, an upper
        bound from _blk_overlap and the block max-pyramid): every doc in b
        then has true score < theta <= true k-th score, so it cannot enter
        the top-k; docs that CAN enter keep every block of every their
        term, so their join-assembled scores stay exact.

        probe_rank: each term's top probe_rank blocks by block max (the
        WAND probe). mode="and": intersection pruning by block overlap,
        theta_override (per row) adding the score test, then the overlap
        fixpoint. essential (mode "or"): MaxScore's restriction.
        Returns (gblk_kept, span_kept, row_of_blk, row_nb) in global block
        ids, row-major order."""
        B = len(counts)
        t = np.clip(terms, 0, None)
        missing = terms < 0
        span_nb = np.where(missing, 0, self.list_blocks[t])

        tot = int(span_nb.sum())
        if not tot:
            z = np.zeros(0, np.int64)
            return z, z, z, np.zeros(B, np.int64)
        bexcl = np.cumsum(span_nb) - span_nb
        span_of_blk = np.repeat(np.arange(len(span_nb)), span_nb)
        gblk_flat = np.repeat(self.list_gblk0[t] - bexcl, span_nb) + np.arange(tot, dtype=np.int64)

        if probe_rank is not None:
            keep = self.rank_blk[gblk_flat] < probe_rank
        elif mode == "and":
            # intersection pruning, the batched analogue of and_query's
            # next_geq skipping (queries.hpp:59-82): drop an entry when ANY
            # other span of its row provably has no posting in the entry's
            # docid range; no doc of the block can then be in the
            # intersection, so counts and scores stay exact
            rowe = span_row[span_of_blk]
            sexcl = np.cumsum(counts) - counts
            cnt_e = counts[rowe]
            P = int(cnt_e.sum())
            ent_of_pair = np.repeat(np.arange(tot, dtype=np.int64), cnt_e)
            pexcl = np.cumsum(cnt_e) - cnt_e
            s_pair = sexcl[rowe][ent_of_pair] + (np.arange(P, dtype=np.int64) - pexcl[ent_of_pair])
            ts_pair = t[s_pair]
            dlo_e = self._blk_dlo[gblk_flat][ent_of_pair]
            dhi_e = self.dmax_blk[gblk_flat][ent_of_pair]
            bf, bl = self._blk_overlap(ts_pair, dlo_e, dhi_e)
            present = bf <= bl  # block-exact range overlap
            sp = self.is_short[ts_pair]
            if np.any(sp):
                base = ts_pair[sp] * self._short_stride
                lo = np.searchsorted(self._short_keys, base + dlo_e[sp])
                hi = np.searchsorted(self._short_keys, base + dhi_e[sp] + 1)
                present[sp] = hi > lo  # posting-exact overlap
            present[missing[s_pair]] = False  # absent term: empty AND
            own = s_pair == span_of_blk[ent_of_pair]
            ok_pair = present | own
            keep = (np.add.reduceat(ok_pair.astype(np.int64), pexcl) == cnt_e
                    if P else np.zeros(tot, dtype=bool))
            theta_keep = None
            if theta_override is not None and np.any(np.isfinite(theta_override)):
                # AND score pruning (exact): theta_override[row] is an
                # ACHIEVED k-th best AND score (the docid-prefix probe's);
                # a block with ub < theta holds no doc of the final top-k,
                # and a doc missing ANY block is excluded entirely, not
                # partially scored. Applied to overlap survivors only.
                srv = np.nonzero(keep)[0]
                th_e = theta_override[span_row[span_of_blk[srv]]]
                cand = np.isfinite(th_e)
                if np.any(cand):
                    sc = srv[cand]
                    ub = self._entry_score_ub(t, qw, missing, counts, span_row,
                                              span_of_blk[sc], gblk_flat[sc])
                    th = th_e[cand]
                    keep[sc[ub < th - np.abs(th) * 1e-4]] = False
                    # the fixpoint recomputes keep from pair overlap alone;
                    # score drops must stay dropped
                    theta_keep = keep.copy()
            # fixpoint: each round's dropped blocks shrink the other terms'
            # surviving coverage, which drops more blocks (the cursor
            # leapfrog's mutual narrowing). Exact by induction: a doc in the
            # intersection keeps all its blocks in round 0, so each of its
            # pair probes keeps finding the surviving partner block
            stride = self._short_stride
            dmax_flat = self.dmax_blk[gblk_flat]
            dmin_flat = self._blk_dlo[gblk_flat]
            for _ in range(self.AND_FIXPOINT_ROUNDS):
                if P == 0 or not keep.any():
                    break
                srv = np.nonzero(keep)[0]
                # span-major, docid-ascending by construction of gblk_flat
                keys_max = span_of_blk[srv] * stride + dmax_flat[srv]
                pos = np.searchsorted(keys_max, s_pair * stride + dlo_e)
                posc = np.minimum(pos, max(len(srv) - 1, 0))
                cover = ((pos < len(srv)) & (span_of_blk[srv][posc] == s_pair)
                         & (dmin_flat[srv][posc] <= dhi_e))
                ok_new = (present & cover) | own
                keep_new = np.add.reduceat(ok_new.astype(np.int64), pexcl) == cnt_e
                if theta_keep is not None:
                    keep_new &= theta_keep
                if np.array_equal(keep_new, keep):
                    break
                keep = keep_new
        else:
            # static theta: k-th largest block max per term (CSR; -inf when
            # the term has fewer than k blocks or k exceeds the table)
            if k > self.PRUNE_KMAX and not getattr(self, "_kmax_warned", False):
                logger(
                    f"warning: k={k} exceeds PRUNE_KMAX={self.PRUNE_KMAX}: "
                    f"per-term static thresholds are disabled (results stay "
                    f"exact; pruning falls back to probe/range bounds only)"
                )
                self._kmax_warned = True
            kstart = self._kth_start[t]
            kn = self._kth_start[t + 1] - kstart
            ok = (~missing) & (kn >= k) & (k <= self.PRUNE_KMAX)
            kth = np.where(ok, self._kth_vals[np.where(ok, kstart + k - 1, 0)], -np.inf)
            theta_s = np.where(ok, qw.astype(np.float64) * kth, -np.inf)
            theta = np.full(B, -np.inf)
            np.maximum.at(theta, span_row, theta_s)
            if theta_override is not None:
                # probe scores are true partial scores of real docs, so
                # their k-th best is a valid (usually far tighter) bound
                theta = np.maximum(theta, theta_override)
            ub = self._entry_score_ub(t, qw, missing, counts, span_row, span_of_blk, gblk_flat)
            # 1e-4 relative margin absorbs f32 accumulation-order noise on
            # both sides (the parity tolerance is 0.1% relative,
            # test_ranked_queries.cpp:52)
            th = theta[span_row[span_of_blk]]
            keep = ~(ub < th - np.abs(th) * 1e-4)
            if essential:
                keep = self._essential_restrict(keep, t, qw, counts, missing, theta, span_row,
                                                span_of_blk, gblk_flat)

        gblk_kept = gblk_flat[keep]
        span_kept = span_of_blk[keep]
        row_of_blk = span_row[span_kept]
        row_nb = np.bincount(row_of_blk, minlength=B).astype(np.int64)
        return gblk_kept, span_kept, row_of_blk, row_nb

    def _essential_restrict(self, keep, t, qw, counts, missing, theta, span_row, span_of_blk,
                            gblk_flat):
        """MaxScore's essential/non-essential split at plan time
        (maxscore_query's candidate restriction, queries.hpp:478-591): per
        query, sort terms ascending by their max contribution
        qw*list_wmax; the maximal prefix whose cumulative sum stays below
        theta is NON-ESSENTIAL (no doc scoring >= theta consists of
        non-essential postings alone), so a surviving non-essential block
        is kept only where its docid range overlaps a surviving ESSENTIAL
        block of the same query. Every top-k doc keeps all its blocks, so
        assembled scores stay exact."""
        B = len(counts)
        nspans = len(t)
        contrib = np.where(missing, 0.0, qw.astype(np.float64) * self.list_wmax[t])
        # within-row ascending contribution order
        order = np.lexsort((contrib, span_row))
        csum = np.cumsum(contrib[order])
        sexcl = np.cumsum(counts) - counts
        row_of_o = span_row[order]
        # per-row exclusive base of the global cumsum (lexsort keeps rows
        # contiguous: row r's ordered spans occupy [sexcl[r], +counts[r]))
        row_base = np.zeros(B, dtype=np.float64)
        nz = counts > 0
        row_base[nz] = np.where(sexcl[nz] > 0, csum[np.maximum(sexcl[nz] - 1, 0)], 0.0)
        within = csum - row_base[row_of_o]
        th_o = theta[row_of_o]
        # non-essential: cumulative max contribution strictly below theta
        # with the UB test's 1e-4 relative slack; rows with no usable
        # theta keep everything essential, and the last (largest) span of
        # each row is always essential
        is_last = np.zeros(nspans, dtype=bool)
        if nspans:
            is_last[np.cumsum(counts)[nz] - 1] = True
        noness_o = np.isfinite(th_o) & (within < th_o - np.abs(th_o) * 1e-4) & ~is_last
        is_noness = np.zeros(nspans, dtype=bool)
        is_noness[order] = noness_o
        if not is_noness.any():
            return keep

        stride = self._short_stride
        dmax_e = self.dmax_blk[gblk_flat]
        dmin_e = self._blk_dlo[gblk_flat]
        row_e = span_row[span_of_blk]
        ess_entry = keep & ~is_noness[span_of_blk]
        non_entry = keep & is_noness[span_of_blk]
        if not non_entry.any():
            return keep
        eidx = np.nonzero(ess_entry)[0]
        eidx = eidx[np.argsort(row_e[eidx] * stride + dmax_e[eidx], kind="stable")]
        ekey = row_e[eidx] * stride + dmax_e[eidx]
        # keyed suffix-min of dmin: later rows' keys exceed any same-row
        # dhi by construction (dmin < stride), so no cross-row overlap
        kmin = row_e[eidx] * stride + dmin_e[eidx]
        sufmin = np.minimum.accumulate(kmin[::-1])[::-1] if len(kmin) else kmin
        nidx = np.nonzero(non_entry)[0]
        pos = np.searchsorted(ekey, row_e[nidx] * stride + dmin_e[nidx])
        posc = np.minimum(pos, max(len(ekey) - 1, 0))
        ok = ((pos < len(ekey))
              & (ekey[posc] < (row_e[nidx] + 1) * stride)
              & (sufmin[posc] - row_e[nidx] * stride <= dmax_e[nidx])
              ) if len(ekey) else np.zeros(len(nidx), dtype=bool)
        keep = keep.copy()
        keep[nidx[~ok]] = False
        return keep

    def _probe_theta(self, pdir, terms, qw, counts, k, tmax, op, tally):
        """Run a one-shot pruned sub-plan over directory pdir on the
        device (f32 downloads) and return each row's k-th best `op`
        ("or" or "and") score, -inf where it found fewer than k. Its rows
        add to tally["probe_rows"], the batch plan's count; the sub-plan
        keeps counts of its own."""
        tally["probe_rows"] += len(counts)
        qe = np.cumsum(counts)
        qs = qe - counts
        with span("ds2i.split"):
            parts = self._split_parts(pdir, counts)
        plans = []
        for q0, q1, pd in parts:
            with span("ds2i.layout"):
                pp = self._part_plan(terms[qs[q0]:qe[q1 - 1]], qw[qs[q0]:qe[q1 - 1]],
                                     counts[q0:q1], k, (op,), tmax, qids=np.arange(q0, q1),
                                     pruned_dir=pd)
            pp["fscale"] = None  # thresholds need f32 downloads
            plans.append(pp)
        pplan = _plan(plans, len(counts), k, (op,), dir_kept=len(pdir[0]))
        col = 2 if op == "or" else 3
        theta = np.full(len(counts), -np.inf)
        for qi, r in enumerate(self.collect(pplan, self.dispatch(pplan))):
            s = np.asarray(r[col])
            fin = s[np.isfinite(s)]
            if len(fin) >= k:
                theta[qi] = float(fin[k - 1])
        return theta

    def _and_prefix_probe(self, dir0, terms, qw, counts, k, tmax, tally):
        """Docid-prefix AND probe: for rows whose overlap-pruned directory
        is still heavy (more than AND_PROBE_MIN_BLOCKS blocks), execute
        the intersection restricted to the blocks whose docid range starts
        within the rarest span's first AND_PROBE_BLOCKS kept blocks. Any
        doc fully covered by a block subset scores exactly under AND, so
        each row's k-th best probe score is an ACHIEVED lower bound on its
        true k-th best: the theta that lets _pruned_directory drop blocks
        whose score upper bound cannot reach the top-k (a WAND cursor's
        threshold tightening as the heap fills, queries.hpp:200-319).
        Returns per-row theta (-inf where the probe found fewer than k
        results) or None when no row is heavy. The rows it probes add to
        tally["probe_rows"] (_probe_theta)."""
        gk, sk, rb, rnb = dir0
        B = len(counts)
        H, P = self.AND_PROBE_MIN_BLOCKS, self.AND_PROBE_BLOCKS
        heavy = rnb > H
        if not heavy.any() or not len(gk):
            return None
        span_row = np.repeat(np.arange(B), counts)
        sexcl = np.cumsum(counts) - counts
        span_cnt = np.bincount(sk, minlength=len(terms)).astype(np.int64)
        # rarest span per row (kept-block counts; dir entries are row-major
        # with span-contiguous runs)
        slot_of_span = np.arange(len(terms), dtype=np.int64) - sexcl[span_row]
        KEY = 64
        key = span_cnt * KEY + slot_of_span
        rare_key = np.full(B, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(rare_key, span_row, key)
        has = counts > 0
        rare_span = np.where(has, sexcl + (rare_key % KEY), 0)
        rare_cnt = np.where(has, rare_key // KEY, 0)
        # per-row docid cutoff: the rare span's P-th kept block's dmax
        g_excl = np.cumsum(span_cnt) - span_cnt
        ok = heavy & (rare_cnt > 0)
        if not ok.any():
            return None
        last_e = g_excl[rare_span] + np.minimum(rare_cnt, P) - 1
        X = np.full(B, -1, dtype=np.int64)
        X[ok] = self.dmax_blk[gk[last_e[ok]]]
        mask = ok[rb] & (self._blk_dlo[gk] <= X[rb])
        if not mask.any():
            return None
        # compact the probe batch to the heavy rows only
        hrows = np.nonzero(ok)[0]
        hmap = np.full(B, -1, dtype=np.int64)
        hmap[hrows] = np.arange(len(hrows))
        hspan = ok[span_row]
        ns_of_os = np.cumsum(hspan) - 1
        pdir = (gk[mask], ns_of_os[sk[mask]], hmap[rb[mask]],
                np.bincount(hmap[rb[mask]], minlength=len(hrows)).astype(np.int64))
        theta_h = self._probe_theta(pdir, terms[hspan], qw[hspan], counts[hrows], k, tmax, "and",
                                    tally)
        theta = np.full(B, -np.inf)
        theta[hrows] = theta_h
        return theta if np.any(np.isfinite(theta)) else None

    def _split_parts(self, full_dir, counts):
        """Split a batch into parts by the PRUNED per-query slot cost and
        slice the batch-wide pruned directory for each part: a list of
        (q0, q1, (gblk_kept, span_kept_local, row_of_blk_local,
        row_nb_local)). Directory entries are row-major (spans are
        query-major and blocks span-major), so each part's slice is
        contiguous."""
        gblk_kept, span_kept, row_of_blk, row_nb = full_dir
        B = len(counts)
        Lb = np.maximum(row_nb * BLOCK, 1)
        Lb = np.maximum(2 ** np.ceil(np.log2(np.maximum(Lb, self.MIN_L))).astype(np.int64),
                        self.MIN_L)
        parts = []
        cur0, cur_slots = 0, 0
        for qi in range(B):
            if qi > cur0 and (cur_slots + Lb[qi] > self.max_part_slots
                              or qi - cur0 >= self.max_part_queries):
                parts.append((cur0, qi))
                cur0, cur_slots = qi, 0
            cur_slots += Lb[qi]
        parts.append((cur0, B))
        sexcl = np.cumsum(counts) - counts
        bounds = np.searchsorted(row_of_blk, [q for q, _ in parts] + [B])
        return [(q0, q1, (gblk_kept[e0:e1], span_kept[e0:e1] - sexcl[q0],
                          row_of_blk[e0:e1] - q0, row_nb[q0:q1]))
                for (q0, q1), e0, e1 in zip(parts, bounds[:-1], bounds[1:]) if q1 > q0]

    def _part_plan(self, terms, qw, counts, k, ops, tmax, qids, pruned_dir=None):
        """Layout for one part: group-major unique-tile ids + per-bucket
        block directories. All numpy, no device work (the pruning tables
        are device results held on the host). pruned_dir: the part's
        slice of the batch's block-max pruned directory (_split_parts),
        so only the surviving tiles decode; None: every block of every
        term."""
        B = len(counts)
        span_row = np.repeat(np.arange(B), counts)
        sexcl = np.cumsum(counts) - counts
        slot_of_span = np.arange(len(terms), dtype=np.int64) - sexcl[span_row]

        if pruned_dir is not None:
            gblk_kept, span_kept, row_of_blk, row_nb = pruned_dir
            tot = len(gblk_kept)
            tiles_kept = self.tile_of_gblk[gblk_kept] if tot else np.zeros(0, np.int64)
            utidx = np.unique(tiles_kept)
            groups, gtile_ids, tblk, sent_blk, nb_d = self._order_groups(
                utidx, *self._docs_grouping())
            groups_f, gtile_f, blkperm = self._split_layout(utidx, tblk, nb_d)
            tot_blk = int(self.tile_blocks[utidx].sum())
            if tot:
                pos = np.searchsorted(utidx, tiles_kept)
                local_blk = tblk[pos] + (gblk_kept - self.gblk0[tiles_kept])
                dir_flat = (local_blk << 5) | slot_of_span[span_kept]
                rexcl = np.zeros(B + 1, dtype=np.int64)
                rexcl[1:] = np.cumsum(row_nb)
                col_of_blk = np.arange(tot, dtype=np.int64) - rexcl[row_of_blk]
            else:
                dir_flat = col_of_blk = np.zeros(0, np.int64)
        else:
            uterms, uinv = (
                np.unique(terms, return_inverse=True) if len(terms) else
                (np.zeros(0, np.int64), np.zeros(0, np.int64))
            )

            # --- unique-term tile expansion (CSR)
            tstarts, tcounts = self._term_tiles(uterms)
            ntiles = int(tcounts.sum())
            if ntiles:
                excl = np.cumsum(tcounts) - tcounts
                utidx = np.repeat(tstarts - excl, tcounts) + np.arange(ntiles, dtype=np.int64)
            else:
                utidx = np.zeros(0, dtype=np.int64)

            # --- group by decode class, group-major row ids
            groups, gtile_ids, tblk, sent_blk, nb_d = self._order_groups(
                utidx, *self._docs_grouping())
            groups_f, gtile_f, blkperm = self._split_layout(utidx, tblk, nb_d)

            # --- per-unique-term block lists (group-major block ids)
            nbt = self.tile_blocks[utidx]  # blocks of each utile
            tot_blk = int(nbt.sum())
            if tot_blk:
                bexcl = np.cumsum(nbt) - nbt
                # block b of utile i -> tblk[i] + b
                ublocks = np.repeat(tblk - bexcl, nbt) + np.arange(tot_blk, dtype=np.int64)
            else:
                ublocks = np.zeros(0, dtype=np.int64)
            # CSR over unique terms (utidx is unique-major, so ublocks is too)
            unb = self._term_blocks(uterms)
            ustart = np.concatenate([[0], np.cumsum(unb)])

            # --- per-query block directory
            span_nb = unb[uinv] if len(terms) else np.zeros(0, np.int64)
            row_nb = np.zeros(B, dtype=np.int64)
            np.add.at(row_nb, span_row, span_nb)

            # expand each span's blocks, query-major
            tot = int(span_nb.sum())
            if tot:
                bexcl2 = np.cumsum(span_nb) - span_nb
                span_of_blk = np.repeat(np.arange(len(span_nb)), span_nb)
                blk_flat = ublocks[
                    np.repeat(ustart[uinv] - bexcl2, span_nb) + np.arange(tot, dtype=np.int64)
                ]
                dir_flat = (blk_flat << 5) | slot_of_span[span_of_blk]
                row_of_blk = span_row[span_of_blk]
                # column of each block within its row
                rexcl = np.zeros(B + 1, dtype=np.int64)
                rexcl[1:] = np.cumsum(row_nb)
                col_of_blk = np.arange(tot, dtype=np.int64) - rexcl[row_of_blk]
            else:
                dir_flat = row_of_blk = col_of_blk = np.zeros(0, np.int64)

        row_ent0 = np.cumsum(row_nb) - row_nb  # each row's first entry in dir_flat
        min_l = max(self.MIN_L, _pow2_at_least(k))
        Lrow = np.maximum(row_nb * BLOCK, 1)
        Lb = (2 ** np.ceil(np.log2(np.maximum(Lrow, min_l)))).astype(np.int64)
        bkey = Lb << 32

        # --- bucket the queries by Lb
        plan_buckets, packed = [], []
        ubl = np.unique(bkey)
        bucket_of_row = np.zeros(B, dtype=np.int64)
        row_in_bucket = np.zeros(B, dtype=np.int64)
        for bi, bk in enumerate(ubl):
            L = int(bk) >> 32
            rows = np.nonzero(bkey == bk)[0]
            packed.append(rows)
            bucket_of_row[rows] = bi
            row_in_bucket[rows] = np.arange(len(rows))
            Bb = _pow2_at_least(len(rows), lo=1)
            nr = len(rows)
            # full Bb rows (sentinel/zero tail), as in the JAX engine
            bdir = np.full((Bb, int(L) // BLOCK), sent_blk << 5, dtype=_I32)
            qwtab = np.zeros((Bb, tmax), dtype=_F32)
            tgt = np.zeros(Bb, dtype=_I32)
            tgt[:nr] = counts[rows].astype(_I32)
            plan_buckets.append(
                {"L": int(L), "Bb": Bb, "rows": qids[rows], "dir": bdir, "qwtab": qwtab, "tgt": tgt}
            )
        # real-row gather over the concatenation of the buckets' Bb rows
        bb_off = np.cumsum([0] + [pb["Bb"] for pb in plan_buckets])
        packed = np.concatenate(packed) if packed else np.zeros(0, np.int64)
        pack_idx = np.concatenate(
            [o + np.arange(len(pb["rows"]), dtype=np.int64)
             for o, pb in zip(bb_off[:-1], plan_buckets)]
        ).astype(_I32) if plan_buckets else np.zeros(0, dtype=_I32)
        row_qw = np.zeros((B, tmax), dtype=_F32)
        if len(terms):
            row_qw[span_row, slot_of_span] = qw
            b_of_span = bucket_of_row[span_row]
            r_of_span = row_in_bucket[span_row]
            for bi, pb in enumerate(plan_buckets):
                m = b_of_span == bi
                pb["qwtab"][r_of_span[m], slot_of_span[m]] = qw[m]
        if tot:
            b_of = bucket_of_row[row_of_blk]
            r_of = row_in_bucket[row_of_blk]
            for bi, pb in enumerate(plan_buckets):
                m = b_of == bi
                pb["dir"][r_of[m], col_of_blk[m]] = dir_flat[m]

        # f16 download scaling: find a power of two putting every possible
        # finite score in f16's normal range [~6.1e-5, 65504); None -> f32.
        fscale = 1.0
        pos = qw[qw > 0]
        if len(pos):
            min_s = float(pos.min()) * self._wmin  # >= any finite score's floor
            row_qwsum = np.zeros(B, dtype=np.float64)
            np.add.at(row_qwsum, span_row, qw.astype(np.float64))
            max_s = float(row_qwsum.max())  # >= any score (w < 1)
            lo, hi = 6.2e-5, 6.0e4  # normal-f16 window with margin
            if min_s > 0 and max_s / min_s <= hi / lo:
                kmin = math.ceil(math.log2(lo / min_s))
                if max_s * 2.0**kmin <= hi:
                    fscale = 2.0**kmin
                else:
                    fscale = None
            else:
                fscale = None

        return {
            "fscale": fscale,
            "gtile_ids": gtile_ids,
            "gtile_f": gtile_f,
            "blkperm": blkperm,
            "groups": tuple(groups),
            "groups_f": tuple(groups_f),
            # the CTA tables of the part's decode launches
            "layout": block_decode.PartLayout(groups, groups_f),
            # the join's tables: the buckets (the plain join) and the
            # packed rows' real entries (the join kernel)
            "join": join.JoinLayout(dir_flat.astype(_I32), row_ent0[packed], row_nb[packed],
                                    counts[packed], row_qw[packed], plan_buckets, pack_idx, k,
                                    ops, tmax),
            "buckets": plan_buckets,
            "pack_idx": pack_idx,
            "sent_dir": int(sent_blk << 5),
            "decode_blocks": tot_blk,  # the blocks of the part's tiles
            "k": k,
            "ops": ops,
            "tmax": tmax,
        }

    def prepare(self, queries, k=10, ops=("or", "and"), ranked=True, prune=False):
        """Parse + lay out the batch. Host only for the exhaustive plan.
        prune=True applies block-max skipping: ops=("and",) intersection
        block skipping (and_skip), ops=("or",) WAND, prune="maxscore"
        with ops=("or",) MaxScore; it builds the block-max metadata on
        first use (_ensure_blockmax) and runs a probe sub-plan on the
        device. Every plan carries plan["counts"] (PLAN_COUNTS)."""
        bad_ops = set(ops) - {"counts", "or", "and"}
        if bad_ops:
            raise ValueError(
                f"unknown ops {sorted(bad_ops)}: ResidentEngine ops are "
                "'counts', 'or', 'and' (+ ranked=True for scored top-k; "
                "wand/maxscore are prepare(prune=True, ops=('or',)))"
            )
        if prune and (tuple(ops) not in (("or",), ("and",)) or not ranked):
            raise ValueError(
                "prune requires ranked ops=('or',) (WAND/MaxScore) or "
                "ops=('and',) (intersection block skipping)"
            )
        if prune:
            self._ensure_blockmax()
        with span("ds2i.parse"):
            terms, qw, counts = self._prep_terms(queries, ranked)
        qend = np.cumsum(counts)
        qstart = qend - counts
        tmax = _pow2_at_least(int(counts.max()) if len(counts) else 1, lo=2)
        if tmax > 32:
            # the block directory packs the term slot into 5 bits next to
            # the block id ((blk << 5) | slot, ops/join.py)
            bad = int(np.argmax(counts > 32))
            raise ValueError(
                f"ResidentEngine supports at most 32 unique terms per "
                f"query (query {bad} has {int(counts[bad])})"
            )
        if prune:
            return self._prepare_pruned(terms, qw, counts, qstart, qend, k, tuple(ops), tmax,
                                        prune)

        with span("ds2i.split"):
            # part splitting by bucketed (unpruned) slot budget
            qslots = np.zeros(len(queries), dtype=np.int64)
            nb = self._term_blocks(terms)
            if len(terms):
                np.add.at(qslots, np.repeat(np.arange(len(queries)), counts), nb * BLOCK)
            qslots = np.maximum(
                2 ** np.ceil(np.log2(np.maximum(qslots, self.MIN_L))).astype(np.int64), self.MIN_L)

            parts = []
            cur0, cur_slots = 0, 0
            for qi in range(len(queries)):
                if qi > cur0 and (
                    cur_slots + qslots[qi] > self.max_part_slots
                    or qi - cur0 >= self.max_part_queries
                ):
                    parts.append((cur0, qi))
                    cur0, cur_slots = qi, 0
                cur_slots += qslots[qi]
            parts.append((cur0, len(queries)))

        plans = []
        for q0, q1 in parts:
            if q1 <= q0:
                continue
            s0, s1 = qstart[q0], qend[q1 - 1]
            with span("ds2i.layout"):
                plans.append(
                    self._part_plan(
                        terms[s0:s1], qw[s0:s1], counts[q0:q1], k, tuple(ops), tmax,
                        qids=np.arange(q0, q1),
                    )
                )
        n_blocks = int(nb.sum())  # the exhaustive directory holds every block of every term
        return _plan(plans, len(queries), k, tuple(ops), dir_blocks=n_blocks, dir_kept=n_blocks)

    def _prepare_pruned(self, terms, qw, counts, qstart, qend, k, ops, tmax, prune):
        """prepare's pruned plan: the probe's thresholds, the batch's
        pruned directory (AND: the overlap-pruned one, its thresholded
        rows recomputed), then parts split by the slots that survive
        (_split_parts)."""
        B = len(counts)
        span_row = np.repeat(np.arange(B), counts)
        mode = "and" if ops == ("and",) else "or"
        tally = {"probe_rows": 0}
        dir0 = theta_key = cached = None
        if self.cache_dir:
            # the probe's thresholds are a function of the parsed batch, k,
            # the mode and the probe's constants on this index: cache_dir
            # replays them across restarts
            with span("ds2i.theta_cache"):
                theta_key = self._theta_key(terms, qw, counts, k, mode)
                cached = self._cache_load(theta_key, with_norms=True, names=("theta",))
        if cached is not None:
            theta = cached["theta"]
            probe_theta = theta if np.any(np.isfinite(theta)) else None
        elif mode == "or":
            # phase 1: score only each term's top blocks by block max; the
            # per-query k-th best is a TRUE achieved partial score, a much
            # tighter threshold than the static single-term bound
            with span("ds2i.probe"):
                with span("ds2i.prune"):
                    pdir = self._pruned_directory(terms, qw, counts, k, span_row,
                                                  probe_rank=max(2, -(-2 * k // BLOCK)))
                probe_theta = self._probe_theta(pdir, terms, qw, counts, k, tmax, "or", tally)
        else:
            # phase 1 for AND: overlap-prune, then the docid-prefix probe
            # on the still-heavy rows (_and_prefix_probe)
            with span("ds2i.prune"):
                dir0 = self._pruned_directory(terms, qw, counts, k, span_row, mode="and")
            with span("ds2i.probe"):
                probe_theta = self._and_prefix_probe(dir0, terms, qw, counts, k, tmax, tally)
        if theta_key is not None and cached is None:
            with span("ds2i.theta_cache"):
                self._cache_save(theta_key, with_norms=True,
                                 theta=probe_theta if probe_theta is not None
                                 else np.full(B, -np.inf))
        refined = 0
        if dir0 is not None:
            # phase 2 for AND: the phase-1 directory with the thresholded
            # rows recomputed (all of it is final when no row is heavy)
            full_dir = dir0
            if probe_theta is not None:
                with span("ds2i.prune"):
                    full_dir, refined = self._refine_and_directory(dir0, terms, qw, counts, k,
                                                                   probe_theta)
        else:
            with span("ds2i.prune"):
                full_dir = self._pruned_directory(terms, qw, counts, k, span_row,
                                                  theta_override=probe_theta, mode=mode,
                                                  essential=(prune == "maxscore"))
        with span("ds2i.split"):
            parts = self._split_parts(full_dir, counts)
        plans = []
        for q0, q1, pd in parts:
            with span("ds2i.layout"):
                plans.append(self._part_plan(
                    terms[qstart[q0]:qend[q1 - 1]], qw[qstart[q0]:qend[q1 - 1]], counts[q0:q1],
                    k, ops, tmax, qids=np.arange(q0, q1), pruned_dir=pd))
        return _plan(plans, B, k, ops, dir_blocks=int(self._term_blocks(terms).sum()),
                     dir_kept=len(full_dir[0]), probe_rows=tally["probe_rows"],
                     refined_rows=refined)

    def _refine_and_directory(self, dir0, terms, qw, counts, k, theta):
        """The final AND directory from the overlap-pruned one (dir0,
        row-major) and the probe's per-row theta: _pruned_directory with
        theta_override over the sub-batch of the rows with a finite theta,
        spliced into dir0 in place of those rows' entries. The other rows
        keep dir0's entries, which the call over the whole batch would
        give them again: a row's pairs and fixpoint see only its own
        spans, the score test only rows with a threshold, and the fixpoint
        stops each row where it converges or at AND_FIXPOINT_ROUNDS in
        both calls. Returns (directory, the number of rows recomputed)."""
        gk, sk, rb, rnb = dir0
        B = len(counts)
        rows = np.nonzero(np.isfinite(theta))[0]
        in_sub = np.zeros(B, dtype=bool)
        in_sub[rows] = True
        spans = np.nonzero(np.repeat(in_sub, counts))[0]  # the sub-batch's spans, row-major
        sub_counts = counts[rows]
        g, s, r, nb = self._pruned_directory(
            terms[spans], qw[spans], sub_counts, k,
            np.repeat(np.arange(len(rows)), sub_counts), theta_override=theta[rows], mode="and")
        row_nb = rnb.copy()
        row_nb[rows] = nb
        # each entry's place: its row's start in the result plus its rank
        # within the row, which both inputs keep in order
        start = np.cumsum(row_nb) - row_nb
        old = np.nonzero(~in_sub[rb])[0]
        pos_old = start[rb[old]] + old - (np.cumsum(rnb) - rnb)[rb[old]]
        pos_new = start[rows[r]] + np.arange(len(g)) - (np.cumsum(nb) - nb)[r]
        out = []
        for a, b in ((gk, g), (sk, spans[s]), (rb, rows[r])):
            o = np.empty(int(row_nb.sum()), dtype=a.dtype)
            o[pos_old] = a[old]
            o[pos_new] = b
            out.append(o)
        return (*out, row_nb), len(rows)

    def _theta_key(self, terms, qw, counts, k, mode):
        """The cache piece of a pruned batch's probe thresholds: the parsed
        batch, k, the mode and the probe's constants (the JAX engine's
        knobs)."""
        h = hashlib.blake2b(digest_size=12)
        for a in (terms, qw, counts):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(str((k, mode, self.AND_PROBE_MIN_BLOCKS, self.AND_PROBE_BLOCKS,
                      self.AND_FIXPOINT_ROUNDS)).encode())
        return f"theta_{mode}_{h.hexdigest()}"

    def execute(self, plan):
        """Upload per-part layouts, dispatch, download results. A plan's
        layout tensors stay on the device after its first execution and
        are reused by later executions of the same plan; postings are
        decoded from the compressed index every time."""
        return self.collect(plan, self.dispatch(plan))

    def dispatch(self, plan):
        """Enqueue every part's device work and its device->host copy
        without waiting for either; with replicas (devices=), part i runs
        on replica i % len(devices), its download on that replica's
        device."""
        ranked_ops = any(("or" in p["ops"]) or ("and" in p["ops"]) for p in plan["plans"])
        if ranked_ops:
            self._ensure_norm_cache()
        replicas = self._replicas or [self.state]
        pending = []
        uploaded = 0
        for pi, p in enumerate(plan["plans"]):
            state = replicas[pi % len(replicas)]
            dev = state.device
            with _on(dev):
                cache = p.setdefault("_dev", {})
                if dev not in cache:
                    with span("ds2i.upload"):
                        cache[dev] = tuple(
                            torch.from_numpy(p[name].astype(np.int64)).to(dev, non_blocking=True)
                            for name in ("gtile_ids", "gtile_f", "blkperm"))
                        uploaded += (sum(t.nbytes for t in cache[dev]) + p["layout"].upload(dev)
                                     + p["join"].upload(dev))
                d_gt, d_gf, d_bp = cache[dev]
                fetch16 = "counts" not in p["ops"] and p["fscale"] is not None
                out = _resident_step(
                    state, d_gt, d_gf, d_bp, p["layout"], p["join"], num_docs=self.num_docs,
                    fetch16=fetch16, fscale=p["fscale"] if fetch16 else None,
                )
                with span("ds2i.download"):
                    if out.is_cuda:
                        # the download starts as soon as this part's compute
                        # ends (on its device's stream), overlapping later
                        # parts' compute
                        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                        host.copy_(out, non_blocking=True)
                        out = host
            pending.append((p, out))
        plan["counts"]["upload_bytes"] += uploaded
        return pending

    def collect(self, plan, pending):
        """Wait for a dispatch() on every replica's device and unpack its
        results."""
        with span("ds2i.wait"):
            for dev in dict.fromkeys(r.device for r in (self._replicas or [self.state])):
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
        results = [None] * plan["n"]
        with span("ds2i.unpack"):
            for p, out in pending:
                packed = out.numpy()
                if packed.dtype == np.float16:
                    packed = packed.astype(np.float32) / np.float32(p["fscale"])
                ops = p["ops"]
                off = 0
                c0 = 2 if "counts" in ops else 0
                c_or = c0 + (p["k"] if "or" in ops else 0)
                for b in p["buckets"]:
                    rows = packed[off: off + len(b["rows"])]
                    off += len(b["rows"])
                    for local, qi in enumerate(b["rows"]):
                        r = rows[local]
                        results[qi] = (
                            int(r[0]) if c0 else 0,
                            int(r[1]) if c0 else 0,
                            r[c0:c_or] if "or" in ops else None,
                            r[c_or: c_or + p["k"]] if "and" in ops else None,
                        )
        return results

    def run(self, queries, k=10, ops=("or", "and"), ranked=True, prune=False):
        return self.execute(self.prepare(queries, k=k, ops=ops, ranked=ranked, prune=prune))

    # -- public ops -------------------------------------------------------------

    def and_counts(self, queries):
        return np.array([r[0] for r in self.run(queries, ops=("counts",), ranked=False)])

    def or_counts(self, queries):
        return np.array([r[1] for r in self.run(queries, ops=("counts",), ranked=False)])

    def _topk_list(self, r):
        return [float(s) for s in r[np.isfinite(r)]]

    def ranked_or(self, queries, k=10):
        return [self._topk_list(r[2]) for r in self.run(queries, k=k, ops=("or",))]

    def ranked_and(self, queries, k=10, prune=False):
        """prune=True skips blocks provably outside the intersection or
        below the probe's threshold (and_skip; results identical)."""
        return [
            self._topk_list(r[3])
            for r in self.run(queries, k=k, ops=("and",), prune=prune)
        ]

    def wand(self, queries, k=10):
        """Top-k OR with block-max pruning (wand_query semantics,
        queries.hpp:200-319): results equal ranked_or's top-k; blocks
        provably below the per-query threshold are skipped before decode,
        shrinking both the decode set and the join width."""
        return [self._topk_list(r[2]) for r in self.run(queries, k=k, ops=("or",), prune=True)]

    def maxscore(self, queries, k=10):
        """Top-k OR with MaxScore's candidate restriction on the block-max
        directory (maxscore_query semantics, queries.hpp:478-591, at plan
        time, _essential_restrict): results equal ranked_or's top-k."""
        return [
            self._topk_list(r[2])
            for r in self.run(queries, k=k, ops=("or",), prune="maxscore")
        ]
