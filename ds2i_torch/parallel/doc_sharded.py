"""Doc-range-sharded serving: the scale-out path for indexes larger than
one card's memory (a copy of the JAX package's parallel/doc_sharded.py).

The reference is single-node (SURVEY §2.8); the scale answer is sharding
posting lists by document range across devices: every shard holds the
sub-index of its doc range, every query executes on every shard (one
ResidentEngine per shard, optionally pinned to its own device), and
results merge trivially because doc ranges are
disjoint — boolean counts add, top-k score lists k-way merge. BM25
query weights use COLLECTION-level document frequencies (idf is a
global statistic), passed to each shard via ResidentEngine(query_dfs=).

Construction reshards any built index (all 9 types) by decoding each
list once and re-encoding the per-range slices with the type's own
builder (native-accelerated where available). Lists empty in a range
are omitted from that shard's sub-index and mapped to -1 in the shard's
term remap; AND targets still count them, so intersection semantics are
preserved per range.
"""

import numpy as np

from ..engine.resident import ResidentEngine
from ..index.types import make_index_type

NEG_INF = float("-inf")


def _shard_lists(lists_iter, type_name, num_docs, num_shards, params):
    """Shared doc-range split: feeds each (docs, freqs) list's per-range
    slices to one builder per shard. Returns
    (sub_indexes, term_remaps, bounds, global_dfs)."""
    if type_name == "block_mixed":
        # mixed indexes only build by transformation (the WSDM'15 per-block
        # assignment optimizes the UNSHARDED index); shards re-encode as
        # block_optpfor -- same results, re-run the hybrid pipeline per
        # shard to re-optimize space/time if desired
        type_name = "block_optpfor"
    cls = make_index_type(type_name)
    N = num_docs
    bounds = np.array([round(N * s / num_shards) for s in range(num_shards + 1)], dtype=np.int64)

    builders = [cls.builder(N, params) for _ in range(num_shards)]
    remaps = []
    sizes = [0] * num_shards
    global_dfs = []
    for docs, freqs in lists_iter:
        docs = np.asarray(docs, dtype=np.int64)
        freqs = np.asarray(freqs, dtype=np.int64)
        global_dfs.append(len(docs))
        cuts = np.searchsorted(docs, bounds)
        row = np.full(num_shards, -1, dtype=np.int64)
        for s in range(num_shards):
            lo, hi = int(cuts[s]), int(cuts[s + 1])
            if hi <= lo:
                continue
            builders[s].add_posting_list(
                hi - lo, docs[lo:hi], freqs[lo:hi], int(freqs[lo:hi].sum())
            )
            row[s] = sizes[s]
            sizes[s] += 1
        remaps.append(row)
    remaps = np.array(remaps, dtype=np.int64).T if remaps else np.zeros((num_shards, 0), np.int64)
    return (
        [b.build() for b in builders],
        [remaps[s] for s in range(num_shards)],
        bounds,
        np.asarray(global_dfs, dtype=np.int64),
    )


def shard_collection_by_doc_range(coll, type_name, num_shards, params=None):
    """Build per-doc-range sub-indexes DIRECTLY from a binary collection --
    the practical path at scale (resharding a built index decodes every
    list; building from source splits each list with one searchsorted)."""
    from ..global_params import GlobalParameters

    return _shard_lists(
        iter(coll), type_name, coll.num_docs, num_shards, params or GlobalParameters()
    )


def shard_index_by_doc_range(index, num_shards):
    """Split a built index into per-doc-range sub-indexes.

    Returns (sub_indexes, term_remaps, bounds, global_dfs): sub-index i
    holds docs in [bounds[i], bounds[i+1]) with GLOBAL docids and global
    num_docs; term_remaps[i][t] is t's list id in shard i or -1."""
    lists = (index.decode_list(l) for l in range(index.size()))
    return _shard_lists(
        lists, index.index_type_name, index.num_docs(), num_shards, index.params
    )



class DocShardedEngine:
    """Doc-range-sharded ResidentEngine with the same public query API.

    devices: optional device list; shard i's engine lives on
    devices[i % len(devices)] (its device=, one copy of its state).
    Without devices, every shard takes engine_kw's device (None: the
    CUDA card); giving both raises."""

    def __init__(self, index, wdata=None, num_shards=2, devices=None, **engine_kw):
        subs, remaps, bounds, gdfs = shard_index_by_doc_range(index, num_shards)
        self._init_engines(subs, remaps, bounds, gdfs, wdata, devices, engine_kw)

    @classmethod
    def from_collection(cls, coll, type_name, wdata=None, num_shards=2,
                        devices=None, params=None, **engine_kw):
        """Build the shards directly from a binary collection (one native
        batch build per shard) — the scale path; __init__'s reshard of a
        built index decodes every list in Python."""
        self = cls.__new__(cls)
        subs, remaps, bounds, gdfs = shard_collection_by_doc_range(
            coll, type_name, num_shards, params
        )
        self._init_engines(subs, remaps, bounds, gdfs, wdata, devices, engine_kw)
        return self

    def _init_engines(self, subs, remaps, bounds, gdfs, wdata, devices, engine_kw):
        if devices and engine_kw.get("device") is not None:
            raise ValueError("DocShardedEngine takes devices= or device=, not both")
        self.bounds = bounds
        self.num_shards = len(subs)
        self.engines = []
        for s, (sub, remap) in enumerate(zip(subs, remaps)):
            kw = dict(engine_kw, device=devices[s % len(devices)]) if devices else engine_kw
            self.engines.append(
                ResidentEngine(sub, wdata, query_dfs=gdfs, term_remap=remap, **kw)
            )

    def prepare(self, queries, k=10, ops=("or", "and"), ranked=True, prune=False):
        """prune=True applies each shard's block-max pruning independently
        (queries.hpp:200-319 wand semantics at any index size): doc ranges
        are disjoint, so a per-shard threshold — including each shard's
        phase-1 probe threshold — is valid for that shard's docs, each
        shard's pruned top-k equals its exhaustive top-k exactly, and the
        k-way merge of exact per-range top-k lists is the exact global
        top-k."""
        return {
            "shards": [
                e.prepare(queries, k=k, ops=ops, ranked=ranked, prune=prune)
                for e in self.engines
            ],
            "k": k,
            "ops": tuple(ops),
            "n": len(queries),
        }

    def execute(self, plan):
        # dispatch every shard before collecting any: shards overlap on
        # their own devices exactly like parts do on one
        pendings = [e.dispatch(p) for e, p in zip(self.engines, plan["shards"])]
        per_shard = [
            e.collect(p, pend)
            for e, p, pend in zip(self.engines, plan["shards"], pendings)
        ]
        k = plan["k"]
        merged = []
        for qi in range(plan["n"]):
            rows = [sr[qi] for sr in per_shard]
            and_c = sum(r[0] for r in rows)
            or_c = sum(r[1] for r in rows)

            def topk(idx):
                if rows[0][idx] is None:
                    return None
                allv = np.concatenate([np.asarray(r[idx], dtype=np.float32) for r in rows])
                allv = np.sort(allv)[::-1]
                return allv[:k]

            merged.append((and_c, or_c, topk(2), topk(3)))
        return merged

    def run(self, queries, k=10, ops=("or", "and"), ranked=True, prune=False):
        return self.execute(
            self.prepare(queries, k=k, ops=ops, ranked=ranked, prune=prune)
        )

    # -- public ops (mirror ResidentEngine) ------------------------------------

    def and_counts(self, queries):
        return np.array([r[0] for r in self.run(queries, ops=("counts",), ranked=False)])

    def or_counts(self, queries):
        return np.array([r[1] for r in self.run(queries, ops=("counts",), ranked=False)])

    def _topk_list(self, r):
        return [float(s) for s in r[np.isfinite(r)]]

    def ranked_or(self, queries, k=10):
        return [self._topk_list(r[2]) for r in self.run(queries, k=k, ops=("or",))]

    def ranked_and(self, queries, k=10, prune=False):
        """prune=True skips blocks provably outside the intersection per
        shard (device leapfrog analogue; results identical)."""
        return [
            self._topk_list(r[3])
            for r in self.run(queries, k=k, ops=("and",), prune=prune)
        ]

    def wand(self, queries, k=10):
        """Top-k OR with per-shard block-max pruning: results equal
        ranked_or's exactly (each shard's pruned top-k is exact for its
        disjoint doc range; the merge is exact)."""
        return [
            self._topk_list(r[2])
            for r in self.run(queries, k=k, ops=("or",), prune=True)
        ]

    def maxscore(self, queries, k=10):
        """Per-shard device MaxScore (the round-5 essential-restriction
        algorithm, ResidentEngine.maxscore): prune='maxscore' forwards to
        every shard; results equal ranked_or's exactly by the same
        disjoint-doc-range merge argument as wand."""
        return [
            self._topk_list(r[2])
            for r in self.run(queries, k=k, ops=("or",), prune="maxscore")
        ]
