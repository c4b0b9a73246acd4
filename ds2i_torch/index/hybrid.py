"""Optimal hybrid (mixed-codec) index: the WSDM'15 space-time tradeoff
pipeline (optimal_hybrid_index.cpp:304-488).

Per block (docs and freqs separately): enumerate all viable (codec type,
param) points, compute the convex lambda frontier (lambda = d_space /
d_time, dominated points pruned), pool all frontiers, sort by lambda
ascending, and greedily apply upgrades starting from the all-min-space
assignment until the space budget is exhausted; then re-encode every block
with its chosen codec into a block_mixed index.

TPU-native notes: the stxxl out-of-core sort (16 GiB budget,
optimal_hybrid_index.cpp:54,237-240) becomes utils/extsort — sorted runs
spilled under DS2I_SORT_BUDGET, k-way merged into a memmap-able .npy the
greedy sweep pages lazily; the expensive lambda computation is
checkpointed in <lambdas_file> and reused if present, matching the
reference's delete-to-recompute contract (optimal_hybrid_index.cpp:337-343).
"""

import os

import numpy as np

from ..codecs.mixed import BLOCK_TYPES, MixedBlock, compr_params
from ..codecs.time_prediction import FeatureVector, values_statistics
from ..config import Configuration
from ..global_params import GlobalParameters
from ..utils import ProgressLogger, logger, stats_line
from .block_index import BlockData, BlockPostingList
from .types import make_index_type

LAMBDA_DTYPE = np.dtype(
    [("block_id", np.uint32), ("lambda", np.float32), ("time", np.float32),
     ("space", np.uint16), ("type", np.uint8), ("param", np.uint8)]
)


def _append_lambdas(points, block_id, out, heuristic_greedy):
    points.sort(key=lambda p: p.sort_key())
    buf = [(block_id, 0.0, points[0])]
    for cur in points:
        while True:
            prev = buf[-1]
            if cur.time >= prev[2].time:
                break
            lam = (cur.space - prev[2].space) / (prev[2].time - cur.time)
            if not heuristic_greedy and lam < prev[1]:
                buf.pop()
            else:
                buf.append((block_id, lam, cur))
                break
    for bid, lam, p in buf:
        out.append((bid, lam, p.time, p.space, p.type, p.param))


def compute_lambdas(index, predictors, block_counts_by_list, lambdas_path):
    """Per-block lambda frontiers -> lambda-sorted memmap-able array,
    checkpointed in lambdas_path. The sort runs out-of-core under the
    configured budget (stxxl::sort parity), so the returned array should
    be iterated, not materialized, at large scale."""
    if os.path.exists(lambdas_path):
        logger(f"Found lambdas file {lambdas_path}, skipping recomputation")
        logger("To recompute lambdas, remove file")
        return np.load(lambdas_path, mmap_mode="r")

    conf = Configuration.get()
    from ..codecs.interpolative import UNKNOWN_SUM
    from ..utils.extsort import external_sort_to_file

    plog = ProgressLogger("postings")
    stats = {"freq_zero_lists": 0, "freq_zero_blocks": 0}
    smoothing = 1  # Laplace smoothing
    spill_rows = 1 << 18

    def chunks():
        out = []
        block_id = 0
        for l in range(index.size()):
            blocks = index.get_blocks(l)
            counts = block_counts_by_list.get(l)
            if counts is None:
                stats["freq_zero_lists"] += 1
                stats["freq_zero_blocks"] += 2 * len(blocks)
            else:
                stats["freq_zero_blocks"] += sum(1 for c in counts if c == 0)
            for ib in blocks:
                docs_exp = smoothing + (counts[2 * ib.index] if counts else 0)
                freqs_exp = smoothing + (counts[2 * ib.index + 1] if counts else 0)

                gaps, _ = index.codec.decode(ib.docs_bytes, 0, ib.doc_gaps_universe, ib.size)
                pts = MixedBlock.compute_space_time(gaps[: ib.size], ib.doc_gaps_universe, predictors, docs_exp)
                _append_lambdas(pts, block_id, out, conf.heuristic_greedy)
                block_id += 1

                f1, _ = index.codec.decode(ib.freqs_bytes, 0, UNKNOWN_SUM, ib.size)
                pts = MixedBlock.compute_space_time(f1[: ib.size], UNKNOWN_SUM, predictors, freqs_exp)
                _append_lambdas(pts, block_id, out, conf.heuristic_greedy)
                block_id += 1
                if len(out) >= spill_rows:
                    yield np.array(out, dtype=LAMBDA_DTYPE)
                    out = []
            plog.done_item(index.list_length(l))
        if out:
            yield np.array(out, dtype=LAMBDA_DTYPE)

    n = external_sort_to_file(
        chunks(), LAMBDA_DTYPE, "lambda", lambdas_path, conf.sort_budget
    )
    stats_line(**stats)
    logger(f"{n} lambda points")
    return np.load(lambdas_path, mmap_mode="r")


def greedy_tradeoff(index, lambdas, budget, tradeoff_log=None):
    """Sweep the sorted lambda stream; returns (types, params, space, time)
    per block, or None if budget == 0 (report-only mode)."""
    num_blocks = 0
    space_base = 8
    partial_blocks = 0
    for l in range(index.size()):
        n = index.list_length(l)
        blocks = -(-n // MixedBlock.block_size)
        num_blocks += 2 * blocks
        space_base += (max(int(n).bit_length(), 1) + 6) // 7
        space_base += blocks * 4 + (blocks - 1) * 4
        if n % MixedBlock.block_size != 0:
            partial_blocks += 2
    logger(f"{num_blocks} overall blocks")

    block_spaces = np.zeros(num_blocks, dtype=np.int64)
    block_times = np.zeros(num_blocks, dtype=np.float64)
    block_types = np.zeros(num_blocks, dtype=np.uint8)
    block_params = np.zeros(num_blocks, dtype=np.uint8)
    cur_space = space_base
    cur_time = 0.0
    first_nonzero = True
    seen = 0

    for lp in lambdas:
        bid = int(lp["block_id"])
        cur_space += int(lp["space"]) - block_spaces[bid]
        cur_time += float(lp["time"]) - block_times[bid]
        block_spaces[bid] = lp["space"]
        block_times[bid] = lp["time"]
        block_types[bid] = lp["type"]
        block_params[bid] = lp["param"]
        if lp["lambda"] > 0:
            if first_nonzero:
                logger(f"Minimum feasible space: {cur_space}")
                first_nonzero = False
            if budget == 0:
                if tradeoff_log is not None and seen % max(num_blocks // 2000, 1) == 0:
                    tradeoff_log.write(f"{lp['lambda']}\t{cur_space}\t{cur_time}\n")
                seen += 1
            elif cur_space > budget:
                break

    if budget == 0:
        return None
    logger(f"Found trade-off. Space: {cur_space} Time: {cur_time}")
    stats_line(found_space=int(cur_space), found_time=float(cur_time))

    type_counts = {}
    for t in range(BLOCK_TYPES):
        for p in range(compr_params(t)):
            type_counts[f"({t},{p})"] = 0
    for i in range(num_blocks):
        type_counts[f"({int(block_types[i])},{int(block_params[i])})"] += 1
    stats_line(blocks=num_blocks, partial_blocks=partial_blocks, type_counts=type_counts)
    return block_types, block_params


def mixed_choices(index, seed=0):
    """Per-stream (types, params) for rebuild_mixed over the block_optpfor
    `index` (docs, then freqs, of every block in list order), drawn from
    RandomState(seed) where the hybrid pipeline above would take them from
    a predictors file: PFOR, VARINT or INTERPOLATIVE, a third each. A PFOR
    stream of a full block keeps the b its OptPFor block chose (the
    stream's first byte, as an index into POSS_LOGS), so exceptions occur
    as they do in block_optpfor. Partial blocks stay interpolative
    (rebuild_mixed forces it)."""
    from ..codecs.mixed import PFOR
    from ..codecs.optpfor import POSS_LOGS

    rng = np.random.RandomState(seed)
    types, params = [], []
    for li in range(index.size()):
        for blk in index.get_blocks(li):
            for stream in (blk.docs_bytes, blk.freqs_bytes):
                t = int(rng.randint(3))
                full = blk.size == index.codec.block_size
                types.append(t)
                params.append(POSS_LOGS.index(int(stream[0])) if t == PFOR and full else 0)
    return np.array(types, np.uint8), np.array(params, np.uint8)


def rebuild_mixed(index, block_types, block_params, params=None):
    """Re-encode every block with its chosen (type,param) into block_mixed
    (list_transformer, optimal_hybrid_index.cpp:252-301)."""
    from ..codecs.interpolative import UNKNOWN_SUM
    from ..codecs.mixed import INTERPOLATIVE

    params = params or GlobalParameters()
    mixed_cls = make_index_type("block_mixed")
    b = mixed_cls.builder(index.num_docs(), params)
    plog = ProgressLogger("postings")
    bid = 0
    for l in range(index.size()):
        blocks = index.get_blocks(l)
        out_blocks = []
        for ib in blocks:
            docs_type, docs_param = int(block_types[bid]), int(block_params[bid])
            freqs_type, freqs_param = int(block_types[bid + 1]), int(block_params[bid + 1])
            bid += 2
            gaps, _ = index.codec.decode(ib.docs_bytes, 0, ib.doc_gaps_universe, ib.size)
            f1, _ = index.codec.decode(ib.freqs_bytes, 0, UNKNOWN_SUM, ib.size)
            if ib.size < MixedBlock.block_size:
                docs_type = freqs_type = INTERPOLATIVE
            dchunk, fchunk = [], []
            MixedBlock.encode_type(docs_type, docs_param, gaps[: ib.size], ib.doc_gaps_universe, ib.size, dchunk)
            MixedBlock.encode_type(freqs_type, freqs_param, f1[: ib.size], UNKNOWN_SUM, ib.size, fchunk)
            out_blocks.append(
                BlockData(
                    index=ib.index,
                    max=ib.max,
                    size=ib.size,
                    doc_gaps_universe=ib.doc_gaps_universe,
                    docs_bytes=np.concatenate([np.asarray(c, np.uint8).reshape(-1) for c in dchunk]),
                    freqs_bytes=np.concatenate([np.asarray(c, np.uint8).reshape(-1) for c in fchunk]),
                )
            )
        b.add_posting_list(index.list_length(l), None, blocks=out_blocks)
        plog.done_item(index.list_length(l))
    return b.build()
