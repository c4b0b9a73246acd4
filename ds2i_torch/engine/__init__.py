"""The port's serving engine (EF-family indexes in pair mode, the block
indexes block_optpfor, block_varint, block_interpolative, block_qmx and
block_mixed in split mode), and make_engine, which shards an index by
doc range once it outgrows one engine; beside them the JAX package's
three earlier engine generations over a DeviceIndex (EF-family indexes):
QueryEngine (score planes), FlatQueryEngine (one sorted postings stream)
and TileQueryEngine (scatter-free tiles)."""

import torch

from ..device import resolve_device
from .device_index import DeviceIndex
from .executor import QueryEngine
from .flat_executor import FlatQueryEngine
from .resident import ResidentEngine
from .state import ResidentState, resident_state_from_arrays
from .tile_executor import TileQueryEngine

__all__ = ["RESIDENT_STREAM_LIMIT", "DeviceIndex", "FlatQueryEngine", "QueryEngine",
           "ResidentEngine", "ResidentState", "TileQueryEngine", "make_engine",
           "resident_state_from_arrays", "resident_stream_limit"]

# The JAX engine's split point: its tile cursors are (i32 word, bit in
# word) pairs, so a stream holds at most 2^36 bits = 8 GB, and the
# factory keeps the resident bytes under that, less 1 MiB.
RESIDENT_STREAM_LIMIT = (1 << 33) - (1 << 20)  # bytes


def resident_stream_limit(device=None):
    """make_engine's default split point on `device`: RESIDENT_STREAM_LIMIT,
    or half the card's memory where that is less, so the tile tables,
    the norm cache and a part's decode buffers fit beside the words. On
    an 80 GB H100 half the memory is ~42 GB, so the limit is the JAX
    package's and both packages pick the same shard count for any index."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return min(RESIDENT_STREAM_LIMIT, torch.cuda.get_device_properties(dev).total_memory // 2)
    return RESIDENT_STREAM_LIMIT


def make_engine(index, wdata=None, devices=None, limit=None, **kw):
    """Engine factory: a single ResidentEngine (replicated over `devices`
    when given) when the index fits one engine's resident-stream budget
    (`limit` bytes, default resident_stream_limit of the first device),
    else a DocShardedEngine with just enough doc-range shards, shard i on
    devices[i % len(devices)] when given. Bytes are counted as the JAX
    package counts them: a block index's bytes, or both EF streams'
    words."""
    if limit is None:
        limit = resident_stream_limit(devices[0] if devices else kw.get("device"))
    nbytes = (
        len(index.lists) if hasattr(index, "lists")
        else (len(index.docs_sequences.bits_bv.words) + len(index.freqs_sequences.bits_bv.words)) * 8
    )
    if nbytes <= limit:
        return ResidentEngine(index, wdata, devices=devices, **kw)
    from ..parallel import DocShardedEngine

    # doc ranges split bytes unevenly on skewed collections; the 0.6
    # headroom factor absorbs skew (ResidentEngine raises loudly on any
    # per-shard stream that still exceeds the hard limit, both families)
    shards = max(-(-nbytes // max(int(limit * 0.6), 1)), len(devices) if devices else 1)
    return DocShardedEngine(index, wdata, num_shards=int(shards), devices=devices, **kw)
