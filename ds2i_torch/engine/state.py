"""The resident device state of a ResidentEngine.

What the JAX engine keeps in HBM (ds2i_tpu/engine/resident.py:696-755,
864-899, 1390-1391, 1484-1486): the compressed word streams, the
per-tile field tables with their trailing pad row, the per-doc BM25
denominators, and the init-time norm cache. A block index (split mode)
has ONE word stream for docs and freqs: both fields then name the same
tensor, uploaded and counted once. `resident_state_from_arrays` turns those arrays,
given as numpy (for example read back from a JAX engine), into the port's
tensors; `ResidentEngine.from_state` serves over them.
"""

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .tiles import N_FIELDS


@dataclass
class ResidentState:
    docs_words: torch.Tensor  # int32[nw_d]: the uint32 words' bits
    freqs_words: torch.Tensor  # int32[nw_f]; docs_words itself in split mode
    tiles_docs: torch.Tensor  # int32[Nt+1, N_FIELDS]; last row is the pad tile
    tiles_freqs: torch.Tensor  # int32[Nt+1, N_FIELDS]
    norm_den: torch.Tensor  # float32[num_docs]: k1*(1-b+b*norm_len)
    den_blocks: Optional[torch.Tensor] = None  # float32[total_blocks, 32] norm cache
    tile_gblk0: Optional[torch.Tensor] = None  # int64[Nt+1]: first cache row per tile

    @property
    def device(self):
        return self.docs_words.device

    def nbytes(self):
        """Bytes of all resident tensors (a tensor named twice counts once)."""
        tensors = {id(t): t for t in (getattr(self, f.name) for f in fields(self)) if t is not None}
        return sum(t.numel() * t.element_size() for t in tensors.values())


def _tensor(a, dtype=None):
    """A CPU tensor over a (writable copy of a) contiguous numpy array."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _words(a, name):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.uint32)  # little-endian: word i -> u32 words 2i, 2i+1
    if a.dtype not in (np.uint32, np.int32) or a.ndim != 1 or a.size == 0:
        raise ValueError(f"{name}: expected a non-empty 1-D uint32 word array, got {a.dtype} {a.shape}")
    return _tensor(a.view(np.int32))


def _table(a, name):
    a = np.ascontiguousarray(a, dtype=np.int32)
    if a.ndim != 2 or a.shape[1] != N_FIELDS or a.shape[0] < 1:
        raise ValueError(f"{name}: expected (Nt+1, {N_FIELDS}) field rows, got {a.shape}")
    return _tensor(a)


def resident_state_from_arrays(docs_words, freqs_words, tiles_docs, tiles_freqs,
                               norm_den, den_blocks=None, tile_gblk0=None,
                               device=None):
    """Build a ResidentState on `device` (None: CUDA) from numpy arrays
    laid out as the JAX engine holds them. den_blocks and tile_gblk0 go
    together; when absent, the engine builds the norm cache on first
    ranked use. Given the same array for docs_words and freqs_words (a
    block index's one stream), the state holds and uploads one tensor."""
    if (den_blocks is None) != (tile_gblk0 is None):
        raise ValueError("den_blocks and tile_gblk0 come together")
    dev = resolve_device(device)
    td = _table(tiles_docs, "tiles_docs")
    tf = _table(tiles_freqs, "tiles_freqs")
    if td.shape != tf.shape:
        raise ValueError(f"tiles_docs {tuple(td.shape)} != tiles_freqs {tuple(tf.shape)}")
    dw = _words(docs_words, "docs_words")
    state = ResidentState(
        docs_words=dw,
        freqs_words=dw if freqs_words is docs_words else _words(freqs_words, "freqs_words"),
        tiles_docs=td,
        tiles_freqs=tf,
        norm_den=_tensor(norm_den, np.float32),
    )
    if den_blocks is not None:
        state.den_blocks = _tensor(den_blocks, np.float32)
        state.tile_gblk0 = _tensor(tile_gblk0, np.int64)
        if state.tile_gblk0.shape[0] != td.shape[0]:
            raise ValueError("tile_gblk0 needs one entry per tile row (pad row included)")
    moved = {}
    for f in fields(state):
        t = getattr(state, f.name)
        if t is not None:
            if id(t) not in moved:
                moved[id(t)] = t.to(dev)
            setattr(state, f.name, moved[id(t)])
    return state
