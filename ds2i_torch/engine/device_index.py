"""DeviceIndex: the compressed index resident on the device, with a
batched list decode. The port of ds2i_tpu/engine/device_index.py.

Uploads the index's raw bit words (the uint64 words viewed as uint32, as
int32 tensors holding their bits) to the device once, parses every
list's header and partition directory into flat segment tables on the
host (numpy, once), and decodes any batch of posting lists with one
launch of the segment decode (ops.decode.decode_rows, K9 on the card).

The words on the device are the frozen index's bits as they are, so the
bits per posting on the device equal the index file's.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops.decode import check_bit_offsets, decode_segments_device
from ..ops.segments import SegmentTable, sequence_segments

_I32 = np.int32
_PACKAGE = __name__.split(".")[0]


def _pow_at_least(x, lo=1, base=2):
    """The least lo * base**i that is >= x."""
    v = lo
    while v < int(x):
        v *= base
    return v


def check_own_index(index, who):
    """Raise TypeError unless `index` was built by this package (each
    engine serves an index built by its own package; index/mapper.py
    carries index files across)."""
    if type(index).__module__.split(".")[0] != _PACKAGE:
        raise TypeError(f"{who} serves indexes built by {_PACKAGE}; got a "
                        f"{type(index).__module__}.{type(index).__qualname__}")


def words_tensor(bv, device):
    """The bit vector's uint64 words as int32 words (their uint32 bits) on
    `device`."""
    return torch.from_numpy(np.ascontiguousarray(bv.words).view(np.int32).copy()).to(device)


class DeviceIndex:
    def __init__(self, index, device=None):
        """device: where the words live (None: the CUDA card; "cpu": the
        plain PyTorch path)."""
        check_own_index(index, "DeviceIndex")
        self.index = index
        self.device = resolve_device(device)
        self.num_docs = index.num_docs()
        self.num_lists = index.size()
        assert self.num_docs < 2**31

        self.docs_words = words_tensor(index.docs_sequences.bits_bv, self.device)
        self.freqs_words = words_tensor(index.freqs_sequences.bits_bv, self.device)

        self._build_segment_tables()

    def _build_segment_tables(self):
        index = self.index
        params = index.params
        docs_bv = index.docs_sequences.bits()
        freqs_bv = index.freqs_sequences.bits()
        freq_offsets = index.freqs_sequences.endpoints()

        dt = SegmentTable()
        ft = SegmentTable()
        self.list_n = np.zeros(self.num_lists, dtype=np.int64)
        d_ranges = np.zeros((self.num_lists, 2), dtype=np.int64)
        f_ranges = np.zeros((self.num_lists, 2), dtype=np.int64)

        for i in range(self.num_lists):
            occurrences, n, docs_offset = index._header(i)
            self.list_n[i] = n
            d0 = len(dt)
            sequence_segments(
                index.docs_sequence_type, docs_bv, docs_offset, self.num_docs, n, params, dt, list_id=i
            )
            d_ranges[i] = (d0, len(dt))
            f0 = len(ft)
            sequence_segments(
                index.freqs_sequence_type,
                freqs_bv,
                int(freq_offsets[i]),
                occurrences + 1,
                n,
                params,
                ft,
                list_id=i,
            )
            f_ranges[i] = (f0, len(ft))

        self.docs_segs = dt.arrays()
        self.freqs_segs = ft.arrays()
        self.d_ranges = d_ranges
        self.f_ranges = f_ranges

    # -- batched decode ------------------------------------------------------

    def _gather_segments(self, segs, ranges, term_ids):
        """Select the segment rows of the requested lists; returns SoA dict +
        per-batch-slot row assignment. Negative term ids yield no segments."""
        tid = np.where(term_ids >= 0, term_ids, 0)
        starts = ranges[tid, 0]
        ends = np.where(term_ids >= 0, ranges[tid, 1], starts)
        counts = ends - starts
        total = int(counts.sum())
        # index expansion: rows of each list, in batch order (vectorized)
        row_of_seg = np.repeat(np.arange(len(term_ids), dtype=np.int64), counts)
        if total:
            excl = np.cumsum(counts) - counts
            seg_idx = np.repeat(starts - excl, counts) + np.arange(total, dtype=np.int64)
        else:
            seg_idx = np.zeros(0, dtype=np.int64)
        out = {k: v[seg_idx] for k, v in segs.items()}
        out["list_row"] = row_of_seg
        return out

    def decode_lists(self, term_ids, words, segs, ranges, L_out, sentinel):
        """Decode `term_ids` (any iterable of list ids) into an
        (len(term_ids), L_out) int32 tensor on the index's device. Raises
        ValueError where a list's bits lie past bit 2^31 of its stream
        (ops.decode.check_bit_offsets)."""
        term_ids = np.asarray(term_ids, dtype=np.int64)
        g = self._gather_segments(segs, ranges, term_ids)
        R = len(g["kind"])
        if R == 0:
            return torch.full((len(term_ids), L_out), sentinel, dtype=torch.int32,
                              device=self.device)
        check_bit_offsets(g["sel_start"], g["sel_len"], g["lb_start"], g["lower_bits"],
                          g["n_vals"])

        Lseg = _pow_at_least(int(g["n_vals"].max()) if R else 1, lo=32)
        align_slack = g["sel_start"] & 31
        W = _pow_at_least(int(np.ceil((int((g["sel_len"] + align_slack).max()) + 31) / 32)), lo=4)
        Rpad = _pow_at_least(R, lo=8)

        def pad(a, fill=0):
            out = np.full(Rpad, fill, dtype=_I32)
            out[:R] = a
            return torch.from_numpy(out).to(self.device)

        list_n = np.zeros(len(term_ids), dtype=_I32)
        list_n[:] = self.list_n[term_ids]

        out = decode_segments_device(
            words,
            pad(g["kind"], fill=-1),
            pad(g["sel_start"]),
            pad(g["sel_len"], fill=0),
            pad(g["lb_start"]),
            pad(g["lower_bits"]),
            pad(g["n_vals"], fill=0),
            pad(g["base"]),
            pad(g["out_begin"]),
            pad(g["list_row"], fill=len(term_ids)),  # padding rows scatter off-grid
            torch.from_numpy(np.concatenate([list_n, np.zeros(1, dtype=_I32)])).to(self.device),
            W=W,
            Lseg=Lseg,
            rows=len(term_ids) + 1,
            L_out=L_out,
            sentinel=sentinel,
        )
        return out[: len(term_ids)]

    def decode_docs(self, term_ids, L_out):
        return self.decode_lists(
            term_ids, self.docs_words, self.docs_segs, self.d_ranges, L_out, sentinel=self.num_docs
        )

    def decode_freq_cums(self, term_ids, L_out):
        """Prefix-sum domain values (positive_sequence base); diff to get freqs."""
        return self.decode_lists(
            term_ids, self.freqs_words, self.freqs_segs, self.f_ranges, L_out, sentinel=0
        )

    def max_list_len(self, term_ids):
        return int(self.list_n[np.asarray(term_ids, dtype=np.int64)].max())
