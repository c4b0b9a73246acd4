"""The port's copy of ds2i_tpu/engine/block_tiles.py (numpy only), over
the port's own codecs, index and native library.

The port imports nothing of the JAX package, so this copy is permanent.
tests/test_torch_block_tiles.py pins it to the original: tables,
statics, gids and patch words, native and Python walk alike. One
difference: the original also reads DS2I_NATIVE=0 here; in the port that
switch lives in the native loader (ds2i_torch.native), which then loads
nothing, so the Python walk runs where the library is unavailable.

Host-side tile tables for block-codec indexes (block_freq_index).

A tile is one 128-integer block (block_posting_list.hpp:13-53): docs
codec bytes then freqs codec bytes, d-gapped docs with a per-block base
(the previous block's max + 1), freqs stored minus one. Full blocks use
the index's codec; partial tail blocks are always interpolative
(block_codecs.hpp:196-199).

Per block and per stream this records the codec kind plus the O(1)
decode constants the device kernels need (bit positions into the
u32-viewed byte stream, bit width, exception count/offset, known sum).
Finding the docs/freqs split inside a block requires walking the docs
codec's length: O(1) for OptPFor (slot words + a Simple16 word walk),
a host-side decode for interpolative tails (bounded by one partial
block per list).

Field column reuse (same (Nt, N_FIELDS) table shape as the EF tiles so
the resident engine shares its gather machinery). Cursors are stored as
(word index, bit-in-word) pairs — i32 word indexing addresses streams up
to 8GB, lifting the old 2^31-bit (256MB) per-stream limit:
  F_KIND      KIND_OPT / KIND_INTERP / KIND_VAR / KIND_QMX
  BF_W0   (1) stream cursor word (OPT: slot section; INTERP/QMX: after
              any vbyte; VAR: first group)
  BF_B    (2) OPT: bit width b; VAR: group count; QMX: instance count
  BF_NEX  (3) OPT: n_exceptions; QMX: selector count
  BF_EX_W0(4) OPT: exception-stream word; QMX: last-selector word;
              INTERP: sum_of_values
  BF_BOFF (5) cursor bit-in-word (0..31)
  BF_EX_BOFF(6) OPT: exception bit-in-word; QMX: last-selector
              byte-in-word (0..3)
  F_BASE      docs: block base (prev max + 1); freqs: 0
  F_NVALS     values in the block
"""

import numpy as np

from ..codecs.interpolative import UNKNOWN_SUM, InterpolativeBlock
from ..codecs.mixed import INTERPOLATIVE, MixedBlock, PFOR, VARINT
from ..codecs.optpfor import OptPForBlock
from ..codecs.qmx import ADV_OF_TYPE, QMXBlock
from ..codecs.simple16 import S16_MODES
from ..codecs.varint import VarintG8IUBlock
from ..codecs.vbyte import TightVariableByte
from ..index.block_index import BlockPostingList
from .tiles import F_BASE, F_KIND, F_NVALS, N_FIELDS, TILE, TileTables

KIND_OPT = 8
KIND_INTERP = 9
KIND_VAR = 10
KIND_QMX = 11

BF_W0 = 1
BF_B = 2
BF_NEX = 3
BF_EX_W0 = 4  # OPT: exception word; QMX: last-selector word; INTERP: sum
BF_BOFF = 5
BF_EX_BOFF = 6
# OPT only, filled IN MEMORY at engine init when exception patch tables
# are active (never persisted — the cached tables stay canonical):
# absolute word index of the row's first resident (position, high<<b)
# patch pair (build_exception_patches). Column 7 is unused by the
# canonical block walk (it is F_LB_BITOFF in the EF tile layout).
BF_EX_BASE = 7

_MODE_COUNT = [sum(c for c, _ in mode) for mode in S16_MODES]

# bucket tables for group statics
_E_BUCKETS = (0, 4, 8, 16, 32, 64, 128)
_NC_BUCKETS = (8, 16, 32, 64, 128)
_WIN_BUCKETS = (4, 16, 64, 180)
_G_BUCKETS = (24, 40, 64)
_NW_BUCKETS = (8, 16, 32)  # QMX instances per block (max 32)
_S_BUCKETS = (8, 16, 32)   # QMX selectors per block (max 32)


def _bucket(v, table):
    for t in table:
        if v <= t:
            return t
    return table[-1]


def _s16_words(data, pos, nvals):
    """Words consumed by a Simple16 stream of nvals values at byte pos."""
    got = w = 0
    while got < nvals:
        word = int(data[pos + 4 * w]) | (int(data[pos + 4 * w + 1]) << 8) | (
            int(data[pos + 4 * w + 2]) << 16) | (int(data[pos + 4 * w + 3]) << 24)
        got += _MODE_COUNT[word >> 28]
        w += 1
    return w


def _opt_stream(data, pos, cur, row):
    """Fill OPT fields for one stream at byte pos; returns end byte."""
    b = int(data[pos])
    nex = int(data[pos + 1])
    sw = (cur * min(b, 32) + 31) // 32
    ex_pos = pos + 2 + 4 * sw
    ew = _s16_words(data, ex_pos, 2 * nex) if nex else 0
    row[F_KIND] = KIND_OPT
    row[BF_W0] = (pos + 2) >> 2
    row[BF_BOFF] = ((pos + 2) & 3) * 8
    row[BF_B] = b
    row[BF_NEX] = nex
    row[BF_EX_W0] = ex_pos >> 2
    row[BF_EX_BOFF] = (ex_pos & 3) * 8
    row[F_NVALS] = cur
    return ex_pos + 4 * ew, b, nex


def _interp_stream(data, pos, cur, known_sum, row):
    """Fill INTERP fields; returns (end byte, window bits)."""
    if known_sum == UNKNOWN_SUM:
        vals, q = TightVariableByte.decode(data, pos, 1)
        s = int(vals[0])
    else:
        s, q = int(known_sum), pos
    _, end = InterpolativeBlock.decode(data, pos, known_sum, cur)
    row[F_KIND] = KIND_INTERP
    row[BF_W0] = q >> 2
    row[BF_BOFF] = (q & 3) * 8
    row[BF_EX_W0] = s
    row[F_NVALS] = cur
    return end, (end - q) * 8


def _var_stream(data, pos, cur, row):
    """Fill VARINT fields; returns end byte."""
    got = g = 0
    while got < cur:
        got += bin(int(data[pos + 9 * g])).count("1")
        g += 1
    row[F_KIND] = KIND_VAR
    row[BF_W0] = pos >> 2
    row[BF_BOFF] = (pos & 3) * 8
    row[BF_B] = g  # group count
    row[F_NVALS] = cur
    return pos + 9 * g, g


def _qmx_stream(data, pos, cur, row):
    """Fill QMX fields (reference format: vbyte(enc_len), payload,
    selectors reversed at the end); returns (end byte, ninst, nsel).
    Replays the decoder's selector walk (qmx_codec.hpp: while in<=keys)."""
    vals, q = TightVariableByte.decode(data, pos, 1)
    elen = int(vals[0])
    in_off, keys_off = q, q + elen - 1
    ns = ninst = 0
    while in_off <= keys_off:
        sel = int(data[keys_off])
        keys_off -= 1
        ns += 1
        batch = 16 - (sel & 0x0F)
        ninst += batch
        in_off += batch * ADV_OF_TYPE[sel >> 4]
    row[F_KIND] = KIND_QMX
    row[BF_W0] = q >> 2
    row[BF_BOFF] = (q & 3) * 8
    row[BF_B] = ninst
    row[BF_NEX] = ns
    row[BF_EX_W0] = (q + elen - 1) >> 2  # LAST selector byte (first in walk)
    row[BF_EX_BOFF] = (q + elen - 1) & 3
    row[F_NVALS] = cur
    return q + elen, ninst, ns


def _full_stream(data, pos, cur, known_sum, codec, row):
    """One full-block stream of any supported codec; returns
    (end byte, stream static tuple)."""
    if codec is MixedBlock:
        t = int(data[pos])
        pos += 1
        codec = {PFOR: OptPForBlock, VARINT: VarintG8IUBlock,
                 INTERPOLATIVE: InterpolativeBlock}[t]
    if codec is OptPForBlock:
        end, b, nex = _opt_stream(data, pos, cur, row)
        # exact b in the statics: the kernel's static-width path needs it,
        # and the POSS_LOGS grid bounds the group-class count
        return end, ("opt", b, _bucket(nex, _E_BUCKETS))
    if codec is VarintG8IUBlock:
        end, g = _var_stream(data, pos, cur, row)
        return end, ("var", _bucket(g, _G_BUCKETS))
    if codec is QMXBlock:
        end, nw, ns = _qmx_stream(data, pos, cur, row)
        return end, ("qmx", _bucket(nw, _NW_BUCKETS), _bucket(ns, _S_BUCKETS))
    end, bits = _interp_stream(data, pos, cur, known_sum, row)
    return end, ("interp", _bucket((31 + bits) // 32 + 1, _WIN_BUCKETS))


_NATIVE_CODEC_IDS = {
    OptPForBlock: 0, VarintG8IUBlock: 1, InterpolativeBlock: 2,
    QMXBlock: 3, MixedBlock: 4,
}


def _unpack_keys(keys):
    """Packed i64 statics keys -> (statics list, gid array). Key layout:
    kind<<40 | p1<<30 | p2<<20 | T (ds2i_native.cpp ds2i_block_tables)."""
    uniq, gid = np.unique(keys, return_inverse=True)
    statics = []
    for k in uniq:
        k = int(k)
        kind, p1, p2, T = k >> 40, (k >> 30) & 1023, (k >> 20) & 1023, k & 1023
        if kind == KIND_OPT:
            statics.append(("opt", p1, p2, T))
        elif kind == KIND_VAR:
            statics.append(("var", p1, T))
        elif kind == KIND_QMX:
            statics.append(("qmx", p1, p2, T))
        else:
            statics.append(("interp", p1, T))
    return statics, gid.astype(np.int64)


_S16_MODE_COUNT_ARR = np.asarray(_MODE_COUNT, dtype=np.int64)
# rectangular (16, 28) shift/width tables for vectorized decode
_S16_SH28 = np.zeros((16, 28), dtype=np.uint64)
_S16_WD28 = np.zeros((16, 28), dtype=np.uint64)
for _m, _mode in enumerate(S16_MODES):
    _ws = [b for c, b in _mode for _ in range(c)]
    _S16_WD28[_m, : len(_ws)] = _ws
    _S16_SH28[_m, : len(_ws)] = np.concatenate([[0], np.cumsum(_ws)[:-1]])


def _decode_s16_exception_rows(words, w0, boff, nex, b, out_pos, out_add, base):
    """Vectorized host decode of one chunk of OptPFor exception streams
    (same math as ops/optpfor_device.py's in-pass path): rows r have
    Simple16 streams of 2*nex[r] values at word w0[r], bit boff[r];
    writes nex[r] (slot position, high<<b) pairs per row into
    out_pos/out_add at entry offsets base[r]."""
    R = len(w0)
    if not R:
        return
    Em = int(nex.max())
    K = 2 * Em
    nw = len(words)
    widx = np.minimum(w0[:, None].astype(np.int64) + np.arange(K + 1, dtype=np.int64), nw - 1)
    wv = words[widx].astype(np.uint64)  # (R, K+1)
    s = boff[:, None].astype(np.uint64)
    xw = ((wv[:, :K] >> s) | np.where(s > 0, wv[:, 1:] << (np.uint64(32) - s), 0)) & np.uint64(
        0xFFFFFFFF
    )
    sel = (xw >> np.uint64(28)).astype(np.int64)
    payload = xw & np.uint64(0x0FFFFFFF)
    cnt = _S16_MODE_COUNT_ARR[sel]  # (R, K)
    sh = _S16_SH28[sel]  # (R, K, 28) u64
    wd = _S16_WD28[sel]
    val28 = (payload[:, :, None] >> sh) & ((np.uint64(1) << wd) - np.uint64(1))
    base_k = np.cumsum(cnt, axis=1) - cnt  # exclusive
    slot28 = np.arange(28, dtype=np.int64)[None, None, :]
    sidx = base_k[:, :, None] + slot28
    ok = (slot28 < cnt[:, :, None]) & (sidx < K)
    elem = np.zeros((R, K), dtype=np.uint64)
    rr = np.broadcast_to(np.arange(R, dtype=np.int64)[:, None, None], sidx.shape)
    elem[rr[ok], sidx[ok]] = val28[ok]
    # positions: first absolute, then gaps-1
    steps = np.concatenate([elem[:, :1], elem[:, 1:Em] + 1], axis=1).astype(np.int64)
    pos = np.cumsum(steps, axis=1)  # (R, Em)
    eidx = np.minimum(nex[:, None].astype(np.int64) + np.arange(Em, dtype=np.int64), K - 1)
    high = np.take_along_axis(elem, eidx, axis=1) + 1
    add = (high << b[:, None].astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    evalid = np.arange(Em, dtype=np.int64)[None, :] < nex[:, None]
    dest = base[:, None] + np.arange(Em, dtype=np.int64)
    out_pos[dest[evalid]] = pos[evalid].astype(np.uint32)
    out_add[dest[evalid]] = add[evalid].astype(np.uint32)


def build_exception_patches(words, fields_list):
    """Decode every OptPFor exception stream ONCE into flat resident
    patch words (docs/PERF.md 'identified round-5 decode fix'): for each
    OPT row of each stream table, nex (slot position, high<<b) u32 pairs
    in canonical table order, docs table first. Returns
    (patch_words u32[2*NE], bases list of i64[rows-per-table] entry
    indices, -1 for non-OPT/zero-exception rows).

    These are STATIC derived data — the analogue of the reference
    decoder doing this work inside every query's cursor walk
    (block_codecs.hpp:203-216); here it runs once per index and the
    result lives in HBM (~8 bytes/exception)."""
    sels = []
    total = 0
    bases = []
    for f in fields_list:
        is_opt = (f[:, F_KIND] == KIND_OPT) & (f[:, BF_NEX] > 0)
        rows = np.nonzero(is_opt)[0]
        nex = f[rows, BF_NEX].astype(np.int64)
        base = np.full(len(f), -1, dtype=np.int64)
        base[rows] = total + np.cumsum(nex) - nex
        bases.append(base)
        sels.append((f, rows, nex, base))
        total += int(nex.sum())
    if total:
        # native twin (byte-identical, tested): one thread-parallel C++
        # pass over every exception stream — ~25x the numpy builder at
        # 50x (128 s -> ~5 s cold engine-init difference)
        from ..native import s16_exception_patches_native

        w0_a = np.concatenate([f[rows, BF_EX_W0] for f, rows, _, _ in sels])
        bo_a = np.concatenate([f[rows, BF_EX_BOFF] for f, rows, _, _ in sels])
        nx_a = np.concatenate([f[rows, BF_NEX] for f, rows, _, _ in sels])
        b_a = np.concatenate([f[rows, BF_B] for f, rows, _, _ in sels])
        bs_a = np.concatenate([base[rows] for f, rows, _, base in sels])
        nat = s16_exception_patches_native(words, w0_a, bo_a, nx_a, b_a, bs_a, total)
        if nat is not None:
            return nat, bases
    out_pos = np.zeros(total, dtype=np.uint32)
    out_add = np.zeros(total, dtype=np.uint32)
    for f, rows, nex, base in sels:
        if not len(rows):
            continue
        # chunk rows sorted by exception count so each chunk's dense
        # (R, 2*Em, 28) temporary stays in budget
        srt = np.argsort(nex, kind="stable")
        order, onex = rows[srt], nex[srt]
        # budget counts ONE (R, 2*Em, 28) u64 plane; the decode holds
        # ~6 such temporaries at peak, so this bounds peak memory ~512MB
        budget = 1 << 23
        i = 0
        while i < len(order):
            hi = i + 1
            Em = int(onex[i])
            while hi < len(order):
                Em2 = max(Em, int(onex[hi]))
                if (hi + 1 - i) * 2 * Em2 * 28 > budget:
                    break
                Em, hi = Em2, hi + 1
            ch = order[i:hi]
            _decode_s16_exception_rows(
                words,
                f[ch, BF_EX_W0].astype(np.int64),
                f[ch, BF_EX_BOFF].astype(np.int64),
                f[ch, BF_NEX].astype(np.int64),
                f[ch, BF_B].astype(np.int64),
                out_pos, out_add, base[ch],
            )
            i = hi
    patch = np.empty(2 * total, dtype=np.uint32)
    patch[0::2] = out_pos
    patch[1::2] = out_add
    return patch, bases


def _build_native(index, data, size, codec):
    """Thread-parallel C++ tile-table walk; None -> pure-Python fallback.
    Identical tables/statics to the Python walk (tests/test_engine.py)."""
    if size == 0:
        return None
    from ..native import block_tables_native

    res = block_tables_native(data, index.endpoints(), _NATIVE_CODEC_IDS[codec])
    if res is None:
        return None
    docs_fields, freqs_fields, tile_list, lts, dkey, fkey = res
    slist_d, gid_d = _unpack_keys(dkey)
    slist_f, gid_f = _unpack_keys(fkey)
    tables = TileTables(
        docs=docs_fields,
        freqs=freqs_fields,
        tile_list=tile_list,
        list_tile_start=lts,
        win_words=np.zeros(len(tile_list), dtype=np.int32),
        lb_words=np.zeros(len(tile_list), dtype=np.int32),
    )
    return tables, slist_d, gid_d, slist_f, gid_f


def build_block_tables(index):
    """TileTables for a block_freq_index plus PER-STREAM group statics.

    Docs and freqs codecs vary independently per block (mixed indexes in
    particular), so each stream gets its own decode grouping — crossing
    them would fragment the batch into the product of the class sets.
    Returns (tables, statics_d, gid_d, statics_f, gid_f); each statics
    tuple ends with the tile width T."""
    codec = index.codec
    if codec not in (OptPForBlock, InterpolativeBlock, VarintG8IUBlock, MixedBlock, QMXBlock):
        raise TypeError(
            f"device block engine has no decode kernels for {codec.__name__}"
        )
    data = np.asarray(index.lists, dtype=np.uint8)
    size = index.size()

    native = _build_native(index, data, size, codec)
    if native is not None:
        return native

    d_rows, f_rows, tile_list = [], [], []
    sidx_d, slist_d, gid_d = {}, [], []
    sidx_f, slist_f, gid_f = {}, [], []

    def intern(st, sidx, slist, gids):
        g = sidx.get(st)
        if g is None:
            g = len(slist)
            sidx[st] = g
            slist.append(st)
        gids.append(g)

    list_tile_start = [0]

    for i in range(size):
        n, blocks, maxs, bends, pos = BlockPostingList.parse(data, index.get_offset(i), codec)
        block_base = 0
        p = int(pos)
        for bi in range(blocks):
            lo = bi * TILE
            cur = min(TILE, n - lo)
            last = int(maxs[bi])
            drow = np.zeros(N_FIELDS, dtype=np.int64)
            frow = np.zeros(N_FIELDS, dtype=np.int64)

            sum_d = last - block_base - (cur - 1)
            if cur == TILE:
                p2, dst = _full_stream(data, p, cur, sum_d, codec, drow)
                p3, fst = _full_stream(data, p2, cur, UNKNOWN_SUM, codec, frow)
                T = TILE
            else:
                p2, bits_d = _interp_stream(data, p, cur, sum_d, drow)
                p3, bits_f = _interp_stream(data, p2, cur, UNKNOWN_SUM, frow)
                dst = ("interp", _bucket((31 + bits_d) // 32 + 1, _WIN_BUCKETS))
                fst = ("interp", _bucket((31 + bits_f) // 32 + 1, _WIN_BUCKETS))
                T = _bucket(cur, _NC_BUCKETS)
            drow[F_BASE] = block_base
            intern(dst + (T,), sidx_d, slist_d, gid_d)
            intern(fst + (T,), sidx_f, slist_f, gid_f)
            d_rows.append(drow)
            f_rows.append(frow)
            tile_list.append(i)
            p = p3
            block_base = last + 1
        list_tile_start.append(len(tile_list))

    tables = TileTables(
        docs=np.array(d_rows, dtype=np.int64).reshape(-1, N_FIELDS).astype(np.int32),
        freqs=np.array(f_rows, dtype=np.int64).reshape(-1, N_FIELDS).astype(np.int32),
        tile_list=np.array(tile_list, dtype=np.int64),
        list_tile_start=np.array(list_tile_start, dtype=np.int64),
        win_words=np.zeros(len(tile_list), dtype=np.int32),
        lb_words=np.zeros(len(tile_list), dtype=np.int32),
    )
    return (
        tables,
        slist_d, np.array(gid_d, dtype=np.int64),
        slist_f, np.array(gid_f, dtype=np.int64),
    )
