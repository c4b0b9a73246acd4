// OptPFor full-block decode with the exceptions decoded in the pass, for
// Hopper (sm_90a): K1s, one launch per stream of a part.
//
// Replaces the in-pass Simple16 branch of the jnp device op
// ds2i_tpu/ops/optpfor_device.py:optpfor_decode (b_static, ex_patch=False,
// E > 0; :147-193), the path the JAX engine takes once an index and its
// exception patch pairs pass the resident word limit
// (ds2i_tpu/engine/resident.py:_init_block), together with the assembly
// and pad mask of resident.py:_decode_block_stream ("opt") and, in the
// docs stream, the freq realign (blkperm), the norm-cache den rows and
// the weight, as csrc/optpfor_decode.cu (K1) does for the patch path. One
// launch decodes every ("opt", b, E > 0, 128) group of one stream of a
// part, as its CTA table (common.cuh) lists them:
//   slots      the 128 b-bit fields at (BF_W0, BF_BOFF), b = min(b_static, 32);
//   exceptions K = 2E Simple16 words at (BF_EX_W0, BF_EX_BOFF), each
//              unpacked by its selector's mode; the stream's value q sits at
//              index base + q, base the values of the words before it;
//              indices >= K drop (every word holds at least one value, so
//              each index below K is reached);
//              positions: the int32 prefix sum of (first, gaps + 1) over
//              the first E values; exception e < BF_NEX: the high at
//              index BF_NEX + e (0 where >= K) plus 1, shifted by
//              clip(BF_B, 0, 31); the sum of those at each slot position
//              is ORed into the slot;
//   docs, freqs, pads and weights as K1 (common.cuh:write_prefetched_block_row).
// Every slot equals ds2i_torch/ops/block_decode.py:split_decode_part_torch
// bit for bit; all integer arithmetic is uint32, wrapping as the JAX op's
// int32 does.
//
// What bounds it on this card: a row's chain of dependent steps and the
// instructions between them, not its bytes. At 1x a ranked pass launches
// K1s 14 times, each under one wave; a row reads about 4b bytes of slot
// words, 32 bytes of fields, the Simple16 words its exceptions take and,
// ranked docs, 512 bytes each of freqs and den rows, and writes 512 bytes
// (1,024 with w). The function reads only the stream values [0, n_need):
// with m = min(E, n_ex) valid exceptions (none where n_ex <= 0) the
// positions take the values [0, m) and the highs the values n_ex + e,
// e < m, below K, so n_need = min(K, n_ex + m) for 0 < n_ex < K, m for
// n_ex >= K, 0 for n_ex <= 0 (tests/test_torch_ex_inpass.py:_need, held
// to the plain op on every seeded and index row). The first design staged
// all K + 1 words of every row and had each lane walk every value of a
// run of them: over every tile of the 1x block_optpfor index it staged
// 10.6x the Simple16 words the needed values take (635,150 against 59,945
// of both streams); no row there needs more than 22 words, one round of
// 32. Design, one warp per row, kWarps rows per CTA, every CTA inside one
// group (b and E from the table):
//   1. the row's slot words are staged by cp.async (4-byte copies: the
//      cursors have no alignment) while the exceptions decode;
//   2. the Simple16 words come in rounds of 32, one word a lane straight
//      into a register (the realignment's next word by __shfl_down_sync,
//      lane 31 reading one more); each word's mode comes by shuffle from
//      the lanes holding the 16 modes, and one warp scan of the counts,
//      with a carry across rounds, gives each word's first stream index;
//      the rounds stop, warp-uniform, once the carry reaches n_need;
//   3. value q = 32 t + lane (below n_need) finds its word from two warp
//      reductions (__reduce_or_sync of a bit at each word's first index in
//      [32 t, 32 t + 32), __reduce_add_sync of the words that start
//      before 32 t) and a popcount, no chain of shuffles; the word's
//      payload, mode and first index come by shuffle, then the value's
//      run and offset in the mode: no lane walks a word's values, and
//      nothing is zeroed but the 128 patch sums (a binary search of the
//      round's inclusive counts, 5 dependent shuffles, is kept as
//      docs/k1s_variants/binary_search.patch);
//   4. the positions are a warp scan of the values held in registers, in
//      rounds of 32 with a carry; the highs are read from shared memory
//      (values n_ex + e, stored there as they decode); each valid
//      exception adds high << shift to its slot's sum (atomicAdd, so
//      repeated positions sum as the JAX op sums);
//   5. lane l decodes slots 4l .. 4l + 3 and ORs in their four sums (one
//      16-byte read); the tail's freq and den loads (common.cuh
//      prefetch_row_tail) are issued then, and the row is written by
//      write_prefetched_block_row (one warp scan, 16-byte stores). Issued
//      with the map entry instead (docs/k1s_variants/
//      tail_with_map_entry.patch), those loads are held in registers
//      across the decode.
// The round itself needs no shared memory: its words, modes and counts
// stay in the lanes' registers. Shared memory a warp: the staged slot
// words, the m highs and the 128 sums (12,352 bytes a CTA; ptxas's
// registers and spills, and each variant's times, are in PERF.md §6). No
// TMA (rows are unaligned and under 1 KB), no wgmma (no product).

#include "common.cuh"

namespace {

// block tile field columns (ds2i_torch/engine/block_tiles.py)
constexpr int BF_W0 = 1, BF_B = 2, BF_NEX = 3, BF_EX_W0 = 4, BF_BOFF = 5, BF_EX_BOFF = 6,
              F_BASE = 8, F_NVALS = 9, N_FIELDS = 11;
constexpr int kT = 128;       // slots per full block
constexpr int kSteps = kT / 32;
constexpr int kWarps = 8;     // rows per CTA, one warp each
constexpr int kStage = 130;   // staged slot words: (31 + 128 * 32) / 32 + 2
constexpr int kMaxE = 128;    // exception capacity (block_tiles._E_BUCKETS)
constexpr int kMaxK = 2 * kMaxE;  // Simple16 words a row reads at most
constexpr unsigned kFull = 0xFFFFFFFFu;

// Simple16's modes (codecs/simple16.py:S16_MODES), each at most two runs
// of (count, bits): run r's count at bits 10r, its width at bits 10r + 5
// (tests/test_torch_ex_inpass.py holds this table to S16_MODES)
__constant__ uint32_t kS16Modes[16] = {
    0x3c, 0xb847, 0x11c2e, 0x4e, 0x12064, 0x19048, 0x87, 0x208a4,
    0x29082, 0x288c3, 0x30ca2, 0xe4, 0x50522, 0x48941, 0x1c2, 0x381,
};

__device__ __forceinline__ uint32_t mode_count(uint32_t m) {
  return (m & 31u) + ((m >> 10) & 31u);
}

using ds2i::cp_async_wait_all;
using ds2i::cp_async_word;
using ds2i::load_word;
using ds2i::warp_inclusive_scan;

__global__ void __launch_bounds__(kWarps * 32)
optpfor_s16_part_kernel(const uint32_t* __restrict__ words, long long nw,
                        const int* __restrict__ fld, const long long* __restrict__ gtile,
                        const int* __restrict__ table, int mode, int num_docs,
                        int* __restrict__ out, float* __restrict__ w_out,
                        const int* __restrict__ freq, const long long* __restrict__ blkperm,
                        const float* __restrict__ den_blocks,
                        const long long* __restrict__ tile_gblk0) {
  __shared__ uint32_t s_word[kWarps][kStage];
  __shared__ uint32_t s_high[kWarps][kMaxE];  // value n_ex + e of the stream
  __shared__ __align__(16) uint32_t s_patch[kWarps][kT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* cta = table + static_cast<size_t>(blockIdx.x) * ds2i::kCtaFields;
  if (warp >= cta[ds2i::kCtaNRows]) return;  // warp-uniform; only __syncwarp below
  const int b = cta[ds2i::kCtaP1];
  // E > 0 and in _E_BUCKETS (ops/block_decode.py:_kernel_of checks the
  // statics); the clamp only keeps a bad table inside shared memory
  const int E = min(max(cta[ds2i::kCtaP2], 1), kMaxE);
  const int K = 2 * E;
  const long long row = static_cast<long long>(cta[ds2i::kCtaRow0]) + warp;
  const long long blk0 = static_cast<long long>(cta[ds2i::kCtaBlk0]) + static_cast<long long>(warp) * kSteps;
  const long long tile = gtile[row];
  const int* f = fld + static_cast<size_t>(tile) * N_FIELDS;
  const long long w0 = f[BF_W0];
  const int boff = f[BF_BOFF];
  const int nvals = f[F_NVALS];
  const int base = f[F_BASE];
  const int nex = f[BF_NEX];
  const long long xw0 = f[BF_EX_W0];
  const uint32_t xboff = static_cast<uint32_t>(f[BF_EX_BOFF]);
  const int fb = f[BF_B];
  const uint32_t hshift = static_cast<uint32_t>(fb < 0 ? 0 : (fb > 31 ? 31 : fb));
  const int bs = b < 32 ? b : 32;
  const uint32_t bmask = bs >= 32 ? kFull : (1u << bs) - 1u;
  const uint32_t lane_mode = kS16Modes[lane & 15];

  // step 1: the slot words the row's bits span, staged while the exceptions decode
  const long long last_bit = static_cast<long long>(boff) + static_cast<long long>(kT - 1) * bs;
  const int nstage = bs > 0 && boff >= 0
      ? static_cast<int>(min(static_cast<long long>(kStage), (last_bit >> 5) + 2)) : 0;
  for (int i = lane; i < nstage; i += 32) cp_async_word(&s_word[warp][i], words, nw, w0 + i);
  *reinterpret_cast<uint4*>(&s_patch[warp][4 * lane]) = make_uint4(0u, 0u, 0u, 0u);

  // the values the function reads: [0, need) (see the note above)
  const int m = nex > 0 ? min(E, nex) : 0;
  const int need = nex <= 0 ? 0 : (nex >= K ? m : min(K, nex + m));

  // step 2: rounds of 32 Simple16 words, one a lane, until `need` values
  uint32_t val[kMaxE / 32];  // value 32 t + lane of the stream, the position steps' source
#pragma unroll
  for (int t = 0; t < kMaxE / 32; ++t) val[t] = 0u;
  uint32_t done = 0;  // values of the words of earlier rounds
  for (int r = 0; done < static_cast<uint32_t>(need) && r < K; r += 32) {  // warp-uniform
    const int i = r + lane;
    const uint32_t lo = load_word(words, nw, xw0 + i);
    const uint32_t next = __shfl_down_sync(kFull, lo, 1);
    const uint32_t hi = lane == 31 ? load_word(words, nw, xw0 + r + 32) : next;
    const uint32_t x = xboff > 0 ? (lo >> xboff) | (hi << (32u - xboff)) : lo;
    const uint32_t md = __shfl_sync(kFull, lane_mode, static_cast<int>(x >> 28));
    const uint32_t cnt = i < K ? mode_count(md) : 0u;  // words past K hold no value
    const uint32_t incl = warp_inclusive_scan(cnt, lane) + done;  // values through word i
    const uint32_t total = __shfl_sync(kFull, incl, 31);
    const uint32_t end = min(total, static_cast<uint32_t>(need));
    // step 3: value q = 32 t + lane of [done, end), its word by two reductions
#pragma unroll
    for (int t = 0; t < kMaxK / 32; ++t) {
      if (32u * t + 32u <= done || 32u * t >= end) continue;  // warp-uniform
      // q's word: the round's words that start in [32 t, q], after those
      // that start before 32 t (every word below K holds a value)
      const uint32_t q = 32u * t + lane;
      const uint32_t first_i = incl - cnt, lo_t = 32u * t;
      const uint32_t starts = __reduce_or_sync(
          kFull, cnt > 0 && first_i >= lo_t && first_i < lo_t + 32u ? 1u << (first_i - lo_t) : 0u);
      const uint32_t before = __reduce_add_sync(kFull, cnt > 0 && first_i < lo_t ? 1u : 0u);
      const int j = static_cast<int>(before + __popc(starts & ((2u << lane) - 1u))) - 1;
      const uint32_t xq = __shfl_sync(kFull, x, j);
      const uint32_t mq = __shfl_sync(kFull, md, j);
      const uint32_t first = __shfl_sync(kFull, first_i, j);
      if (q >= done && q < end) {
        const uint32_t o = q - first;
        const uint32_t c0 = mq & 31u, wa = (mq >> 5) & 31u, wb = (mq >> 15) & 31u;
        const uint32_t sh = o < c0 ? o * wa : c0 * wa + (o - c0) * wb;
        const uint32_t width = o < c0 ? wa : wb;  // widths are 1..28
        const uint32_t value = ((xq & 0x0FFFFFFFu) >> sh) & ((1u << width) - 1u);
        if (t < kMaxE / 32) val[t] = value;
        if (q >= static_cast<uint32_t>(nex)) s_high[warp][q - nex] = value;
      }
    }
    done = total;
  }
  cp_async_wait_all();
  __syncwarp();

  // step 4: positions by warp scans of the values in registers; highs
  uint32_t carry = 0;
#pragma unroll
  for (int t = 0; t < kMaxE / 32; ++t) {
    if (32 * t >= m) break;  // warp-uniform
    const int e = 32 * t + lane;
    const uint32_t step = e < m ? (e == 0 ? val[t] : val[t] + 1u) : 0u;
    const uint32_t pos = warp_inclusive_scan(step, lane) + carry;
    carry = __shfl_sync(kFull, pos, 31);
    const int p = static_cast<int>(pos);
    if (e < m && p >= 0 && p < kT) {
      const uint32_t high = (e < K - nex ? s_high[warp][e] : 0u) + 1u;
      atomicAdd(&s_patch[warp][p], high << hshift);
    }
  }
  __syncwarp();

  // step 5: slots 4 lane .. 4 lane + 3, their sums ORed in, and the tail
  const uint4 pq = *reinterpret_cast<const uint4*>(&s_patch[warp][4 * lane]);
  const uint32_t patch[kSteps] = {pq.x, pq.y, pq.z, pq.w};
  uint32_t v[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int j = 4 * lane + k;
    uint32_t x = 0;
    if (bs > 0) {
      // the slot's bits start at bit boff + j*bs of word w0
      const long long bit = static_cast<long long>(boff) + static_cast<long long>(j) * bs;
      const long long kw = bit >> 5;
      const uint32_t sh = static_cast<uint32_t>(bit & 31);
      const uint32_t lo = kw >= 0 && kw < nstage ? s_word[warp][kw] : load_word(words, nw, w0 + kw);
      const uint32_t hi = kw + 1 >= 0 && kw + 1 < nstage ? s_word[warp][kw + 1]
                                                         : load_word(words, nw, w0 + kw + 1);
      x = ((lo >> sh) | (sh > 0 ? hi << (32u - sh) : 0u)) & bmask;
    }
    v[k] = x | patch[k];
  }
  // the tail's freq and den loads issued here, not with the map entry: held
  // across the decode they cost registers and a launch's throughput
  const ds2i::RowTail tail = ds2i::prefetch_row_tail(mode, lane, blk0, tile, freq, blkperm,
                                                     den_blocks, tile_gblk0);
  ds2i::write_prefetched_block_row(v, lane, mode, num_docs, nvals, base, blk0, out, w_out, tail);
}

}  // namespace

// Decode every ("opt", b, E > 0, 128) group of one stream of a part: n_cta
// CTA-table entries (common.cuh), each of at most 8 rows. The arguments
// are K1's (csrc/optpfor_decode.cu:ds2i_optpfor_decode_part): fld is the
// stream's resident field table, gtile the part's row-to-tile map
// (int64), mode (common.cuh Mode) picks what is written; max_w and max_t
// must be 0 and 128; out, w, freq and den_blocks lie on 16-byte
// boundaries (the tail's vectors). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int ds2i_optpfor_s16_decode_part(
    const void* words, long long nw, const void* fld, const void* gtile, const void* table,
    int n_cta, int max_w, int max_t, int mode, int num_docs, void* out, void* w,
    const void* freq, const void* blkperm, const void* den_blocks, const void* tile_gblk0,
    void* stream) {
  if (n_cta < 0 || max_w != 0 || max_t != kT || mode < ds2i::kFreqs || mode > ds2i::kDocsBm25 ||
      out == nullptr || (mode >= ds2i::kDocsPresence && w == nullptr) ||
      (mode == ds2i::kDocsBm25 && (freq == nullptr || blkperm == nullptr ||
                                   den_blocks == nullptr || tile_gblk0 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ds2i::misaligned16(out) || ds2i::misaligned16(w) || ds2i::misaligned16(freq) ||
      ds2i::misaligned16(den_blocks)) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // the 16-byte vectors of the tail
  }
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  optpfor_s16_part_kernel<<<n_cta, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld),
      static_cast<const long long*>(gtile), static_cast<const int*>(table), mode, num_docs,
      static_cast<int*>(out), static_cast<float*>(w), static_cast<const int*>(freq),
      static_cast<const long long*>(blkperm), static_cast<const float*>(den_blocks),
      static_cast<const long long*>(tile_gblk0));
  return static_cast<int>(cudaGetLastError());
}
