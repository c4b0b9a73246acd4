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
//              indices >= K drop, indices no word reaches read 0;
//              positions: the int32 prefix sum of (first, gaps + 1) over
//              the first E values; exception e < BF_NEX: the high at
//              index BF_NEX + e (0 where >= K) plus 1, shifted by
//              clip(BF_B, 0, 31); the sum of those at each slot position
//              is ORed into the slot;
//   docs, freqs, pads and weights as K1 (common.cuh:write_full_block_row).
// Every slot equals ds2i_torch/ops/block_decode.py:split_decode_part_torch
// bit for bit; all integer arithmetic is uint32, wrapping as the JAX op's
// int32 does.
//
// What bounds it on this card: memory, the launch, and a row's chain.
// A row reads about 4b + 4(2E + 1) bytes of stream and 36 bytes of fields
// (and, ranked docs, 512 bytes each of freqs and den rows) and writes 512
// bytes (1,024 with w); its work is a short chain of dependent steps.
// Design: one warp per row, kWarps rows per CTA, every CTA inside one group
// (b and E come from the table). The warp stages the row's slot words and
// its K + 1 exception words in shared memory with cp.async (4-byte copies:
// the cursors have no alignment) and decodes the slots as K1 does. Lane l
// then takes a run of c = ceil(K / 32) consecutive exception words: it
// realigns each by BF_EX_BOFF, reads its selector's mode (the 16 modes
// held one a lane and read by shuffle, so no lane waits on a table), and a
// warp scan of the runs' value counts gives each word its first stream
// index; the lane writes its words' values below K into a shared array.
// A second warp scan, over runs of ceil(E / 32) values, gives the
// positions; each valid exception adds high << shift to its slot's word of
// shared memory (atomicAdd, so repeated positions sum as the JAX op sums),
// and the sums are ORed into the slots. The docs prefix sum and the writes
// are K1's. No TMA (rows are unaligned and under 1 KB), no wgmma.

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
constexpr int kMaxK = 2 * kMaxE;  // Simple16 words read a row
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
  __shared__ uint32_t s_ex[kWarps][kMaxK + 1];
  __shared__ uint32_t s_elem[kWarps][kMaxK];
  __shared__ uint32_t s_patch[kWarps][kT];
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
  const int nex = f[BF_NEX];
  const long long xw0 = f[BF_EX_W0];
  const uint32_t xboff = static_cast<uint32_t>(f[BF_EX_BOFF]);
  const int fb = f[BF_B];
  const uint32_t hshift = static_cast<uint32_t>(fb < 0 ? 0 : (fb > 31 ? 31 : fb));
  const int bs = b < 32 ? b : 32;
  const uint32_t bmask = bs >= 32 ? kFull : (1u << bs) - 1u;
  const uint32_t lane_mode = kS16Modes[lane & 15];

  // stage the slot words the row's bits span and its K + 1 exception words
  const long long last_bit = static_cast<long long>(boff) + static_cast<long long>(kT - 1) * bs;
  const int nstage = bs > 0 && boff >= 0
      ? static_cast<int>(min(static_cast<long long>(kStage), (last_bit >> 5) + 2)) : 0;
  for (int i = lane; i < nstage; i += 32) cp_async_word(&s_word[warp][i], words, nw, w0 + i);
  for (int i = lane; i <= K; i += 32) cp_async_word(&s_ex[warp][i], words, nw, xw0 + i);
  for (int i = lane; i < K; i += 32) s_elem[warp][i] = 0u;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) s_patch[warp][it * 32 + lane] = 0u;
  cp_async_wait_all();
  __syncwarp();

  uint32_t v[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int j = it * 32 + lane;
    uint32_t x = 0;
    if (bs > 0) {
      // the slot's bits start at bit boff + j*bs of word w0
      const long long bit = static_cast<long long>(boff) + static_cast<long long>(j) * bs;
      const long long k = bit >> 5;
      const uint32_t sh = static_cast<uint32_t>(bit & 31);
      const uint32_t lo = k >= 0 && k < nstage ? s_word[warp][k] : load_word(words, nw, w0 + k);
      const uint32_t hi = k + 1 >= 0 && k + 1 < nstage ? s_word[warp][k + 1]
                                                       : load_word(words, nw, w0 + k + 1);
      x = ((lo >> sh) | (sh > 0 ? hi << (32u - sh) : 0u)) & bmask;
    }
    v[it] = x;
  }

  // the Simple16 stream: lane l takes words [l c, l c + c) of the K
  const int c = (K + 31) >> 5;
  auto ex_word = [&](int i) {
    const uint32_t lo = s_ex[warp][i];
    return xboff > 0 ? (lo >> xboff) | (s_ex[warp][i + 1] << (32u - xboff)) : lo;
  };
  uint32_t nvals_run = 0;
  for (int k = 0; k < c; ++k) {  // c is warp-uniform: every lane shuffles
    const int i = lane * c + k;
    const uint32_t x = i < K ? ex_word(i) : 0u;
    const uint32_t m = __shfl_sync(kFull, lane_mode, static_cast<int>(x >> 28));
    if (i < K) nvals_run += mode_count(m);
  }
  uint32_t q = warp_inclusive_scan(nvals_run, lane) - nvals_run;  // the run's first index
  for (int k = 0; k < c; ++k) {
    const int i = lane * c + k;
    const uint32_t x = i < K ? ex_word(i) : 0u;
    const uint32_t m = __shfl_sync(kFull, lane_mode, static_cast<int>(x >> 28));
    if (i < K) {
      uint32_t sh = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t cnt = (m >> (10 * r)) & 31u;
        const uint32_t width = (m >> (10 * r + 5)) & 31u;
        const uint32_t wmask = (1u << width) - 1u;  // widths are 1..28
        for (uint32_t t = 0; t < cnt; ++t, ++q, sh += width) {
          if (q < static_cast<uint32_t>(K)) s_elem[warp][q] = ((x & 0x0FFFFFFFu) >> sh) & wmask;
        }
      }
    }
  }
  __syncwarp();

  // positions and highs: lane l takes exceptions [l ce, l ce + ce) of the E
  const int ce = (E + 31) >> 5;
  auto step = [&](int e) { return e == 0 ? s_elem[warp][0] : s_elem[warp][e] + 1u; };
  uint32_t run = 0;
  for (int k = 0; k < ce; ++k) {
    const int e = lane * ce + k;
    if (e < E) run += step(e);
  }
  uint32_t pos = warp_inclusive_scan(run, lane) - run;
  for (int k = 0; k < ce; ++k) {
    const int e = lane * ce + k;
    if (e >= E) break;
    pos += step(e);
    const int p = static_cast<int>(pos);
    if (e < nex && p >= 0 && p < kT) {
      const long long hq = static_cast<long long>(nex) + e;
      const uint32_t high = (hq < K ? s_elem[warp][hq] : 0u) + 1u;
      atomicAdd(&s_patch[warp][p], high << hshift);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < kSteps; ++it) v[it] |= s_patch[warp][it * 32 + lane];

  ds2i::write_full_block_row(v, lane, mode, num_docs, nvals, f + F_BASE, blk0, tile, out, w_out,
                             freq, blkperm, den_blocks, tile_gblk0);
}

}  // namespace

// Decode every ("opt", b, E > 0, 128) group of one stream of a part: n_cta
// CTA-table entries (common.cuh), each of at most 8 rows. The arguments
// are K1's (csrc/optpfor_decode.cu:ds2i_optpfor_decode_part): fld is the
// stream's resident field table, gtile the part's row-to-tile map
// (int64), mode (common.cuh Mode) picks what is written; max_w and max_t
// must be 0 and 128. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
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
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  optpfor_s16_part_kernel<<<n_cta, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld),
      static_cast<const long long*>(gtile), static_cast<const int*>(table), mode, num_docs,
      static_cast<int*>(out), static_cast<float*>(w), static_cast<const int*>(freq),
      static_cast<const long long*>(blkperm), static_cast<const float*>(den_blocks),
      static_cast<const long long*>(tile_gblk0));
  return static_cast<int>(cudaGetLastError());
}
