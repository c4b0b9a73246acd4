// EF-family pair decode of a part for Hopper (sm_90a): one launch a part.
//
// Replaces the Pallas TPU kernel ds2i_tpu/ops/pallas_decode.py:decode_pair
// (body _pair_kernel / _decode_stream) and its XLA twin
// ds2i_tpu/engine/tile_executor.py:_decode_group, together with what the
// JAX engine's pair mode does around them
// (ds2i_tpu/engine/resident.py:_decode_weight_blocks, pair branch): the
// field-row gathers, the norm-cache den rows (_cached_den_rows) and the
// weight. One launch decodes every (W, WL, T) group of a part, as its CTA
// table (common.cuh) lists them; row r reads its tile id from gtile and
// that tile's field rows from the resident tables. Per stream and slot j:
//   select  the (j+1)-th one bit of the masked high-bits window: every
//           one's window bit is stored at its rank (a popcount scan over
//           the W window words, then one bit a lane, word by word);
//   low     the l-bit low part at lb_bitoff + j*l of the (WL+1)-word
//           window (a word past it reads 0);
//   value   EF ((sel+adj-j) << l) | low, EF_STRICT the same + j,
//           RB sel+adj, AO j, kind -1 gives 0; then + base.
// Written as 32-slot block rows, row r at blocks [blk0 + r*bpt, + bpt):
//   docs    the docs stream's values; slots j >= n_vals give num_docs;
//   w       kDocsPresence: 1.0 where doc < num_docs, else 0;
//           kDocsBm25: f / (f + den), f the tile-local freq (the freqs
//           stream's cum diff, slot 0 against its F_PREV_CUM field; 0 for
//           j >= n_vals), den = den_blocks[tile_gblk0[tile] + j/32][j%32];
//           one IEEE add and one IEEE divide, unmasked like the JAX pair
//           expression `freq / (freq + den)` (a pad slot gives 0/(0+den)).
// The freqs stream is decoded only for kDocsBm25 and never reaches device
// memory. Every slot equals ds2i_torch/ops/pair_decode.py:
// pair_decode_part_torch bit for bit; integer arithmetic is uint32.
//
// What bounds it on this card: latency, then instruction issue. A row
// moves a few hundred bytes, but behind a chain of four dependent reads
// (its CTA's table entry, its tile id, the tile's fields, then its window
// words), and 89% of the 1x opt index's rows decode only 32 slots (T = 32,
// W = 4). Design: kRows rows a CTA, every CTA inside one group (W, WL and
// T come from the table), the CTAs of the longest rows first; each warp
// owns two consecutive rows and never waits for another warp. It stages
// both rows at once: their field rows (both streams for BM25) with
// cp.async, then their W window words and WL+1 low-bit words of each
// stream with cp.async (clamped to the stream) while it loads the rows'
// den blocks into registers, so two rows wait on one chain. It then
// decodes each row from shared memory, a lane a slot of both streams
// (lane l of step it decodes slot it*32 + l, so a T = 32 row keeps every
// lane busy): the select scatter (a lane a bit, so all 32 lanes work on
// each window word, W steps for the whole row instead of a search per
// slot), the low bits from the staged words, the freq cum diff by a
// shuffle. Writes are one coalesced 128-byte line a step and plane. More
// rows a warp, or fewer registers for more warps, timed slower on the
// H100 (PERF.md). No TMA (a row's words are few and unaligned), no
// wgmma (no matrix work).

#include "common.cuh"

namespace {

// tile field columns and segment kinds (ds2i_torch/engine/tiles.py,
// ds2i_torch/ops/segments.py)
constexpr int F_KIND = 0, F_WIN_WORD0 = 1, F_WIN_BITOFF = 2, F_WIN_LEN = 3,
              F_SEL_ADJ = 4, F_LOWER_BITS = 5, F_LB_WORD0 = 6,
              F_LB_BITOFF = 7, F_BASE = 8, F_NVALS = 9, F_PREV_CUM = 10,
              N_FIELDS = 11;
constexpr int SEG_EF = 0, SEG_EF_STRICT = 1, SEG_RB = 2, SEG_AO = 3;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a CTA (ops/block_decode.py PAIR_ROWS)
constexpr int kMaxSteps = 4;                  // T / 32 for T <= 128
constexpr int kMaxW = 1024;                   // W and WL (block_decode._kernel_of)
constexpr int kMaxStage = 2 * kMaxW + 1 + 128;  // W + WL + 1 words and T ints a stream
constexpr unsigned kFull = 0xFFFFFFFFu;

// (1 << h) - 1 for h clipped to [0, 32]; never shifts by 32
__device__ __forceinline__ uint32_t low_mask(int h) {
  return h >= 32 ? 0xFFFFFFFFu : (h <= 0 ? 0u : (1u << h) - 1u);
}

// One stream of one row, decoded by its warp from shared memory. f: the
// stream's field row; stage: its W window words, its WL+1 low-bit words,
// then T ints of scratch. out[it] is the value of slot it*32 + lane (0 for
// slots j >= nvals, which the caller masks).
__device__ __forceinline__ void decode_stream(const int* f, uint32_t* stage, int W, int WL,
                                              int T, int nsteps, int nvals, int lane,
                                              uint32_t (&out)[kMaxSteps]) {
  const uint32_t* win = stage;
  const uint32_t* low = stage + W;
  int* pos = reinterpret_cast<int*>(stage + W + WL + 1);  // window bit of the (r+1)-th one
  const int kind = f[F_KIND];
  const int bitoff = f[F_WIN_BITOFF];
  const int wlen = f[F_WIN_LEN];
  const uint32_t below = (1u << lane) - 1u;  // lane 31: 0x7FFFFFFF

  // select for every slot at once: lane w masks window word w, a warp
  // scan gives the ones before it, then word by word each lane takes one
  // bit and, where it is a one, stores its window bit at its rank
  int before = 0;  // ones in the earlier 32-word steps
  for (int c = 0; c < W; c += 32) {
    const int w = c + lane;
    uint32_t v = 0;
    if (w < W) v = win[w] & (low_mask(bitoff + wlen - 32 * w) & ~low_mask(bitoff - 32 * w));
    const int pc = __popc(v);
    int inc = pc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    const int excl = before + inc - pc;
    const int nwords = W - c < 32 ? W - c : 32;
    for (int k = 0; k < nwords; ++k) {
      const uint32_t word = __shfl_sync(kFull, v, k);
      const int rank = __shfl_sync(kFull, excl, k) + __popc(word & below);
      if (((word >> lane) & 1u) && rank < T) pos[rank] = (c + k) * 32 + lane;
    }
    before += __shfl_sync(kFull, inc, 31);
  }
  __syncwarp();

  const int l = f[F_LOWER_BITS];
  const int adj = f[F_SEL_ADJ];
  const uint32_t base = static_cast<uint32_t>(f[F_BASE]);
  const int lb_bitoff = f[F_LB_BITOFF];
  const uint32_t lmask = low_mask(l);

#pragma unroll
  for (int it = 0; it < kMaxSteps; ++it) {
    out[it] = 0;
    const int j = it * 32 + lane;
    if (it >= nsteps || j >= nvals) continue;
    const bool windowed = kind == SEG_EF || kind == SEG_EF_STRICT || kind == SEG_RB;
    const int sel = (windowed ? pos[j] : 0) - bitoff;

    // l-bit low part; a word past the (WL+1)-word window reads as 0
    const int bit_off = lb_bitoff + j * l;
    int w0i = bit_off >> 5;
    w0i = w0i < 0 ? 0 : (w0i > WL ? WL : w0i);
    const uint32_t s = static_cast<uint32_t>(bit_off & 31);
    const uint32_t lw0 = low[w0i];
    const uint32_t lw1 = w0i + 1 <= WL ? low[w0i + 1] : 0u;
    const uint32_t lowv = ((lw0 >> s) | (s > 0 ? lw1 << (32u - s) : 0u)) & lmask;

    const uint32_t high = static_cast<uint32_t>(sel + adj - j);
    const uint32_t ef = (static_cast<unsigned>(l) >= 32u ? 0u : high << l) | lowv;
    uint32_t val = 0;
    if (kind == SEG_EF) val = ef;
    else if (kind == SEG_EF_STRICT) val = ef + static_cast<uint32_t>(j);
    else if (kind == SEG_RB) val = static_cast<uint32_t>(sel + adj);
    else if (kind == SEG_AO) val = static_cast<uint32_t>(j);
    out[it] = val + base;
  }
}

__global__ void __launch_bounds__(kThreads)
pair_part_kernel(const uint32_t* __restrict__ dwords, long long dnw,
                 const int* __restrict__ dfld, const long long* __restrict__ gtile,
                 const int* __restrict__ table, int max_w, int mode, int num_docs,
                 int* __restrict__ out, float* __restrict__ w_out,
                 const uint32_t* __restrict__ fwords, long long fnw,
                 const int* __restrict__ ffld, const float* __restrict__ den_blocks,
                 const long long* __restrict__ tile_gblk0) {
  extern __shared__ uint32_t smem[];
  const int* cta = table + static_cast<size_t>(blockIdx.x) * ds2i::kCtaFields;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;  // this warp's rows of the CTA: r0, r0 + 1
  const int nrows = cta[ds2i::kCtaNRows];
  if (r0 >= nrows) return;  // warp-uniform; the warps never wait for each other
  const int nr = nrows - r0 < kRowsPerWarp ? nrows - r0 : kRowsPerWarp;
  const int W = cta[ds2i::kCtaP1];
  const int WL = cta[ds2i::kCtaP2];
  const int T = cta[ds2i::kCtaT];
  const int nsteps = T >> 5;
  const long long row0 = cta[ds2i::kCtaRow0] + r0;
  const long long blk0 = cta[ds2i::kCtaBlk0] + static_cast<long long>(r0) * nsteps;
  const bool bm25 = mode == ds2i::kDocsBm25;
  const int ns = bm25 ? 2 : 1;                 // streams: docs, and freqs for BM25
  const int stride = ns * (N_FIELDS + max_w);  // a row: its field rows, then a stage a stream
  const int per = W + WL + 1;                  // words staged a stream
  uint32_t* rows = smem + static_cast<size_t>(warp) * kRowsPerWarp * stride;

  // 1. the rows' tile ids (lane rr holds row rr's)
  const long long mytile = lane < nr ? gtile[row0 + lane] : 0;
  long long tile[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) tile[rr] = __shfl_sync(kFull, mytile, rr);

  // 2. their field rows, and (lane rr) row rr's first den block
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= nr) break;
    for (int c = lane; c < ns * N_FIELDS; c += 32) {
      const int* src = c < N_FIELDS ? dfld + c : ffld + (c - N_FIELDS);
      ds2i::cp_async_4(rows + rr * stride + c, src + tile[rr] * N_FIELDS);
    }
  }
  const long long mygblk = bm25 && lane < nr ? tile_gblk0[mytile] : 0;
  ds2i::cp_async_wait_all();
  __syncwarp();

  // 3. each row's window and low-bit words, per stream, clamped to its words
  static_assert(kRowsPerWarp == 2, "step 3 splits k into two rows");
  for (int k = lane; k < nr * ns * per; k += 32) {
    const int rr = k >= ns * per ? 1 : 0;
    const int k2 = k - rr * ns * per;
    const int s = k2 >= per ? 1 : 0;
    const int q = k2 - s * per;
    const int* f = reinterpret_cast<const int*>(rows + rr * stride + s * N_FIELDS);
    uint32_t* stage = rows + rr * stride + ns * N_FIELDS + s * max_w;
    const uint32_t* words = s ? fwords : dwords;
    const long long nw = s ? fnw : dnw;
    const long long at = q < W ? static_cast<long long>(f[F_WIN_WORD0]) + q
                               : static_cast<long long>(f[F_LB_WORD0]) + (q - W);
    ds2i::cp_async_word(stage + q, words, nw, at);
  }
  float den[kRowsPerWarp][kMaxSteps];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long g = __shfl_sync(kFull, mygblk, rr);
#pragma unroll
    for (int it = 0; it < kMaxSteps; ++it) {
      den[rr][it] = 0.0f;
      if (bm25 && rr < nr && it < nsteps) den[rr][it] = __ldg(den_blocks + (g + it) * 32 + lane);
    }
  }
  ds2i::cp_async_wait_all();
  __syncwarp();

  // 4. decode and write, row by row
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= nr) break;  // warp-uniform
    uint32_t* row = rows + rr * stride;
    const int* fd = reinterpret_cast<const int*>(row);
    const int nvals = fd[F_NVALS];
    uint32_t dv[kMaxSteps], fv[kMaxSteps];
    decode_stream(fd, row + ns * N_FIELDS, W, WL, T, nsteps, nvals, lane, dv);
    if (bm25) {
      decode_stream(fd + N_FIELDS, row + ns * N_FIELDS + max_w, W, WL, T, nsteps, nvals, lane, fv);
    }
    const long long o = (blk0 + static_cast<long long>(rr) * nsteps) * 32 + lane;
    // the freq cum diff: slot 0 takes F_PREV_CUM, lane 0 of each later
    // step the previous step's lane 31
    uint32_t prev_carry = bm25 ? static_cast<uint32_t>(fd[N_FIELDS + F_PREV_CUM]) : 0u;
#pragma unroll
    for (int it = 0; it < kMaxSteps; ++it) {
      if (it >= nsteps) break;  // warp-uniform
      const bool valid = it * 32 + lane < nvals;
      const int doc = valid ? static_cast<int>(dv[it]) : num_docs;
      out[o + it * 32] = doc;
      if (mode == ds2i::kDocsPresence) {
        w_out[o + it * 32] = doc < num_docs ? 1.0f : 0.0f;
      } else if (bm25) {
        const uint32_t up = __shfl_up_sync(kFull, fv[it], 1);
        const uint32_t prev = lane == 0 ? prev_carry : up;
        prev_carry = __shfl_sync(kFull, fv[it], 31);
        const float f = __int2float_rn(valid ? static_cast<int>(fv[it] - prev) : 0);
        w_out[o + it * 32] = __fdiv_rn(f, __fadd_rn(f, den[rr][it]));
      }
    }
  }
}

}  // namespace

// Decode every ("ef", W, WL, T) group of a part: n_cta CTA-table entries
// (common.cuh), each of at most 16 rows of one group, 1 <= W <= 1024,
// 0 <= WL <= 1024, T in {32, 64, 128}; max_w is the largest W + WL + 1 + T
// of the table (it sizes the shared memory), max_t its largest T. dfld /
// ffld are the resident field tables of the docs and freqs streams, gtile
// the part's row-to-tile map (int64). mode (common.cuh Mode) is kDocs (the
// norm cache), kDocsPresence or kDocsBm25; out takes int32 blocks of 32
// slots and, in the weighted modes, w the f32 blocks beside them.
// kDocsBm25 also reads fwords (fnw words), ffld, den_blocks (f32 blocks)
// and tile_gblk0 (int64). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int ds2i_pair_decode_part(
    const void* dwords, long long dnw, const void* dfld, const void* gtile, const void* table,
    int n_cta, int max_w, int max_t, int mode, int num_docs, void* out, void* w,
    const void* fwords, long long fnw, const void* ffld, const void* den_blocks,
    const void* tile_gblk0, void* stream) {
  if (n_cta < 0 || max_w < 34 || max_w > kMaxStage || max_t < 32 || max_t > 32 * kMaxSteps ||
      mode < ds2i::kDocs || mode > ds2i::kDocsBm25 || dwords == nullptr || dnw < 1 ||
      out == nullptr || (mode >= ds2i::kDocsPresence && w == nullptr) ||
      (mode == ds2i::kDocsBm25 && (fwords == nullptr || fnw < 1 || ffld == nullptr ||
                                   den_blocks == nullptr || tile_gblk0 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  // the shared rows of pair_part_kernel
  const int ns = mode == ds2i::kDocsBm25 ? 2 : 1;
  const size_t smem = static_cast<size_t>(kRows) * ns * (N_FIELDS + max_w) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pair_part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pair_part_kernel<<<n_cta, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dwords), dnw, static_cast<const int*>(dfld),
      static_cast<const long long*>(gtile), static_cast<const int*>(table), max_w, mode, num_docs,
      static_cast<int*>(out), static_cast<float*>(w), static_cast<const uint32_t*>(fwords), fnw,
      static_cast<const int*>(ffld), static_cast<const float*>(den_blocks),
      static_cast<const long long*>(tile_gblk0));
  return static_cast<int>(cudaGetLastError());
}
