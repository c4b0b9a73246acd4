// Binary interpolative block decode for Hopper (sm_90a): K2, one launch
// per stream of a part.
//
// Replaces the jnp device op ds2i_tpu/ops/interp_device.py:interp_decode
// (the per-row stack machine) together with the assembly and pad mask of
// ds2i_tpu/engine/resident.py:_decode_block_stream ("interp") and
// _decode_doc_group_blocks / _decode_freq_group_blocks, and, in the docs
// stream, the freq realign (blkperm), the norm-cache den rows and the
// weight of _decode_weight_blocks' split branch. One launch decodes every
// ("interp", W, T) group of one stream of a part (every list's partial
// tail block, and the full blocks of block_interpolative indexes), as its
// CTA table (common.cuh) lists them:
//   DFS     from the range (0, n-1) with cum[n-1] = BF_EX_W0 known, pop a
//           range (lo, hi), read the centred minimal binary code of its
//           midpoint h in [cum[lo-1], cum[hi]], store cum[h], push the
//           right then the left child; at most T-1 steps, a stack of 8
//           (rows of 0 <= n <= T, as the table builders make them);
//   bits    read from the row's W-word window at BF_W0 (its words clamp
//           to nw-1; a word index >= W reads 0, as the JAX op's
//           comparison-reduce does), from bit BF_BOFF;
//   docs    F_BASE + cum[j] + j;
//   freqs   cum[j] - cum[j-1] + 1 (cum[-1] = 0);
//   pads    slots j >= n_vals, and slots T..31 of a narrow tail (T < 32),
//           give num_docs (docs) or 0 (freqs);
//   weights (docs, modes kDocsPresence / kDocsBm25) slot_weight.
// Every slot equals ds2i_torch/ops/block_decode.py:split_decode_part_torch
// bit for bit; the arithmetic is the JAX op's uint32/int32, wrapping alike.
//
// What bounds it on this card: latency, not bytes. The decode of a row is
// a chain of n-1 dependent steps, so a launch lasts about as long as its
// longest chain (a row of 128 values) once every row has an SM slot; the
// bytes are a few hundred a row. Design: kRows rows per CTA, every CTA
// inside one group, one thread of warp 0 per row for the DFS, and all
// kThreads threads for what has no chain: the CTA stages its rows' W-word
// windows in shared memory with cp.async, clamped as above, and, for BM25
// weights, its blocks' blkperm entries; each DFS step then reads shared
// memory, not device memory. A window is stored row-major with an odd
// stride of W + 1 words, so the staging reads whole lines of a row and
// writes 32 banks, and the DFS's reads of 32 rows spread over the banks.
// Value lanes and the stack are stored lane-major (lane l of row r at
// [l * kRows + r]): the 32 threads of warp 0 hit 32 banks whatever lanes
// they touch. A step reads the two window words at its bit cursor once,
// as one 64-bit funnel holding the code's b bits and the extra bit after
// them (b + 1 <= 32 bits from a shift <= 31). The step's bounds cum[lo-1] and cum[hi] ride
// with the range, in registers for the left child (always popped next)
// and on the stack for a right one, so the chain reads no value lanes; the
// lanes are only written, for the CTA's writes. Dynamic shared memory:
// kRows * (max_w + max_t + 43) words, at most 44,928 bytes at W = 180,
// T = 128 (the opt-in above 48 KB is set where a launch would need it).
// The host orders the CTAs by T, longest first, so the longest chains
// start first. After the DFS all threads write the CTA's blocks together,
// coalesced (rows of a CTA write consecutive blocks), the loads of the
// freqs and den rows of several blocks in flight at once.

#include "common.cuh"

namespace {

// block tile field columns (ds2i_torch/engine/block_tiles.py)
constexpr int BF_W0 = 1, BF_EX_W0 = 4, BF_BOFF = 5, F_BASE = 8, F_NVALS = 9,
              N_FIELDS = 11;
constexpr int kRows = 32;     // rows per CTA, one thread of warp 0 each
constexpr int kThreads = 128; // threads per CTA: staging and the writes
constexpr int kDepth = 8;     // DFS stack depth for <= 128 values (interp_device.DEPTH)
constexpr int kMaxT = 128;
constexpr int kMaxW = 180;    // block_tiles._WIN_BUCKETS[-1]
constexpr int kMaxBlocks = kRows * (kMaxT / 32);

using ds2i::cp_async_wait_all;
using ds2i::cp_async_word;

__global__ void __launch_bounds__(kThreads)
interp_part_kernel(const uint32_t* __restrict__ words, long long nw,
                   const int* __restrict__ fld, const long long* __restrict__ gtile,
                   const int* __restrict__ table, int max_w, int max_t, int mode,
                   int num_docs, int* __restrict__ out, float* __restrict__ w_out,
                   const int* __restrict__ freq, const long long* __restrict__ blkperm,
                   const float* __restrict__ den_blocks,
                   const long long* __restrict__ tile_gblk0) {
  extern __shared__ uint32_t smem[];
  uint32_t* win = smem;                                           // max_w + 1 words a row
  int* vals = reinterpret_cast<int*>(win + (max_w + 1) * kRows);  // max_t + 2 lanes a row
  int* st_lohi = vals + (max_t + 2) * kRows;  // kDepth stack entries a row: lo | hi << 16
  uint32_t* st_low = reinterpret_cast<uint32_t*>(st_lohi + kDepth * kRows);  // and cum[lo-1]
  uint32_t* st_high = st_low + kDepth * kRows;                               // and cum[hi]
  int* s_n = reinterpret_cast<int*>(st_high + kDepth * kRows);
  int* s_base = s_n + kRows;
  int* s_boff = s_base + kRows;
  int* s_sum = s_boff + kRows;
  long long* s_w0 = reinterpret_cast<long long*>(s_sum + kRows);  // 8-byte aligned
  long long* s_den = s_w0 + kRows;
  long long* s_bp = s_den + kRows;  // blkperm of the CTA's blocks

  const int* cta = table + static_cast<size_t>(blockIdx.x) * ds2i::kCtaFields;
  const int W = cta[ds2i::kCtaP1];
  const int T = cta[ds2i::kCtaT];
  const int nrows = cta[ds2i::kCtaNRows];
  const long long row0 = cta[ds2i::kCtaRow0];
  const long long blk0 = cta[ds2i::kCtaBlk0];
  const int t = threadIdx.x;
  const int VW = T + 2;  // [global-low = 0, cum[0..T-1], pad]
  const int bpt = T >= 32 ? T / 32 : 1;
  const bool bm25 = mode == ds2i::kDocsBm25;

  if (t < kRows) {
    int n = 0, base = 0, boff = 0, sum = 0;
    long long w0 = 0, den = 0;
    if (t < nrows) {
      const long long tile = gtile[row0 + t];
      const int* f = fld + static_cast<size_t>(tile) * N_FIELDS;
      n = f[F_NVALS];
      base = f[F_BASE];
      boff = f[BF_BOFF];
      sum = f[BF_EX_W0];
      w0 = f[BF_W0];
      den = bm25 ? tile_gblk0[tile] : 0;
    }
    s_n[t] = n;
    s_base[t] = base;
    s_boff[t] = boff;
    s_sum[t] = sum;
    s_w0[t] = w0;
    s_den[t] = den;
  }
  for (int i = t; i < VW * kRows; i += kThreads) vals[i] = 0;
  if (bm25) {
    for (int k = t; k < nrows * bpt && k < kMaxBlocks; k += kThreads) s_bp[k] = blkperm[blk0 + k];
  }
  __syncthreads();
  // the rows' windows, row by row: a warp copies 32 words of a row
  const int ws = W + 1;  // odd: W is even
  for (int i = t; i < W * nrows; i += kThreads) {
    const int r = i / W;
    const int wi = i - r * W;
    cp_async_word(&win[r * ws + wi], words, nw, s_w0[r] + wi);
  }
  if (t < nrows) {
    const int n = s_n[t];
    if (n >= 0 && n < VW) vals[n * kRows + t] = s_sum[t];
  }
  cp_async_wait_all();
  __syncthreads();

  if (t < nrows) {
    const int n = s_n[t];
    int bitpos = s_boff[t];
    auto wword = [&](int wi) { return (wi >= 0 && wi < W) ? win[t * ws + wi] : 0u; };
    // the range (lo, hi) being decoded and its bounds low = cum[lo-1] and
    // high = cum[hi] (lanes lo and hi + 1 of the JAX op's value row): the
    // left child, popped next, continues in registers; a right child goes
    // to the stack with its bounds, which no later step of the left
    // subtree writes. For 0 <= n <= T <= 128 the stack never passes 7
    // entries, so this is the JAX op's stack machine step for step.
    int lo = 0, hi = n - 1;
    uint32_t low = 0u;
    uint32_t high = (n >= 0 && n < VW) ? static_cast<uint32_t>(s_sum[t]) : 0u;
    int sp = 0;
    bool more = n > 1;
    for (int step = 0; step < T - 1 && more; ++step) {
      // the window bits at the cursor: b code bits, then the extra bit
      const int wi = bitpos >> 5;
      const uint32_t s = static_cast<uint32_t>(bitpos & 31);
      const unsigned long long bits =
          ((static_cast<unsigned long long>(wword(wi + 1)) << 32) | wword(wi)) >> s;

      const int h = lo + (hi - lo) / 2;  // hi >= lo: / is the JAX floor division
      const uint32_t u = high - low + 1u;
      const int b = 31 - __clz(u > 1u ? u : 1u);
      const uint32_t m = (b + 1 >= 32 ? 0u : (1u << (b + 1))) - u;

      const uint32_t x = static_cast<uint32_t>(bits) & ((1u << b) - 1u);  // b <= 31
      const uint32_t extra = static_cast<uint32_t>(bits >> b) & 1u;
      const bool wide = x >= m;
      const uint32_t code = wide ? (x << 1) + extra - m : x;
      bitpos = bitpos + b + (wide ? 1 : 0);
      const uint32_t val = low + code;  // cum[h]

      const int hv = h + 1;
      if (hv >= 0 && hv < VW) vals[hv * kRows + t] = static_cast<int>(val);

      // push the right child (h+1, hi), then take the left (lo, h)
      if (hi - h - 1 > 0 && sp < kDepth) {
        st_lohi[sp * kRows + t] = (h + 1) | (hi << 16);
        st_low[sp * kRows + t] = val;
        st_high[sp * kRows + t] = high;
        ++sp;
      }
      if (h - lo > 0) {
        hi = h;
        high = val;
      } else if (sp > 0) {
        --sp;
        const int lh = st_lohi[sp * kRows + t];
        lo = lh & 0xFFFF;
        hi = lh >> 16;
        low = st_low[sp * kRows + t];
        high = st_high[sp * kRows + t];
      } else {
        more = false;
      }
    }
  }
  __syncthreads();

  // the CTA's rows, written together: row r's slot q lands at block
  // blk0 + r * bpt + q / 32, so the CTA's slots are consecutive
  const int span = bpt * 32;
  const int pad = mode == ds2i::kFreqs ? 0 : num_docs;
#pragma unroll 4
  for (int i = t; i < nrows * span; i += kThreads) {
    const int rr = i / span;
    const int j = i - rr * span;
    const int s = i & 31;
    // the weight's operands first, whatever the slot holds, so that the
    // loads of several iterations are in flight together
    float f = 0.0f, den = 0.0f;
    if (bm25) {
      f = __int2float_rn(freq[s_bp[i >> 5] * 32 + s]);
      den = den_blocks[(s_den[rr] + j / 32) * 32 + s];
    }
    int v = pad;
    if (j < T && j < s_n[rr]) {
      const uint32_t cum = static_cast<uint32_t>(vals[(j + 1) * kRows + rr]);
      if (mode == ds2i::kFreqs) {
        const uint32_t prev = j > 0 ? static_cast<uint32_t>(vals[j * kRows + rr]) : 0u;
        v = static_cast<int>(cum - prev + 1u);
      } else {
        v = static_cast<int>(static_cast<uint32_t>(s_base[rr]) + cum + static_cast<uint32_t>(j));
      }
    }
    const long long o = blk0 * 32 + i;
    out[o] = v;
    if (mode >= ds2i::kDocsPresence) w_out[o] = ds2i::slot_weight(mode, v, num_docs, f, den);
  }
}

}  // namespace

// Decode every ("interp", W, T) group of one stream of a part: n_cta
// CTA-table entries (common.cuh), each of at most 32 rows, W <= max_w <=
// 180, T <= max_t <= 128 (they size the shared memory). The other
// arguments are ds2i_optpfor_decode_part's. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int ds2i_interp_decode_part(
    const void* words, long long nw, const void* fld, const void* gtile, const void* table,
    int n_cta, int max_w, int max_t, int mode, int num_docs, void* out, void* w,
    const void* freq, const void* blkperm, const void* den_blocks, const void* tile_gblk0,
    void* stream) {
  if (n_cta < 0 || max_w < 1 || max_w > kMaxW || max_t < 1 || max_t > kMaxT ||
      mode < ds2i::kFreqs || mode > ds2i::kDocsBm25 || out == nullptr ||
      (mode >= ds2i::kDocsPresence && w == nullptr) ||
      (mode == ds2i::kDocsBm25 && (freq == nullptr || blkperm == nullptr ||
                                   den_blocks == nullptr || tile_gblk0 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  // the shared arrays of interp_part_kernel, in its order
  const size_t smem = static_cast<size_t>(kRows) *
                          (max_w + 1 + (max_t + 2) + 3 * kDepth + 4) * sizeof(int) +
                      (2 * kRows + kMaxBlocks) * sizeof(long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        interp_part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  interp_part_kernel<<<n_cta, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld),
      static_cast<const long long*>(gtile), static_cast<const int*>(table), max_w, max_t, mode,
      num_docs, static_cast<int*>(out), static_cast<float*>(w), static_cast<const int*>(freq),
      static_cast<const long long*>(blkperm), static_cast<const float*>(den_blocks),
      static_cast<const long long*>(tile_gblk0));
  return static_cast<int>(cudaGetLastError());
}
