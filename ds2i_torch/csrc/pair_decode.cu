// EF-family pair decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ds2i_tpu/ops/pallas_decode.py:decode_pair
// (body _pair_kernel / _decode_stream) and its XLA twin
// ds2i_tpu/engine/tile_executor.py:_decode_group. One launch decodes one
// (W, WL, T) tile group, both streams of each tile row:
//   select  the (j+1)-th one bit of the masked high-bits window
//           (popcount prefix over the W window words, then a 5-step
//           in-word search);
//   low     the l-bit low part at lb_bitoff + j*l of the (WL+1)-word window;
//   value   EF ((sel+adj-j) << l) | low, EF_STRICT the same + j,
//           RB sel+adj, AO j, kind -1 gives 0; then + base.
// Docs: slots j >= n_vals give num_docs. Freqs: the cum diff, slot 0
// against the F_PREV_CUM field; slots j >= n_vals give 0. Every valid
// slot equals the TPU kernel bit for bit.
//
// What bounds it on this card: memory. Each row gathers its W window
// words and a few low-bit words and does integer ALU work; there is no
// tensor-core work. Design: one warp per tile row, 4 rows per block. The
// warp loads the row's window words coalesced, masks them, and keeps them
// and their inclusive popcount scan (warp shuffles) in shared memory; each
// lane then decodes slots lane, lane+32, ... by a binary search over the
// scan. The low-bit words are read straight from global memory, with the
// same clamped indices as the TPU kernel's window gather. No TMA, no
// wgmma: speed is later work.

#include "common.cuh"

namespace {

// tile field columns and segment kinds (ds2i_tpu/engine/tiles.py,
// ds2i_tpu/ops/segments.py)
constexpr int F_KIND = 0, F_WIN_WORD0 = 1, F_WIN_BITOFF = 2, F_WIN_LEN = 3,
              F_SEL_ADJ = 4, F_LOWER_BITS = 5, F_LB_WORD0 = 6,
              F_LB_BITOFF = 7, F_BASE = 8, F_NVALS = 9, F_PREV_CUM = 10,
              N_FIELDS = 11;
constexpr int SEG_EF = 0, SEG_EF_STRICT = 1, SEG_RB = 2, SEG_AO = 3;

constexpr int kWarps = 4;      // tile rows per block, one warp each
constexpr int kMaxSlots = 4;   // T / 32 for T <= 128
constexpr unsigned kFull = 0xFFFFFFFFu;

// (1 << h) - 1 for h clipped to [0, 32]; never shifts by 32
__device__ __forceinline__ uint32_t low_mask(int h) {
  return h >= 32 ? 0xFFFFFFFFu : (h <= 0 ? 0u : (1u << h) - 1u);
}

using ds2i::load_word;

// One stream of one tile row: out[it] is the value of slot it*32 + lane.
// s_win / s_cum: this warp's W words of shared memory each.
__device__ __forceinline__ void decode_stream(
    const uint32_t* __restrict__ words, long long nw,
    const int* __restrict__ f, int W, int WL, int nslots, int nvals,
    int lane, uint32_t* s_win, int* s_cum, int (&out)[kMaxSlots]) {
  const int kind = f[F_KIND];
  const int bitoff = f[F_WIN_BITOFF];
  const int wlen = f[F_WIN_LEN];
  const long long win0 = f[F_WIN_WORD0];

  // masked window words and their inclusive popcount scan, 32 per step
  int carry = 0;
  for (int c = 0; c < W; c += 32) {
    const int w = c + lane;
    uint32_t v = 0;
    if (w < W) {
      v = load_word(words, nw, win0 + w) &
          (low_mask(bitoff + wlen - 32 * w) & ~low_mask(bitoff - 32 * w));
    }
    int pc = __popc(v);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, pc, d);
      if (lane >= d) pc += y;
    }
    pc += carry;
    if (w < W) {
      s_win[w] = v;
      s_cum[w] = pc;
    }
    carry = __shfl_sync(kFull, pc, 31);
  }
  __syncwarp();

  const int l = f[F_LOWER_BITS];
  const int adj = f[F_SEL_ADJ];
  const uint32_t base = static_cast<uint32_t>(f[F_BASE]);
  const int lb_bitoff = f[F_LB_BITOFF];
  const long long lb0 = f[F_LB_WORD0];
  const uint32_t lmask = low_mask(l);

#pragma unroll
  for (int it = 0; it < kMaxSlots; ++it) {
    out[it] = 0;
    const int j = it * 32 + lane;
    if (it >= nslots || j >= nvals) continue;  // masked by the caller

    // word holding the (j+1)-th one: the count of scan entries <= j
    int lo = 0, hi = W;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cum[mid] <= j) lo = mid + 1; else hi = mid;
    }
    const int word_idx = lo;
    const int rank_before = word_idx > 0 ? s_cum[word_idx - 1] : 0;
    const int wc = word_idx < W - 1 ? word_idx : W - 1;
    const uint32_t target = s_win[wc];

    // branchless in-word select of the (rem+1)-th set bit
    int rem = j - rank_before;
    int pos = 0;
#pragma unroll
    for (int width = 16; width >= 1; width >>= 1) {
      const int c = __popc(target & (((1u << width) - 1u) << pos));
      const bool right = rem >= c;
      rem -= right ? c : 0;
      pos += right ? width : 0;
    }
    const int sel = wc * 32 + pos - bitoff;

    // l-bit low part; a word past the (WL+1)-word window reads as 0
    const int bit_off = lb_bitoff + j * l;
    int w0i = bit_off >> 5;
    w0i = w0i < 0 ? 0 : (w0i > WL ? WL : w0i);
    const uint32_t s = static_cast<uint32_t>(bit_off & 31);
    const uint32_t lw0 = load_word(words, nw, lb0 + w0i);
    const uint32_t lw1 = w0i + 1 <= WL ? load_word(words, nw, lb0 + w0i + 1) : 0u;
    const uint32_t low = ((lw0 >> s) | (s > 0 ? lw1 << (32u - s) : 0u)) & lmask;

    const uint32_t high = static_cast<uint32_t>(sel + adj - j);
    const uint32_t ef = (static_cast<unsigned>(l) >= 32u ? 0u : high << l) | low;
    uint32_t val = 0;
    if (kind == SEG_EF) val = ef;
    else if (kind == SEG_EF_STRICT) val = ef + static_cast<uint32_t>(j);
    else if (kind == SEG_RB) val = static_cast<uint32_t>(sel + adj);
    else if (kind == SEG_AO) val = static_cast<uint32_t>(j);
    out[it] = static_cast<int>(val + base);
  }
  __syncwarp();  // s_win / s_cum are free for the next stream
}

__global__ void __launch_bounds__(kWarps * 32)
pair_decode_kernel(const uint32_t* __restrict__ dwords, long long dnw,
                   const uint32_t* __restrict__ fwords, long long fnw,
                   const int* __restrict__ dfld, const int* __restrict__ ffld,
                   int R, int W, int WL, int T, int num_docs,
                   int* __restrict__ doc_out, int* __restrict__ freq_out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // warp-uniform: the whole warp leaves together

  uint32_t* s_win = smem + static_cast<size_t>(warp) * 2 * W;
  int* s_cum = reinterpret_cast<int*>(s_win + W);
  const int nslots = T >> 5;
  const int* df = dfld + static_cast<size_t>(r) * N_FIELDS;
  const int nvals = df[F_NVALS];
  int* drow = doc_out + static_cast<size_t>(r) * T;

  int v[kMaxSlots];
  decode_stream(dwords, dnw, df, W, WL, nslots, nvals, lane, s_win, s_cum, v);
#pragma unroll
  for (int it = 0; it < kMaxSlots; ++it) {
    const int j = it * 32 + lane;
    if (it < nslots) drow[j] = j < nvals ? v[it] : num_docs;
  }
  if (freq_out == nullptr) return;

  const int* ff = ffld + static_cast<size_t>(r) * N_FIELDS;
  int* frow = freq_out + static_cast<size_t>(r) * T;
  decode_stream(fwords, fnw, ff, W, WL, nslots, nvals, lane, s_win, s_cum, v);
  // tile-local freq: cum diff; slot 0 takes the F_PREV_CUM field, lane 0
  // of each later step the previous step's lane 31
  int prev_carry = ff[F_PREV_CUM];
#pragma unroll
  for (int it = 0; it < kMaxSlots; ++it) {
    if (it >= nslots) break;  // nslots is warp-uniform
    const int up = __shfl_up_sync(kFull, v[it], 1);
    const int prev = lane == 0 ? prev_carry : up;
    const int j = it * 32 + lane;
    frow[j] = j < nvals
        ? static_cast<int>(static_cast<uint32_t>(v[it]) - static_cast<uint32_t>(prev))
        : 0;
    prev_carry = __shfl_sync(kFull, v[it], 31);
  }
}

}  // namespace

// Decode R tile rows of one (W, WL, T) group. fwords / ffld / freq_out may
// all be NULL to decode the docs stream only. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
extern "C" int ds2i_pair_decode(const void* dwords, long long dnw,
                                const void* fwords, long long fnw,
                                const void* dfld, const void* ffld,
                                int R, int W, int WL, int T, int num_docs,
                                void* doc_out, void* freq_out, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(kWarps) * 2 * W * sizeof(uint32_t);
  const dim3 grid((R + kWarps - 1) / kWarps);
  pair_decode_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dwords), dnw,
      static_cast<const uint32_t*>(fwords), fnw,
      static_cast<const int*>(dfld), static_cast<const int*>(ffld),
      R, W, WL, T, num_docs,
      static_cast<int*>(doc_out), static_cast<int*>(freq_out));
  return static_cast<int>(cudaGetLastError());
}
