// One-stream tile-group decode for Hopper (sm_90a), K6g: one launch
// decodes R tiles of one (W, WL, T) group of one stream.
//
// Replaces ds2i_tpu/engine/tile_executor.py:_decode_group, the decode of
// the JAX package's TileQueryEngine (one stream of one group at a time;
// its fused two-stream twin is the Pallas kernel that csrc/pair_decode.cu
// ports). Per row (a tile's field row, ds2i_torch/engine/tiles.py) and
// slot j < n = min(n_vals, T):
//   select  the (j+1)-th one bit of the high-bits window: the W words from
//           F_WIN_WORD0 (indices clamped to the stream), masked to
//           [F_WIN_BITOFF, F_WIN_BITOFF + F_WIN_LEN); sel = its window bit
//           less F_WIN_BITOFF. Where the window holds C <= j ones, the
//           plain version's select lands in word W-1 (the (j-C+1)-th one
//           of its masked bits, or bit 31), and so does this one;
//   low     the l-bit low part at F_LB_BITOFF + j*l of the WL+1 words from
//           F_LB_WORD0 (a word past them reads 0);
//   value   EF (max(sel+adj-j, 0) << l) | low, EF_STRICT the same + j, RB
//           sel+adj, AO j, any other kind 0; then + base (uint32
//           arithmetic, wrapping as the plain version's int32 cast does).
// Written to out[r][j] for j < n only: the JAX contract leaves the slots
// j >= n_vals undefined (every caller masks them), so they, and a pad
// row's (n_vals <= 0) slots, keep what the output buffer held. Every slot
// j < n_vals equals ds2i_torch/ops/pair_decode.py:_decode_stream.
//
// What bounds it: not bytes (a real row of the 1x `opt` layout holds 17
// values; 30 MB over 12 launches) but each row's chain of dependent reads
// and the bytes it writes needlessly. The first design waited on four or
// more rounds of reads a row (five fields, the window 32 words a step,
// five more fields, then two device loads a slot for its low bits) and
// wrote all T = 128 slots of every row, pad rows too: 182.5 MB over the
// 12 launches where the contract needs 16 MB.
//
// This design: a warp a row, kWarps rows a CTA. A row's reads come in two
// rounds:
//   1. lanes 0-10 load the row's 11 contiguous field words, broadcast by
//      shuffle; a pad row stops here and writes nothing;
//   2. the window words that hold any of the row's bits (at most W) and
//      the low words its slots read (at most WL + 1) go to the warp's
//      slice of shared memory by cp.async, a word a lane, all issued
//      before any is used (the `opt` groups need at most 81 words: three
//      a lane; larger W or WL take more copies a lane, still all issued
//      first).
// Then the walk, 32 staged window words a step: a warp scan of their
// popcounts ranks the step's ones, and the select is K9's lane a rank:
// lane i takes rank r0 + i, finds its word by a 5-step binary search over
// the scan (__shfl_sync) and its bit by the 5-step popcount search, reads
// its two low words from shared memory and stores its slot; consecutive
// lanes store consecutive slots. The walk stops at the row's last needed
// word, or once n ones are ranked. Slots past the window's ones, and every
// slot of a kind without a window, are taken a lane a slot.
//
// Measured on an H100 (PERF.md, section 6): the 12 launches over the 1x `opt`
// layout cost ~4-7 us each alone whatever their rows (64 rows: 6.6 us),
// and the (4, 4) groups' 131,072 rows a stream the rest; 32 registers a
// thread in place of 37 (64 warps an SM in place of 48) did not move it.

#include "common.cuh"

namespace {

// tile field columns and segment kinds (ds2i_torch/engine/tiles.py,
// ds2i_torch/ops/segments.py)
constexpr int F_KIND = 0, F_WIN_WORD0 = 1, F_WIN_BITOFF = 2, F_WIN_LEN = 3,
              F_SEL_ADJ = 4, F_LOWER_BITS = 5, F_LB_WORD0 = 6,
              F_LB_BITOFF = 7, F_BASE = 8, F_NVALS = 9, N_FIELDS = 11;
constexpr int SEG_EF = 0, SEG_EF_STRICT = 1, SEG_RB = 2, SEG_AO = 3;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 128;  // engine/tiles.py TILE
constexpr unsigned kFull = 0xFFFFFFFFu;
// the most shared memory a block may take (the H100's 227 KB)
constexpr long long kMaxSharedBytes = 232448;

// (1 << h) - 1 for h clipped to [0, 32]; never shifts by 32
__device__ __forceinline__ uint32_t low_mask(long long h) {
  return h >= 32 ? 0xFFFFFFFFu : (h <= 0 ? 0u : (1u << h) - 1u);
}

// the bit of the (rem+1)-th one of x by the branchless 5-step popcount
// search of _decode_stream (31 where x holds rem or fewer ones)
__device__ __forceinline__ int select_in_word(uint32_t x, int rem) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc(x & (((1u << width) - 1u) << pos));
    const bool right = rem >= c;
    rem -= right ? c : 0;
    pos += right ? width : 0;
  }
  return pos;
}

struct Row {
  int kind, bitoff, adj, l, lb_bitoff, WL;
  uint32_t base;
  const uint32_t* low;  // the staged low words, word 0 at F_LB_WORD0
};

// slot j's value given its select bit `sel`
__device__ __forceinline__ int slot_value(const Row& w, int j, int sel) {
  uint32_t val = 0;
  if (w.kind == SEG_EF || w.kind == SEG_EF_STRICT) {
    const int bit_off = w.lb_bitoff + j * w.l;
    int w0i = bit_off >> 5;
    w0i = w0i < 0 ? 0 : (w0i > w.WL ? w.WL : w0i);
    const uint32_t s = static_cast<uint32_t>(bit_off & 31);
    const uint32_t lw0 = w.low[w0i];
    const uint32_t lw1 = w0i + 1 <= w.WL ? w.low[w0i + 1] : 0u;
    const uint32_t lowv = ((lw0 >> s) | (s > 0 ? lw1 << (32u - s) : 0u)) & low_mask(w.l);
    long long high = static_cast<long long>(sel) + w.adj - j;
    high = high < 0 ? 0 : high;
    val = (static_cast<unsigned>(w.l) >= 32u ? 0u : static_cast<uint32_t>(high) << w.l) | lowv;
    if (w.kind == SEG_EF_STRICT) val += static_cast<uint32_t>(j);
  } else if (w.kind == SEG_RB) {
    val = static_cast<uint32_t>(sel) + static_cast<uint32_t>(w.adj);
  } else if (w.kind == SEG_AO) {
    val = static_cast<uint32_t>(j);
  }
  return static_cast<int>(val + w.base);
}

__global__ void __launch_bounds__(kThreads)
tile_group_kernel(const uint32_t* __restrict__ words, long long nw, const int* __restrict__ fld,
                  int R, int W, int WL, int T, int* __restrict__ out) {
  extern __shared__ uint32_t stage[];  // a warp's W window words, then WL + 1 low words
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= R) return;  // warp-uniform
  uint32_t* win = stage + static_cast<long long>(warp) * (W + WL + 1);

  // round 1: a lane a field word, broadcast by shuffle
  const int mine = lane < N_FIELDS ? __ldg(fld + r * N_FIELDS + lane) : 0;
  const int nvals = __shfl_sync(kFull, mine, F_NVALS);
  const int n = min(nvals, T);
  if (n <= 0) return;  // a pad row: nothing to write
  Row w;
  w.kind = __shfl_sync(kFull, mine, F_KIND);
  const int word0 = __shfl_sync(kFull, mine, F_WIN_WORD0);
  w.bitoff = __shfl_sync(kFull, mine, F_WIN_BITOFF);
  const int wlen = __shfl_sync(kFull, mine, F_WIN_LEN);
  w.adj = __shfl_sync(kFull, mine, F_SEL_ADJ);
  w.l = __shfl_sync(kFull, mine, F_LOWER_BITS);
  const int lb0 = __shfl_sync(kFull, mine, F_LB_WORD0);
  w.lb_bitoff = __shfl_sync(kFull, mine, F_LB_BITOFF);
  w.base = static_cast<uint32_t>(__shfl_sync(kFull, mine, F_BASE));
  w.WL = WL;
  uint32_t* low = win + W;
  w.low = low;
  const bool ef = w.kind == SEG_EF || w.kind == SEG_EF_STRICT;
  const bool windowed = ef || w.kind == SEG_RB;

  // the window words that hold any of the row's bits, and the low words
  // its n slots read (slot j: word clamp((lb_bitoff + j*l) >> 5, 0, WL)
  // and the one after it)
  const long long hi_bit = static_cast<long long>(w.bitoff) + wlen;
  const long long needed = windowed && wlen > 0 ? (hi_bit + 31) >> 5 : 0;
  const int nwin = static_cast<int>(needed < W ? needed : W);
  int nlw = 0;
  if (ef) {
    const int a = max(0, min(w.lb_bitoff >> 5, WL));
    const int b = max(0, min((w.lb_bitoff + (n - 1) * w.l) >> 5, WL));
    nlw = min(max(a, b) + 1, WL) + 1;
  }
  // round 2: every staged word issued before any is used
  for (int k = lane; k < nwin; k += 32) {
    ds2i::cp_async_word(win + k, words, nw, static_cast<long long>(word0) + k);
  }
  for (int k = lane; k < nlw; k += 32) {
    ds2i::cp_async_word(low + k, words, nw, static_cast<long long>(lb0) + k);
  }
  ds2i::cp_async_wait_all();
  __syncwarp();

  int* row_out = out + r * T;
  if (!windowed) {
    for (int j = lane; j < n; j += 32) row_out[j] = slot_value(w, j, 0);
    return;
  }
  int before = 0;  // ones ranked in the earlier 32-word steps
  for (int c = 0; c < nwin && before < n; c += 32) {
    const int k = c + lane;
    const uint32_t v = k < nwin
        ? win[k] & (low_mask(hi_bit - 32 * k) & ~low_mask(w.bitoff - 32LL * k)) : 0u;
    const int pc = __popc(v);
    const int inc = static_cast<int>(ds2i::warp_inclusive_scan(static_cast<uint32_t>(pc), lane));
    const int tot = __shfl_sync(kFull, inc, 31);
    const int end = min(before + tot, n);
    for (int r0 = before; r0 < end; r0 += 32) {  // a lane a rank
      const int t = r0 + lane - before;
      int wi = 0;  // the lane's word: the first with inc > t
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        if (__shfl_sync(kFull, inc, wi + d - 1) <= t) wi += d;
      }
      const uint32_t word = __shfl_sync(kFull, v, wi);
      const int excl = __shfl_sync(kFull, inc - pc, wi);
      const int sel = (c + wi) * 32 + select_in_word(word, t - excl) - w.bitoff;
      if (r0 + lane < end) row_out[r0 + lane] = slot_value(w, r0 + lane, sel);
    }
    before += tot;
  }
  if (before < n) {
    // the window holds C = before ones: slot j selects in word W-1, the
    // (j-C+1)-th one of its masked bits (bit 31 past them)
    const int k = W - 1;
    const uint32_t last = nwin == W
        ? win[k] & (low_mask(hi_bit - 32 * k) & ~low_mask(w.bitoff - 32LL * k)) : 0u;
    for (int j = before + lane; j < n; j += 32) {
      row_out[j] = slot_value(w, j, k * 32 + select_in_word(last, j - before) - w.bitoff);
    }
  }
}

}  // namespace

// Decode R field rows (fld, int32 (R, N_FIELDS)) of one (W, WL, T) group of
// one stream of nw words into out, int32 (R, T): a row's slots j < n_vals,
// nothing else; 1 <= W, 0 <= WL, 1 <= T <= 128, and the block's staging
// (kWarps * (W + WL + 1) words) within the card's shared memory. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int ds2i_tile_decode_group(const void* words, long long nw, const void* fld, int R,
                                      int W, int WL, int T, void* out, void* stream) {
  const long long smem = 4LL * kWarps * (static_cast<long long>(W) + WL + 1);
  if (words == nullptr || nw < 1 || fld == nullptr || out == nullptr || R < 0 || W < 1 ||
      WL < 0 || T < 1 || T > kMaxT || smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(R) + kWarps - 1) / kWarps);
  tile_group_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld), R, W, WL, T,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's registers a thread, local (spilled) bytes a thread and
// static shared bytes a block, into attrs[0..2]; returns the CUDA error.
extern "C" int ds2i_tile_decode_attributes(int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, tile_group_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.localSizeBytes);
  attrs[2] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
