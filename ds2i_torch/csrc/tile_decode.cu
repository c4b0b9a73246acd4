// One-stream tile-group decode for Hopper (sm_90a), K6g: one launch
// decodes R tiles of one (W, WL, T) group of one stream.
//
// Replaces ds2i_tpu/engine/tile_executor.py:_decode_group, the decode of
// the JAX package's TileQueryEngine (one stream of one group at a time;
// its fused two-stream twin is the Pallas kernel that csrc/pair_decode.cu
// ports). Per row (a tile's field row, ds2i_torch/engine/tiles.py) and
// slot j < min(n_vals, T):
//   select  the (j+1)-th one bit of the high-bits window: the W words from
//           F_WIN_WORD0 (indices clamped to the stream), masked to
//           [F_WIN_BITOFF, F_WIN_BITOFF + F_WIN_LEN); sel = its window bit
//           less F_WIN_BITOFF;
//   low     the l-bit low part at F_LB_BITOFF + j*l of the WL+1 words from
//           F_LB_WORD0 (a word past them reads 0);
//   value   EF ((sel+adj-j) << l) | low, EF_STRICT the same + j, RB sel+adj,
//           AO j, kind -1 gives 0; then + base (uint32 arithmetic).
// Written to out[r][j], int32 (R, T); slots j >= n_vals get 0 (the JAX
// contract leaves them undefined and its caller masks them). Every slot
// j < n_vals equals ds2i_torch/ops/pair_decode.py:_decode_stream.
//
// What bounds it: a row is a chain of dependent reads (its fields, then
// its window words) and a few hundred bytes, as for csrc/pair_decode.cu,
// whose select this kernel copies (copied, not shared, so that kernel's
// source and build stay as they are): a warp a row, kWarps rows a CTA,
// lane w reads window word w (32 words a step, coalesced), a warp scan of
// the popcounts ranks the ones, and word by word each lane takes one bit
// and, where it is a one, stores its window bit at its rank in shared
// memory; then a lane a slot reads its select and its low bits. The words
// are read from device memory directly, not staged: a row reads each
// window word once.

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

// (1 << h) - 1 for h clipped to [0, 32]; never shifts by 32
__device__ __forceinline__ uint32_t low_mask(int h) {
  return h >= 32 ? 0xFFFFFFFFu : (h <= 0 ? 0u : (1u << h) - 1u);
}

__global__ void __launch_bounds__(kThreads)
tile_group_kernel(const uint32_t* __restrict__ words, long long nw, const int* __restrict__ fld,
                  int R, int W, int WL, int T, int* __restrict__ out) {
  __shared__ int pos_all[kWarps][kMaxT];  // window bit of the (r+1)-th one
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= R) return;  // warp-uniform
  int* pos = pos_all[warp];
  const int* f = fld + r * N_FIELDS;
  const int kind = __ldg(f + F_KIND);
  const long long word0 = __ldg(f + F_WIN_WORD0);
  const int bitoff = __ldg(f + F_WIN_BITOFF);
  const int wlen = __ldg(f + F_WIN_LEN);
  const int nvals = __ldg(f + F_NVALS);
  for (int j = lane; j < T; j += 32) pos[j] = 0;
  __syncwarp();

  // select for every slot at once: lane w masks window word w, a warp
  // scan gives the ones before it, then word by word each lane takes one
  // bit and, where it is a one, stores its window bit at its rank
  const uint32_t below = (1u << lane) - 1u;  // lane 31: 0x7FFFFFFF
  int before = 0;                            // ones in the earlier 32-word steps
  for (int c = 0; c < W && before < T; c += 32) {
    const int w = c + lane;
    uint32_t v = 0;
    if (w < W) {
      v = ds2i::load_word(words, nw, word0 + w) &
          (low_mask(bitoff + wlen - 32 * w) & ~low_mask(bitoff - 32 * w));
    }
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

  const int l = __ldg(f + F_LOWER_BITS);
  const int adj = __ldg(f + F_SEL_ADJ);
  const uint32_t base = static_cast<uint32_t>(__ldg(f + F_BASE));
  const long long lb0 = __ldg(f + F_LB_WORD0);
  const int lb_bitoff = __ldg(f + F_LB_BITOFF);
  const uint32_t lmask = low_mask(l);
  const bool windowed = kind == SEG_EF || kind == SEG_EF_STRICT || kind == SEG_RB;
  for (int j = lane; j < T; j += 32) {
    uint32_t val = 0;
    if (j < nvals) {
      const int sel = (windowed ? pos[j] : 0) - bitoff;
      // l-bit low part; a word past the (WL+1)-word window reads as 0
      const int bit_off = lb_bitoff + j * l;
      int w0i = bit_off >> 5;
      w0i = w0i < 0 ? 0 : (w0i > WL ? WL : w0i);
      const uint32_t s = static_cast<uint32_t>(bit_off & 31);
      const uint32_t lw0 = ds2i::load_word(words, nw, lb0 + w0i);
      const uint32_t lw1 = w0i + 1 <= WL ? ds2i::load_word(words, nw, lb0 + w0i + 1) : 0u;
      const uint32_t lowv = ((lw0 >> s) | (s > 0 ? lw1 << (32u - s) : 0u)) & lmask;
      const uint32_t high = static_cast<uint32_t>(sel + adj - j);
      const uint32_t ef = (static_cast<unsigned>(l) >= 32u ? 0u : high << l) | lowv;
      if (kind == SEG_EF) val = ef;
      else if (kind == SEG_EF_STRICT) val = ef + static_cast<uint32_t>(j);
      else if (kind == SEG_RB) val = static_cast<uint32_t>(sel + adj);
      else if (kind == SEG_AO) val = static_cast<uint32_t>(j);
      val += base;
    }
    out[r * T + j] = static_cast<int>(val);
  }
}

}  // namespace

// Decode R field rows (fld, int32 (R, N_FIELDS)) of one (W, WL, T) group of
// one stream of nw words into out, int32 (R, T); 1 <= W, 0 <= WL,
// 1 <= T <= 128. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int ds2i_tile_decode_group(const void* words, long long nw, const void* fld, int R,
                                      int W, int WL, int T, void* out, void* stream) {
  if (words == nullptr || nw < 1 || fld == nullptr || out == nullptr || R < 0 || W < 1 ||
      WL < 0 || T < 1 || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(R) + kWarps - 1) / kWarps);
  tile_group_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld), R, W, WL, T,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
