// Binary interpolative block decode for Hopper (sm_90a): K2.
//
// Replaces the jnp device op ds2i_tpu/ops/interp_device.py:interp_decode
// (the per-row stack machine) together with the assembly and pad mask of
// ds2i_tpu/engine/resident.py:_decode_block_stream ("interp") and
// _decode_doc_group_blocks / _decode_freq_group_blocks. One launch decodes
// one stream of one ("interp", W, T) group: every list's partial tail
// block, and the full blocks of block_interpolative indexes.
//   DFS     from the range (0, n-1) with cum[n-1] = BF_EX_W0 known, pop a
//           range (lo, hi), read the centred minimal binary code of its
//           midpoint h in [cum[lo-1], cum[hi]], store cum[h], push the
//           right then the left child; at most T-1 steps, a stack of 8;
//   bits    read from the row's W-word window at BF_W0 (its words clamp
//           to nw-1; a word index >= W reads 0, as the JAX op's
//           comparison-reduce does), from bit BF_BOFF;
//   docs    F_BASE + cum[j] + j;
//   freqs   cum[j] - cum[j-1] + 1 (cum[-1] = 0);
//   pads    slots j >= n_vals give num_docs (docs) or 0 (freqs).
// Every slot equals ds2i_torch/ops/block_decode.py:block_stream_torch bit
// for bit; the arithmetic is the JAX op's uint32/int32, wrapping alike.
//
// What bounds it on this card: latency. The decode of a row is a chain of
// n-1 dependent steps, each two bit reads (four word loads) and some 30
// integer operations, so a row of 128 values is ~4k dependent operations
// while its bytes are a few hundred. Design: one thread per row, 64 rows
// per block, so rows run side by side and the SMs hide one row's load
// latency behind the others'. The value lanes (T+2 per row) live in shared
// memory, transposed (lane-major, row-minor) so the 32 threads of a warp
// hit 32 banks whatever lanes they touch: (128+2) * 64 * 4 = 33,280 bytes
// at most, inside the 48 KB static limit. The stack lives in the thread's
// local memory (L1). The window words are read straight from device memory
// (L1-cached, 4 B a load). After the DFS the block writes its rows'
// outputs together, coalesced. No TMA, no wgmma: speed is later work.

#include "common.cuh"

namespace {

// block tile field columns (ds2i_tpu/engine/block_tiles.py)
constexpr int BF_W0 = 1, BF_EX_W0 = 4, BF_BOFF = 5, F_BASE = 8, F_NVALS = 9,
              N_FIELDS = 11;
constexpr int kRows = 64;   // rows per block, one thread each
constexpr int kDepth = 8;   // DFS stack depth for <= 128 values (interp_device.DEPTH)
constexpr int kMaxT = 128;

using ds2i::load_word;

// width (<= 31) bits at bit pos of the row's W-word window
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ words,
                                              long long nw, long long w0, int W,
                                              int pos, int width) {
  const int wi = pos >> 5;
  const uint32_t s = static_cast<uint32_t>(pos & 31);
  const uint32_t a = (wi >= 0 && wi < W) ? load_word(words, nw, w0 + wi) : 0u;
  const uint32_t c = (wi + 1 >= 0 && wi + 1 < W) ? load_word(words, nw, w0 + wi + 1) : 0u;
  const uint32_t x = (a >> s) | (s > 0 ? c << (32u - s) : 0u);
  const uint32_t mask = width >= 32 ? 0xFFFFFFFFu : (1u << (width < 0 ? 0 : width)) - 1u;
  return x & mask;
}

__global__ void __launch_bounds__(kRows)
interp_decode_kernel(const uint32_t* __restrict__ words, long long nw,
                     const int* __restrict__ fld, int R, int W, int T,
                     int is_docs, int num_docs, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* vals = smem;  // lane l of row t at vals[l * kRows + t], l < T + 2
  int* s_n = smem + (T + 2) * kRows;
  int* s_base = s_n + kRows;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int r = r0 + t;
  const int VW = T + 2;  // [global-low = 0, cum[0..T-1], pad]

  for (int l = 0; l < VW; ++l) vals[l * kRows + t] = 0;
  int n = 0, base = 0;
  if (r < R) {
    const int* f = fld + static_cast<size_t>(r) * N_FIELDS;
    n = f[F_NVALS];
    base = f[F_BASE];
    const long long w0 = f[BF_W0];
    if (n >= 0 && n < VW) vals[n * kRows + t] = f[BF_EX_W0];

    int lo_s[kDepth], hi_s[kDepth];
    lo_s[0] = 0;
    hi_s[0] = n - 1;
    int sp = n > 1 ? 1 : 0;
    int bitpos = f[BF_BOFF];
    auto lane = [&](int l) { return (l >= 0 && l < VW) ? vals[l * kRows + t] : 0; };

    for (int step = 0; step < T - 1 && sp > 0; ++step) {
      const int idx = sp - 1;
      const int lo = idx < kDepth ? lo_s[idx] : 0;
      const int hi = idx < kDepth ? hi_s[idx] : 0;
      const int sp1 = sp - 1;

      const int h = lo + (hi - lo) / 2;  // hi >= lo: / is the JAX floor division
      const int low = lane(lo);          // cum[lo-1]
      const int high = lane(hi + 1);     // cum[hi]
      const uint32_t u = static_cast<uint32_t>(high) - static_cast<uint32_t>(low) + 1u;
      const int b = 31 - __clz(u > 1u ? u : 1u);
      const uint32_t m = (b + 1 >= 32 ? 0u : (1u << (b + 1))) - u;

      const uint32_t x = read_bits(words, nw, w0, W, bitpos, b);
      const int bp1 = bitpos + b;
      const uint32_t extra = read_bits(words, nw, w0, W, bp1, 1);
      const bool wide = x >= m;
      const uint32_t code = wide ? (x << 1) + extra - m : x;
      bitpos = bp1 + (wide ? 1 : 0);

      const int hv = h + 1;
      if (hv >= 0 && hv < VW) {
        vals[hv * kRows + t] = static_cast<int>(static_cast<uint32_t>(low) + code);
      }

      // push right child (h+1, hi) then left (lo, h); left pops first;
      // a push past the stack's depth is dropped, as in the JAX op
      int sp2 = sp1;
      if (hi - h - 1 > 0) {
        if (sp2 < kDepth) { lo_s[sp2] = h + 1; hi_s[sp2] = hi; }
        ++sp2;
      }
      int sp3 = sp2;
      if (h - lo > 0) {
        if (sp3 < kDepth) { lo_s[sp3] = lo; hi_s[sp3] = h; }
        ++sp3;
      }
      sp = sp3;
    }
  }
  s_n[t] = n;
  s_base[t] = base;
  __syncthreads();

  // the block's rows, written together: consecutive threads, consecutive slots
  const int rows = R - r0 < kRows ? R - r0 : kRows;
  const int pad = is_docs ? num_docs : 0;
  for (int i = t; i < rows * T; i += kRows) {
    const int rr = i / T;
    const int j = i - rr * T;
    const uint32_t cum = static_cast<uint32_t>(vals[(j + 1) * kRows + rr]);
    uint32_t v;
    if (is_docs) {
      v = static_cast<uint32_t>(s_base[rr]) + cum + static_cast<uint32_t>(j);
    } else {
      const uint32_t prev = j > 0 ? static_cast<uint32_t>(vals[j * kRows + rr]) : 0u;
      v = cum - prev + 1u;
    }
    out[static_cast<size_t>(r0 + rr) * T + j] = j < s_n[rr] ? static_cast<int>(v) : pad;
  }
}

}  // namespace

// Decode one stream of R rows of an ("interp", W, T) group into out (R, T)
// int32. unused must be 0 (the launch ABI of the block kernels). Launches
// on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int ds2i_interp_decode(const void* words, long long nw, const void* fld,
                                  int R, int W, int unused, int T, int is_docs,
                                  int num_docs, void* out, void* stream) {
  if (T < 1 || T > kMaxT || W < 1 || unused != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (static_cast<size_t>(T + 2) * kRows + 2 * kRows) * sizeof(int);
  const dim3 grid((R + kRows - 1) / kRows);
  interp_decode_kernel<<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld), R, W, T,
      is_docs, num_docs, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
