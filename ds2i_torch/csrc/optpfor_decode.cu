// OptPFor full-block decode for Hopper (sm_90a): K1.
//
// Replaces the jnp device op ds2i_tpu/ops/optpfor_device.py:optpfor_decode
// on the path the JAX engine takes for block indexes (b_static, with
// resident exception patches: ex_patch=True, or no exceptions: E = 0),
// together with the assembly and pad mask of
// ds2i_tpu/engine/resident.py:_decode_block_stream ("opt", "optp") and
// _decode_doc_group_blocks / _decode_freq_group_blocks. One launch decodes
// one stream of one ("opt"|"optp", b, E, 128) group:
//   slots   the 128 b-bit fields at (BF_W0, BF_BOFF) of the u32 stream;
//   patches OR in the sum of the row's first min(n_ex, E) resident patch
//           pairs (slot position, high << b) read at BF_EX_BASE + 2e
//           (built once at engine init by build_exception_patches);
//   docs    F_BASE - 1 + inclusive prefix sum of (raw + 1);
//   freqs   raw + 1;
//   pads    slots j >= n_vals give num_docs (docs) or 0 (freqs).
// Every slot equals ds2i_torch/ops/block_decode.py:block_stream_torch bit
// for bit; all arithmetic is uint32, wrapping as the JAX op's int32 does.
//
// What bounds it on this card: memory. A row reads about 4b + 8 n_ex
// bytes of stream and 44 bytes of fields and writes 512 bytes; the integer
// work is a few shifts per slot. Design: one warp per row, 4 rows per
// block. Lane l decodes slots l, l+32, l+64, l+96, reading the two words
// that straddle each slot straight from device memory (neighbouring lanes
// read neighbouring words, so the loads coalesce) with indices clamped to
// [0, nw-1] as the JAX gathers clamp them. The patch pairs are summed into
// 128 words of shared memory per warp (atomicAdd, so even repeated
// positions give the JAX op's sum), then ORed in. The docs prefix sum is a
// warp scan with a carry across the four 32-slot steps. Writes are one
// coalesced 128-byte line per step. No TMA, no wgmma: speed is later work.

#include "common.cuh"

namespace {

// block tile field columns (ds2i_tpu/engine/block_tiles.py)
constexpr int BF_W0 = 1, BF_NEX = 3, BF_BOFF = 5, BF_EX_BASE = 7, F_BASE = 8,
              F_NVALS = 9, N_FIELDS = 11;
constexpr int kT = 128;      // slots per full block
constexpr int kSteps = kT / 32;
constexpr int kWarps = 4;    // rows per block, one warp each
constexpr unsigned kFull = 0xFFFFFFFFu;

using ds2i::load_word;

__global__ void __launch_bounds__(kWarps * 32)
optpfor_decode_kernel(const uint32_t* __restrict__ words, long long nw,
                      const int* __restrict__ fld, int R, int b, int E,
                      int is_docs, int num_docs, int* __restrict__ out) {
  __shared__ uint32_t s_patch[kWarps][kT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // warp-uniform; only __syncwarp below

  const int* f = fld + static_cast<size_t>(r) * N_FIELDS;
  const long long w0 = f[BF_W0];
  const int boff = f[BF_BOFF];
  const int nvals = f[F_NVALS];
  const int bs = b < 32 ? b : 32;
  const uint32_t bmask = bs >= 32 ? kFull : (1u << bs) - 1u;

  uint32_t v[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int j = it * 32 + lane;
    uint32_t x = 0;
    if (bs > 0) {
      // the slot's bits start at bit boff + j*bs of word w0
      const long long bit = static_cast<long long>(boff) + static_cast<long long>(j) * bs;
      const long long wi = w0 + (bit >> 5);
      const uint32_t sh = static_cast<uint32_t>(bit & 31);
      const uint32_t lo = load_word(words, nw, wi);
      const uint32_t hi = load_word(words, nw, wi + 1);
      x = ((lo >> sh) | (sh > 0 ? hi << (32u - sh) : 0u)) & bmask;
    }
    v[it] = x;
    s_patch[warp][j] = 0u;
  }

  if (E > 0) {
    const int nex = f[BF_NEX];
    const int ne = nex < E ? nex : E;
    const long long exb = f[BF_EX_BASE];
    const long long pmax = nw - 2 > 0 ? nw - 2 : 0;
    __syncwarp();
    for (int e = lane; e < ne; e += 32) {
      long long pi = exb + 2LL * e;
      pi = pi < 0 ? 0 : (pi > pmax ? pmax : pi);
      const int pos = static_cast<int>(load_word(words, nw, pi));
      const uint32_t add = load_word(words, nw, pi + 1);
      if (pos >= 0 && pos < kT) atomicAdd(&s_patch[warp][pos], add);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kSteps; ++it) v[it] |= s_patch[warp][it * 32 + lane];
  }

  int* row = out + static_cast<size_t>(r) * kT;
  if (is_docs) {
    uint32_t carry = static_cast<uint32_t>(f[F_BASE]) - 1u;
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      uint32_t t = v[it] + 1u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t += y;
      }
      t += carry;
      carry = __shfl_sync(kFull, t, 31);
      const int j = it * 32 + lane;
      row[j] = j < nvals ? static_cast<int>(t) : num_docs;
    }
  } else {
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const int j = it * 32 + lane;
      row[j] = j < nvals ? static_cast<int>(v[it] + 1u) : 0;
    }
  }
}

}  // namespace

// Decode one stream of R rows of an ("opt"|"optp", b, E, 128) group into
// out (R, 128) int32. The T argument must be 128 (the wrapper checks it).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int ds2i_optpfor_decode(const void* words, long long nw, const void* fld,
                                   int R, int b, int E, int T, int is_docs,
                                   int num_docs, void* out, void* stream) {
  if (T != kT || b < 0 || b > 32 || E < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((R + kWarps - 1) / kWarps);
  optpfor_decode_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld), R, b, E,
      is_docs, num_docs, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
