// Helpers shared by the port's kernels. Each csrc/*.cu is built into a
// shared library of its own (ds2i_torch/kernels.py), so the C entry point
// below is defined once in each library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ds2i {

// word i of the stream, the index clamped to [0, nw - 1] like the JAX
// package's window gathers (the pad tile reads word 0, a window past the
// stream's end its last word)
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              long long nw, long long i) {
  i = i < 0 ? 0 : (i > nw - 1 ? nw - 1 : i);
  return __ldg(words + i);
}

// asynchronous copy of the 4 bytes at src into shared memory at dst;
// completes at cp_async_wait_all
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// asynchronous copy of word i of the stream (clamped as load_word) into
// shared memory at dst; completes at cp_async_wait_all
__device__ __forceinline__ void cp_async_word(uint32_t* dst, const uint32_t* __restrict__ words,
                                              long long nw, long long i) {
  i = i < 0 ? 0 : (i > nw - 1 ? nw - 1 : i);
  cp_async_4(dst, words + i);
}

// wait for every cp.async this thread issued; the caller then syncs the
// threads that read the copied words (__syncwarp or __syncthreads)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// the part-level decode (csrc/pair_decode.cu, csrc/optpfor_decode.cu,
// csrc/varint_decode.cu, csrc/qmx_decode.cu, csrc/interp_decode.cu)
//
// A launch covers every group of one kernel in one stream of a part (pair
// mode: both streams of a part). Its CTA table holds one entry per CTA,
// int32 [p1, p2, T, row0, nrows, blk0]: the group's statics (EF pair: W,
// WL; OptPFor: b, E; Varint-G8IU: G, 0; QMX: NI, S; interpolative: W, 0),
// the tile width T, the CTA's first row in the part's row-to-tile map
// `gtile` (int64), its row count (never straddling two groups) and the
// output block of its first row;
// row r of the CTA writes blocks [blk0 + r * bpt, + bpt), bpt =
// max(T / 32, 1), of 32 slots each.
constexpr int kCtaFields = 6;
enum CtaField { kCtaP1 = 0, kCtaP2 = 1, kCtaT = 2, kCtaRow0 = 3, kCtaNRows = 4, kCtaBlk0 = 5 };

// what a launch writes (the `mode` argument)
enum Mode {
  kFreqs = 0,        // out: raw freqs, pads 0 (int32 blocks, freqs order)
  kDocs = 1,         // out: docids, pads num_docs (int32 blocks, docs order)
  kDocsPresence = 2, // kDocs, and w: 1.0 where doc < num_docs, else 0
  kDocsBm25 = 3,     // kDocs, and w: f / (f + den) where doc < num_docs, else 0
};

// the weight of a docs-order slot holding doc (modes kDocsPresence and
// kDocsBm25): f is the slot's raw freq (read from the freqs-order blocks
// at blkperm of its block), den its norm-cache denominator (block
// tile_gblk0[tile] + k of den_blocks); one IEEE f32 add and one IEEE f32
// divide, rounded to nearest, as the plain version computes them
__device__ __forceinline__ float slot_weight(int mode, int doc, int num_docs, float f, float den) {
  if (doc >= num_docs) return 0.0f;
  if (mode != kDocsBm25) return 1.0f;
  return __fdiv_rn(f, __fadd_rn(f, den));
}

// an inclusive warp scan of x (every lane of the warp takes part)
__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// the tail of a full-block row, one warp a row (K1): lane l holds
// v[it], the raw value of slot it * 32 + l (a gap for docs, freq - 1 for
// freqs), and the warp writes the row's four 32-slot blocks from blk0 —
//   freqs   v + 1, slots >= nvals 0;
//   docs    *base - 1 + the inclusive prefix sum of v + 1 (a warp scan
//           with a carry across the four blocks), slots >= nvals num_docs;
//   weights (modes kDocsPresence, kDocsBm25) slot_weight, f read from the
//           freqs-order blocks at blkperm of each block, den from block
//           tile_gblk0[tile] + it of den_blocks.
// uint32 arithmetic, wrapping as the JAX engine's int32 does.
__device__ __forceinline__ void write_full_block_row(
    const uint32_t (&v)[4], int lane, int mode, int num_docs, int nvals, const int* base,
    long long blk0, long long tile, int* __restrict__ out, float* __restrict__ w_out,
    const int* __restrict__ freq, const long long* __restrict__ blkperm,
    const float* __restrict__ den_blocks, const long long* __restrict__ tile_gblk0) {
  if (mode == kFreqs) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int j = it * 32 + lane;
      out[(blk0 + it) * 32 + lane] = j < nvals ? static_cast<int>(v[it] + 1u) : 0;
    }
    return;
  }
  const long long den_blk0 = mode == kDocsBm25 ? tile_gblk0[tile] : 0;
  uint32_t carry = static_cast<uint32_t>(*base) - 1u;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const uint32_t t = warp_inclusive_scan(v[it] + 1u, lane) + carry;
    carry = __shfl_sync(0xFFFFFFFFu, t, 31);
    const int j = it * 32 + lane;
    const int doc = j < nvals ? static_cast<int>(t) : num_docs;
    out[(blk0 + it) * 32 + lane] = doc;
    if (mode != kDocs) {
      float fv = 0.0f, den = 0.0f;
      if (mode == kDocsBm25) {
        fv = __int2float_rn(freq[blkperm[blk0 + it] * 32 + lane]);
        den = den_blocks[(den_blk0 + it) * 32 + lane];
      }
      w_out[(blk0 + it) * 32 + lane] = slot_weight(mode, doc, num_docs, fv, den);
    }
  }
}

// whether p lies off a 16-byte boundary (NULL does not)
__host__ __device__ inline bool misaligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// The tail of a full-block row with its loads made ahead (K7, K8): lane
// l holds v[k], the raw value of slot 4 l + k (k < 4: four consecutive
// slots, column 4 (l & 7) of the row's block l >> 3), and moves 16-byte
// vectors; the warp writes the row's four 32-slot blocks from blk0 as
// write_full_block_row does, slot for slot and bit for bit. Every pointer
// it reads or writes by vector lies on a 16-byte boundary (the wrappers
// check).
//
// prefetch_row_tail issues the tail's loads that do not depend on the
// decoded values, right after the row's CTA entry and map entry, so that
// they overlap the decode: in mode kDocsBm25 the raw freqs of the lane's
// four slots (row blkperm[blk0 + (l >> 3)] of freq, which needs only the
// CTA entry) and their dens (row tile_gblk0[tile] + (l >> 3) of
// den_blocks); nothing in the other modes. They stay in registers.
struct RowTail {
  int4 f;
  float4 den;
};

__device__ __forceinline__ RowTail prefetch_row_tail(
    int mode, int lane, long long blk0, long long tile, const int* __restrict__ freq,
    const long long* __restrict__ blkperm, const float* __restrict__ den_blocks,
    const long long* __restrict__ tile_gblk0) {
  RowTail t = {};
  if (mode != kDocsBm25) return t;
  const int col = 4 * (lane & 7);
  const long long fblk = __ldg(blkperm + blk0 + (lane >> 3));
  const long long dblk = __ldg(tile_gblk0 + tile) + (lane >> 3);
  t.f = __ldg(reinterpret_cast<const int4*>(freq + fblk * 32 + col));
  t.den = __ldg(reinterpret_cast<const float4*>(den_blocks + dblk * 32 + col));
  return t;
}

// write_full_block_row's slots from v and the prefetched tail, the row's
// F_BASE field passed by value: freqs v + 1 (0 past nvals); docs base - 1
// + the inclusive prefix sum of v + 1 (the lane's four, then one warp
// scan of the lanes' sums; uint32, wrapping as the JAX engine's int32
// does), num_docs past nvals; weights slot_weight with the same
// __int2float_rn, __fadd_rn and __fdiv_rn.
__device__ __forceinline__ void write_prefetched_block_row(
    const uint32_t (&v)[4], int lane, int mode, int num_docs, int nvals, int base,
    long long blk0, int* __restrict__ out, float* __restrict__ w_out, const RowTail& tail) {
  const long long at = (blk0 + (lane >> 3)) * 32 + 4 * (lane & 7);
  const int j = 4 * lane;  // the lane's first slot
  if (mode == kFreqs) {
    *reinterpret_cast<int4*>(out + at) = make_int4(
        j < nvals ? static_cast<int>(v[0] + 1u) : 0, j + 1 < nvals ? static_cast<int>(v[1] + 1u) : 0,
        j + 2 < nvals ? static_cast<int>(v[2] + 1u) : 0, j + 3 < nvals ? static_cast<int>(v[3] + 1u) : 0);
    return;
  }
  const uint32_t s0 = v[0] + 1u, s1 = s0 + v[1] + 1u, s2 = s1 + v[2] + 1u, s3 = s2 + v[3] + 1u;
  const uint32_t before = static_cast<uint32_t>(base) - 1u + warp_inclusive_scan(s3, lane) - s3;
  const int d0 = j < nvals ? static_cast<int>(before + s0) : num_docs;
  const int d1 = j + 1 < nvals ? static_cast<int>(before + s1) : num_docs;
  const int d2 = j + 2 < nvals ? static_cast<int>(before + s2) : num_docs;
  const int d3 = j + 3 < nvals ? static_cast<int>(before + s3) : num_docs;
  *reinterpret_cast<int4*>(out + at) = make_int4(d0, d1, d2, d3);
  if (mode == kDocs) return;
  const bool bm25 = mode == kDocsBm25;
  auto weight = [&](int doc, int f, float den) {
    return slot_weight(mode, doc, num_docs, bm25 ? __int2float_rn(f) : 0.0f, bm25 ? den : 0.0f);
  };
  *reinterpret_cast<float4*>(w_out + at) = make_float4(
      weight(d0, tail.f.x, tail.den.x), weight(d1, tail.f.y, tail.den.y),
      weight(d2, tail.f.z, tail.den.z), weight(d3, tail.f.w, tail.den.w));
}

}  // namespace ds2i

extern "C" const char* ds2i_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
