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
// csrc/interp_decode.cu)
//
// A launch covers every group of one kernel in one stream of a part (pair
// mode: both streams of a part). Its CTA table holds one entry per CTA,
// int32 [p1, p2, T, row0, nrows, blk0]: the group's statics (EF pair: W,
// WL; OptPFor: b, E; interpolative: W, 0), the tile width T, the CTA's
// first row in the part's row-to-tile map `gtile` (int64), its row count
// (never straddling two groups) and the output block of its first row;
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

}  // namespace ds2i

extern "C" const char* ds2i_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
