// Block-max metadata pass for Hopper (sm_90a): K5, one launch per chunk of
// 32-slot rows.
//
// Replaces the tail of the jnp device op
// ds2i_tpu/engine/resident.py:_decode_slots_step (dmax, dmin) and
// _slots_weight_step (the per-block max doc-term weight and the weight
// plane), which both of the JAX engine's metadata passes run: the decode
// pass (_ensure_blockmax) and the collection pass (build_blockmax). Per
// row of 32 slots, with valid = doc < num_docs:
//   wmax  max over valid slots of w, 0 where no slot is valid;
//   dmax  max over valid slots of doc, -1 where no slot is valid;
//   dmin  doc of slot 0 (a block's first, smallest docid).
// Two input forms, one entry point:
//   rows   (norm_den NULL) docs and w as a part's docs launch wrote them
//          (pair mode's w is unmasked, so the kernel masks it by valid);
//   planes (norm_den given) docs and raw freqs of the collection's slot
//          planes; w = slot_weight(kDocsBm25, doc, num_docs, f,
//          norm_den[clamp(doc)]), the one __fadd_rn and one __fdiv_rn the
//          decode kernels use, so the block maxima equal the served
//          weights bit for bit; the w plane is written too.
// Every output equals ds2i_torch/ops/blockmax.py:blockmax_rows_torch bit
// for bit.
//
// What bounds it on this card: memory. A row reads 256 bytes (docs and w or
// freqs) and writes 12 (planes form: 140, with its 128 bytes of w; its den
// reads gather from norm_den, which the 50 MB L2 holds). Design: one warp
// per row, a lane per slot, so each warp reads one coalesced 128-byte line
// per plane; the f32 maximum of values >= 0 by five shuffles, the int32
// maximum by __reduce_max_sync, slot 0's doc by one shuffle; lane 0 writes
// the row's three values.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per CTA, one warp each
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarps * 32)
blockmax_kernel(const int* __restrict__ docs, const float* __restrict__ vals,
                const float* __restrict__ norm_den, long long rows, int num_docs,
                float* __restrict__ wmax, int* __restrict__ dmax, int* __restrict__ dmin,
                float* __restrict__ w_plane) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const long long i = row * 32 + lane;
  const int doc = __ldg(docs + i);
  const float v = __ldg(vals + i);
  const bool valid = doc < num_docs;
  float w;
  if (norm_den != nullptr) {
    const int c = doc < 0 ? 0 : (doc > num_docs - 1 ? num_docs - 1 : doc);
    w = ds2i::slot_weight(ds2i::kDocsBm25, doc, num_docs, v, __ldg(norm_den + c));
    w_plane[i] = w;
  } else {
    w = valid ? v : 0.0f;
  }
  float m = w;  // every weight is >= +0.0, so fmaxf picks one of them exactly
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const int dm = __reduce_max_sync(kFull, valid ? doc : -1);
  const int d0 = __shfl_sync(kFull, doc, 0);
  if (lane == 0) {
    wmax[row] = m;
    dmax[row] = dm;
    dmin[row] = d0;
  }
}

}  // namespace

extern "C" int ds2i_blockmax_rows(const void* docs, const void* vals, const void* norm_den,
                                  long long rows, int num_docs, void* wmax, void* dmax,
                                  void* dmin, void* w_plane, void* stream) {
  if (rows < 0 || docs == nullptr || vals == nullptr || wmax == nullptr || dmax == nullptr ||
      dmin == nullptr || (norm_den != nullptr && (w_plane == nullptr || num_docs < 1)) ||
      (rows + kWarps - 1) / kWarps > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  blockmax_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(docs), static_cast<const float*>(vals),
      static_cast<const float*>(norm_den), rows, num_docs, static_cast<float*>(wmax),
      static_cast<int*>(dmax), static_cast<int*>(dmin), static_cast<float*>(w_plane));
  return static_cast<int>(cudaGetLastError());
}
