// Varint-G8IU full-block decode for Hopper (sm_90a): K7, one launch per
// stream of a part.
//
// Replaces the jnp device op ds2i_tpu/ops/varint_device.py:varint_decode on
// the JAX engine's split-mode path (ds2i_tpu/engine/resident.py:
// _decode_block_stream, "var"), together with the assembly and pad mask of
// _decode_doc_group_blocks / _decode_freq_group_blocks and, in the docs
// stream, the freq realign (blkperm), the norm-cache den rows and the
// weight of _decode_weight_blocks' split branch. One launch decodes every
// ("var", G, 128) group of one stream of a part (block_varint, and the
// VARINT blocks of block_mixed), as its CTA table (common.cuh) lists them.
// A row's block starts at bit BF_BOFF of word BF_W0 and holds BF_B groups
// of 9 bytes: a descriptor byte whose bit i marks data byte i as the last
// byte of an integer, then 8 data bytes (integers never span groups;
// unused trailing bytes have no end bit). Only groups g < G count; the
// JAX op gathers the (9G + 7) / 4 + 2 words from BF_W0 with clamped
// indices, and the kernel reads those of them its groups reach. An
// integer's value is the sum of its bytes
// shifted by 8 * (place in the integer), a place of 4 or more adding 0 (an
// XLA shift of 32 bits or more gives 0); slots no integer reaches are 0.
// Then the full-block tail (common.cuh write_prefetched_block_row): docs
// F_BASE - 1 + prefix sum of (raw + 1), freqs raw + 1, pads, weights.
// Every slot equals ds2i_torch/ops/block_decode.py:split_decode_part_torch
// bit for bit.
//
// What bounds it on this card: the latency of each row's work and the
// launches, not its bytes. A ranked pass launches K7 14 times (a freqs and
// a docs launch a part) of about 500 CTAs each, under one wave, for about
// 5.7 MB each (a row reads about 9 * ngroups bytes of stream, 150-300 for
// 128 values, 20 bytes of fields, and for BM25 weights 512 bytes each of
// freqs and den rows; it writes 512 bytes, 1,024 with w): 1.7 us of bytes
// a launch. The first design took 7.5 us a launch, and the same launches
// cut to their first CTA 59% of that (chip_smoke.py's chain line on an
// H100 at 700 W): one warp's chain, six reads in series (CTA entry, map
// entry, fields, window, then blkperm and tile_gblk0, then freq and den)
// and the decode and tail between them, sets the time.
//
// Design: one warp per row, kWarps rows per CTA, every CTA inside one
// group, and each row's dependent reads cut to four rounds before its
// decode: (1) the CTA entry; (2) the map entry gtile[row] and the blkperm
// entry of the lane's block; (3) the fields, tile_gblk0[tile] and the
// lane's four freqs (common.cuh prefetch_row_tail, kept in registers);
// (4) the window by cp.async (4-byte copies: the block cursors have no
// alignment), only the words its min(ngroups, G) groups reach, and the
// lane's four dens. Lane l owns groups l and l + 32: it popcounts its
// descriptor, an exclusive warp scan with a carry over the two halves
// gives each group's first output index, and the lane assembles its
// group's integers in registers and stores each, once, into the warp's
// 128-word row in shared memory (zeroed first). The tail then reads slots
// 4 l .. 4 l + 3 from that row as one 16-byte vector and writes them as
// one a plane after one warp scan (common.cuh write_prefetched_block_row).
// No TMA: rows start at any byte and move under 600 bytes, below what a
// bulk copy's 16-byte alignment and setup repay. No wgmma: there is no
// matrix product.

#include "common.cuh"

namespace {

// block tile field columns (ds2i_torch/engine/block_tiles.py)
constexpr int BF_W0 = 1, BF_B = 2, BF_BOFF = 5, F_BASE = 8, F_NVALS = 9, N_FIELDS = 11;
constexpr int kT = 128;       // slots per full block
constexpr int kSteps = kT / 32;
constexpr int kWarps = 8;     // rows per CTA, one warp each
constexpr int kMaxG = 64;     // groups a block reads at most (block_tiles._G_BUCKETS)
constexpr int kWin = ((9 * kMaxG - 1) >> 2) + 2;  // words a row stages at most: 145

using ds2i::cp_async_wait_all;
using ds2i::cp_async_word;

__global__ void __launch_bounds__(kWarps * 32)
varint_part_kernel(const uint32_t* __restrict__ words, long long nw,
                   const int* __restrict__ fld, const long long* __restrict__ gtile,
                   const int* __restrict__ table, int mode, int num_docs,
                   int* __restrict__ out, float* __restrict__ w_out,
                   const int* __restrict__ freq, const long long* __restrict__ blkperm,
                   const float* __restrict__ den_blocks,
                   const long long* __restrict__ tile_gblk0) {
  __shared__ uint32_t s_win[kWarps][kWin];
  __shared__ __align__(16) uint32_t s_val[kWarps][kT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* cta = table + static_cast<size_t>(blockIdx.x) * ds2i::kCtaFields;
  if (warp >= cta[ds2i::kCtaNRows]) return;  // warp-uniform; only __syncwarp below
  const int G = min(cta[ds2i::kCtaP1], kMaxG);
  const long long row = static_cast<long long>(cta[ds2i::kCtaRow0]) + warp;
  const long long blk0 = static_cast<long long>(cta[ds2i::kCtaBlk0]) + static_cast<long long>(warp) * kSteps;
  // step 2 of the chain: the row's map entry and the tail's blkperm
  // entries at once; step 3: its fields, its tile_gblk0 entry and freqs
  const long long tile = gtile[row];
  const ds2i::RowTail tail = ds2i::prefetch_row_tail(mode, lane, blk0, tile, freq, blkperm,
                                                     den_blocks, tile_gblk0);
  const int* f = fld + static_cast<size_t>(tile) * N_FIELDS;
  const long long w0 = f[BF_W0];
  const uint32_t s = static_cast<uint32_t>(f[BF_BOFF]);
  const int ngroups = f[BF_B];
  const int base = f[F_BASE];
  const int nvals = f[F_NVALS];

  // step 4: the window, its words clamped to the stream: the words the
  // row's ng = min(ngroups, G) groups reach, through the word after the
  // one holding byte 9 ng - 1, (9 ng - 1) / 4 + 2 of the (9G + 7) / 4 + 2
  // the JAX op gathers (the decode reads no other)
  const int ng = max(0, min(ngroups, G));
  const int nstage = ng > 0 ? ((9 * ng - 1) >> 2) + 2 : 0;
  for (int i = lane; i < nstage; i += 32) cp_async_word(&s_win[warp][i], words, nw, w0 + i);
  *reinterpret_cast<uint4*>(&s_val[warp][4 * lane]) = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait_all();
  __syncwarp();

  // byte k of the block: the window shifted down by s bits
  const uint32_t* win = s_win[warp];
  auto byte_at = [&](int k) -> uint32_t {
    const int q = k >> 2;
    const uint32_t a = (win[q] >> s) | (s > 0 ? win[q + 1] << (32u - s) : 0u);
    return (a >> (8 * (k & 3))) & 0xFFu;
  };

  uint32_t carry = 0;  // integers ended in the groups of earlier halves
#pragma unroll
  for (int h = 0; h < kMaxG / 32; ++h) {
    const int g = h * 32 + lane;
    const bool valid = g < G && g < ngroups;
    const uint32_t desc = valid ? byte_at(9 * g) : 0u;
    const uint32_t ends = __popc(desc);
    const uint32_t incl = ds2i::warp_inclusive_scan(ends, lane);
    uint32_t idx = carry + incl - ends;  // output index of the group's first integer
    carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
    if (valid) {
      uint32_t acc = 0;
      int place = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t d = byte_at(9 * g + 1 + i);
        if (place < 4) acc += d << (8 * place);
        if ((desc >> i) & 1u) {
          if (idx < kT) s_val[warp][idx] = acc;
          ++idx;
          acc = 0;
          place = 0;
        } else {
          ++place;
        }
      }
    }
  }
  __syncwarp();

  // lane l takes slots 4 l .. 4 l + 3 (common.cuh write_prefetched_block_row)
  const uint4 q = *reinterpret_cast<const uint4*>(&s_val[warp][4 * lane]);
  const uint32_t v[kSteps] = {q.x, q.y, q.z, q.w};
  ds2i::write_prefetched_block_row(v, lane, mode, num_docs, nvals, base, blk0, out, w_out, tail);
}

}  // namespace

// Decode every ("var", G, 128) group of one stream of a part: n_cta
// CTA-table entries (common.cuh), each of at most 8 rows, G <= 64. The
// arguments are those of ds2i_optpfor_decode_part (csrc/optpfor_decode.cu);
// max_w and max_t must be 0 and 128. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int ds2i_varint_decode_part(
    const void* words, long long nw, const void* fld, const void* gtile, const void* table,
    int n_cta, int max_w, int max_t, int mode, int num_docs, void* out, void* w,
    const void* freq, const void* blkperm, const void* den_blocks, const void* tile_gblk0,
    void* stream) {
  if (n_cta < 0 || max_w != 0 || max_t != kT || mode < ds2i::kFreqs || mode > ds2i::kDocsBm25 ||
      out == nullptr || (mode >= ds2i::kDocsPresence && w == nullptr) ||
      (mode == ds2i::kDocsBm25 && (freq == nullptr || blkperm == nullptr ||
                                   den_blocks == nullptr || tile_gblk0 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ds2i::misaligned16(out) || ds2i::misaligned16(w) || ds2i::misaligned16(freq) ||
      ds2i::misaligned16(den_blocks)) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // the 16-byte vectors of the tail
  }
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  varint_part_kernel<<<n_cta, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld),
      static_cast<const long long*>(gtile), static_cast<const int*>(table), mode, num_docs,
      static_cast<int*>(out), static_cast<float*>(w), static_cast<const int*>(freq),
      static_cast<const long long*>(blkperm), static_cast<const float*>(den_blocks),
      static_cast<const long long*>(tile_gblk0));
  return static_cast<int>(cudaGetLastError());
}
