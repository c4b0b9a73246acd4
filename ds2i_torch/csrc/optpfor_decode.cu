// OptPFor full-block decode for Hopper (sm_90a): K1, one launch per stream
// of a part.
//
// Replaces the jnp device op ds2i_tpu/ops/optpfor_device.py:optpfor_decode
// on the path the JAX engine takes for block indexes (b_static, with
// resident exception patches: ex_patch=True, or no exceptions: E = 0),
// together with the assembly and pad mask of
// ds2i_tpu/engine/resident.py:_decode_block_stream ("opt", "optp") and
// _decode_doc_group_blocks / _decode_freq_group_blocks, and, in the docs
// stream, the freq realign (blkperm), the norm-cache den rows and the
// weight of _decode_weight_blocks' split branch. One launch decodes every
// ("opt"|"optp", b, E, 128) group of one stream of a part, as its CTA
// table (common.cuh) lists them:
//   slots   the 128 b-bit fields at (BF_W0, BF_BOFF) of the u32 stream;
//   patches OR in the sum of the row's first min(n_ex, E) resident patch
//           pairs (slot position, high << b) read at BF_EX_BASE + 2e
//           (built once at engine init by build_exception_patches);
//   docs    F_BASE - 1 + inclusive prefix sum of (raw + 1);
//   freqs   raw + 1;
//   pads    slots j >= n_vals give num_docs (docs) or 0 (freqs);
//   weights (docs, modes kDocsPresence / kDocsBm25) slot_weight.
// Every slot equals ds2i_torch/ops/block_decode.py:split_decode_part_torch
// bit for bit; all integer arithmetic is uint32, wrapping as the JAX op's
// int32 does.
//
// What bounds it on this card: memory, and the launch. A row reads about
// 4b + 8 n_ex bytes of stream, 44 bytes of fields and (ranked docs) 512
// bytes each of freqs and den rows, and writes 512 bytes (1,024 with w).
// Design: one warp per row, kWarps rows per CTA, every CTA inside one
// group (b and E come from the table). The warp stages the row's slot
// words and its patch pairs in shared memory with cp.async (4-byte copies:
// the rows' word cursors have no alignment), then lane l decodes slots l,
// l+32, l+64, l+96 from shared memory with the clamped indices of the
// stream (a word past the staged window is read from the stream). The
// patch pairs are summed into 128 words of shared memory per warp
// (atomicAdd, so even repeated positions give the JAX op's sum), then ORed
// in. The docs prefix sum is a warp scan with a carry across the four
// 32-slot steps. Writes are one coalesced 128-byte line per step and
// plane. No TMA (rows are unaligned and under 1 KB), no wgmma.

#include "common.cuh"

namespace {

// block tile field columns (ds2i_torch/engine/block_tiles.py)
constexpr int BF_W0 = 1, BF_NEX = 3, BF_BOFF = 5, BF_EX_BASE = 7, F_BASE = 8,
              F_NVALS = 9, N_FIELDS = 11;
constexpr int kT = 128;       // slots per full block
constexpr int kSteps = kT / 32;
constexpr int kWarps = 8;     // rows per CTA, one warp each
constexpr int kStage = 130;   // staged slot words: (31 + 128 * 32) / 32 + 2
constexpr int kMaxE = 128;    // patch capacity (block_tiles._E_BUCKETS)
constexpr unsigned kFull = 0xFFFFFFFFu;

using ds2i::cp_async_wait_all;
using ds2i::cp_async_word;
using ds2i::load_word;

__global__ void __launch_bounds__(kWarps * 32)
optpfor_part_kernel(const uint32_t* __restrict__ words, long long nw,
                    const int* __restrict__ fld, const long long* __restrict__ gtile,
                    const int* __restrict__ table, int mode, int num_docs,
                    int* __restrict__ out, float* __restrict__ w_out,
                    const int* __restrict__ freq, const long long* __restrict__ blkperm,
                    const float* __restrict__ den_blocks,
                    const long long* __restrict__ tile_gblk0) {
  __shared__ uint32_t s_word[kWarps][kStage];
  __shared__ uint32_t s_pair[kWarps][2 * kMaxE];
  __shared__ uint32_t s_patch[kWarps][kT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* cta = table + static_cast<size_t>(blockIdx.x) * ds2i::kCtaFields;
  if (warp >= cta[ds2i::kCtaNRows]) return;  // warp-uniform; only __syncwarp below
  const int b = cta[ds2i::kCtaP1];
  const int E = cta[ds2i::kCtaP2];
  const long long row = static_cast<long long>(cta[ds2i::kCtaRow0]) + warp;
  const long long blk0 = static_cast<long long>(cta[ds2i::kCtaBlk0]) + static_cast<long long>(warp) * kSteps;
  const long long tile = gtile[row];

  const int* f = fld + static_cast<size_t>(tile) * N_FIELDS;
  const long long w0 = f[BF_W0];
  const int boff = f[BF_BOFF];
  const int nvals = f[F_NVALS];
  const int bs = b < 32 ? b : 32;
  const uint32_t bmask = bs >= 32 ? kFull : (1u << bs) - 1u;
  int ne = 0;
  long long exb = 0;
  if (E > 0) {
    const int nex = f[BF_NEX];
    ne = nex < E ? nex : E;
    ne = ne < kMaxE ? ne : kMaxE;
    exb = f[BF_EX_BASE];
  }

  // stage the slot words the row's bits span and its patch pairs
  const long long last_bit = static_cast<long long>(boff) + static_cast<long long>(kT - 1) * bs;
  const int nstage = bs > 0 && boff >= 0
      ? static_cast<int>(min(static_cast<long long>(kStage), (last_bit >> 5) + 2)) : 0;
  for (int i = lane; i < nstage; i += 32) cp_async_word(&s_word[warp][i], words, nw, w0 + i);
  const long long pmax = nw - 2 > 0 ? nw - 2 : 0;
  for (int e = lane; e < ne; e += 32) {
    long long pi = exb + 2LL * e;
    pi = pi < 0 ? 0 : (pi > pmax ? pmax : pi);
    cp_async_word(&s_pair[warp][2 * e], words, nw, pi);
    cp_async_word(&s_pair[warp][2 * e + 1], words, nw, pi + 1);
  }
#pragma unroll
  for (int it = 0; it < kSteps; ++it) s_patch[warp][it * 32 + lane] = 0u;
  cp_async_wait_all();
  __syncwarp();

  uint32_t v[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int j = it * 32 + lane;
    uint32_t x = 0;
    if (bs > 0) {
      // the slot's bits start at bit boff + j*bs of word w0
      const long long bit = static_cast<long long>(boff) + static_cast<long long>(j) * bs;
      const long long k = bit >> 5;
      const uint32_t sh = static_cast<uint32_t>(bit & 31);
      const uint32_t lo = k >= 0 && k < nstage ? s_word[warp][k] : load_word(words, nw, w0 + k);
      const uint32_t hi = k + 1 >= 0 && k + 1 < nstage ? s_word[warp][k + 1]
                                                       : load_word(words, nw, w0 + k + 1);
      x = ((lo >> sh) | (sh > 0 ? hi << (32u - sh) : 0u)) & bmask;
    }
    v[it] = x;
  }
  if (ne > 0) {
    for (int e = lane; e < ne; e += 32) {
      const int pos = static_cast<int>(s_pair[warp][2 * e]);
      if (pos >= 0 && pos < kT) atomicAdd(&s_patch[warp][pos], s_pair[warp][2 * e + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kSteps; ++it) v[it] |= s_patch[warp][it * 32 + lane];
  }

  ds2i::write_full_block_row(v, lane, mode, num_docs, nvals, f + F_BASE, blk0, tile, out, w_out,
                             freq, blkperm, den_blocks, tile_gblk0);
}

}  // namespace

// Decode every ("opt"|"optp", b, E, 128) group of one stream of a part:
// n_cta CTA-table entries (common.cuh), each of at most 8 rows. fld is the
// stream's resident field table, gtile the part's row-to-tile map (int64)
// of the same stream. mode (common.cuh Mode) picks what is written: out
// (int32 blocks of 32 slots) and, for the weighted docs modes, w (f32,
// same blocks); kDocsBm25 reads freq (the part's freqs-order int32
// blocks), blkperm (int64), den_blocks (f32 blocks) and tile_gblk0
// (int64). max_w and max_t must be 0 and 128. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
extern "C" int ds2i_optpfor_decode_part(
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
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  optpfor_part_kernel<<<n_cta, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld),
      static_cast<const long long*>(gtile), static_cast<const int*>(table), mode, num_docs,
      static_cast<int*>(out), static_cast<float*>(w), static_cast<const int*>(freq),
      static_cast<const long long*>(blkperm), static_cast<const float*>(den_blocks),
      static_cast<const long long*>(tile_gblk0));
  return static_cast<int>(cudaGetLastError());
}
