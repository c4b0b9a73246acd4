// QMX full-block decode for Hopper (sm_90a): K8, one launch per stream of a
// part.
//
// Replaces the jnp device op ds2i_tpu/ops/qmx_device.py:qmx_decode on the
// JAX engine's split-mode path (ds2i_tpu/engine/resident.py:
// _decode_block_stream, "qmx"), together with the assembly and pad mask of
// _decode_doc_group_blocks / _decode_freq_group_blocks and, in the docs
// stream, the freq realign (blkperm), the norm-cache den rows and the
// weight of _decode_weight_blocks' split branch. One launch decodes every
// ("qmx", NI, S, 128) group of one stream of a part, as its CTA table
// (common.cuh) lists them. A block in the reference byte format is a run
// of payload instances (16 or 32 bytes each, 256 bits of packed values)
// followed by its selector bytes in reverse; the row's fields give the
// payload cursor (BF_W0, BF_BOFF), the instance count (BF_B), the word and
// byte of the block's last byte, its first selector (BF_EX_W0,
// BF_EX_BOFF), and the selector count (BF_NEX). As in the JAX op:
//   selectors  s < min(nsel, S), byte sel_b - s from word sel_w0: type
//              sel >> 4, batch 16 - (sel & 15) instances;
//   instances  i < NI takes the type of the selector whose batch covers
//              it; i < ninst also takes INTS_OF_TYPE outputs and
//              ADV_OF_TYPE payload bytes; exclusive scans give each its
//              first output and payload byte;
//   slots      v finds its instance (clip(valid instances starting at or
//              before v, minus one, to [0, NI - 1])), reads its lane entry
//              (bitoff_a, width_a, bitoff_b, width_b) of LANE_TABLE at
//              (type, v - first output clipped to 0..255) and takes bits_a
//              | bits_b << width_a from the payload; type 0 gives 1; a type
//              past the table clamps to its last class, as XLA's gather.
// Word indices are clamped to the stream. Then the full-block tail
// (common.cuh write_full_block_row). Every slot equals
// ds2i_torch/ops/block_decode.py:split_decode_part_torch bit for bit.
//
// The lane table (ops/block_decode.py:qmx_lane_words, built from
// codecs/qmx.py) is an int32 array uploaded once per device: word 256 t +
// j packs LANE_TABLE[t, j] a byte a field, word 256 * 15 + t packs
// INTS_OF_TYPE[t] | ADV_OF_TYPE[t] << 16. 15 KB, read through __ldg.
//
// What bounds it on this card: memory, and the launch. A row reads its
// payload (16 bytes an instance, 32 for the two-word classes; 150-500
// bytes for 128 values), its selectors, 28 bytes of fields and (ranked
// docs) 512 bytes each of freqs and den rows, and writes 512 bytes (1,024
// with w). Design: one warp per row, kWarps rows per CTA, every CTA inside
// one group. NI and S are at most 32, so lane s reads selector s and lane
// i owns instance i: a warp scan of the batches gives the coverage ends,
// a 5-step search over them gives each instance its type, and two warp
// scans give the output and payload bases, kept in shared memory. The
// payload (at most 32 x 32 bytes) is staged with cp.async. Lane l then
// decodes slots l, l + 32, l + 64 and l + 96: a 5-step search over the
// output bases, one lane-table word, two extracts from the staged
// payload. No TMA (rows are unaligned and under 1 KB), no wgmma.

#include "common.cuh"

namespace {

// block tile field columns (ds2i_torch/engine/block_tiles.py)
constexpr int BF_W0 = 1, BF_B = 2, BF_NEX = 3, BF_EX_W0 = 4, BF_BOFF = 5, BF_EX_BOFF = 6,
              F_BASE = 8, F_NVALS = 9, N_FIELDS = 11;
constexpr int kT = 128;       // slots per full block
constexpr int kSteps = kT / 32;
constexpr int kWarps = 8;     // rows per CTA, one warp each
constexpr int kMaxNI = 32;    // instances a block reads at most (block_tiles._NW_BUCKETS)
constexpr int kMaxS = 32;     // selectors a block reads at most (block_tiles._S_BUCKETS)
constexpr int kTypes = 15;    // width classes (codecs/qmx.py)
constexpr int kLanes = 256;   // lane entries a class
constexpr int kPayStage = (24 + 8 * 32 * kMaxNI) / 32 + 2;  // payload words staged: 258

using ds2i::cp_async_wait_all;
using ds2i::cp_async_word;
using ds2i::load_word;

__global__ void __launch_bounds__(kWarps * 32)
qmx_part_kernel(const uint32_t* __restrict__ words, long long nw,
                const int* __restrict__ fld, const long long* __restrict__ gtile,
                const int* __restrict__ table, int mode, int num_docs,
                int* __restrict__ out, float* __restrict__ w_out,
                const int* __restrict__ freq, const long long* __restrict__ blkperm,
                const float* __restrict__ den_blocks,
                const long long* __restrict__ tile_gblk0,
                const uint32_t* __restrict__ lane_tab) {
  __shared__ uint32_t s_pay[kWarps][kPayStage];
  __shared__ int s_cover[kWarps][kMaxS];  // selector s covers instances [cover[s-1], cover[s])
  __shared__ int s_stype[kWarps][kMaxS];
  __shared__ int s_base[kWarps][kMaxNI];  // instance i: first output slot
  __shared__ int s_pbyte[kWarps][kMaxNI];  // instance i: first payload byte
  __shared__ int s_itype[kWarps][kMaxNI];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* cta = table + static_cast<size_t>(blockIdx.x) * ds2i::kCtaFields;
  if (warp >= cta[ds2i::kCtaNRows]) return;  // warp-uniform; only __syncwarp below
  const int NI = max(1, min(cta[ds2i::kCtaP1], kMaxNI));
  const int S = max(0, min(cta[ds2i::kCtaP2], kMaxS));
  const long long row = static_cast<long long>(cta[ds2i::kCtaRow0]) + warp;
  const long long blk0 = static_cast<long long>(cta[ds2i::kCtaBlk0]) + static_cast<long long>(warp) * kSteps;
  const long long tile = gtile[row];

  const int* f = fld + static_cast<size_t>(tile) * N_FIELDS;
  const long long pay_w0 = f[BF_W0];
  const long long pay_boff = f[BF_BOFF];
  const int ninst = f[BF_B];
  const int nsel = f[BF_NEX];
  const long long sel_w0 = f[BF_EX_W0];
  const int sel_b = f[BF_EX_BOFF];
  const int nvals = f[F_NVALS];

  // lane s: selector s, walking back from the block's last byte
  int stype = 0, batch = 0;
  if (lane < S && lane < nsel) {
    const int bk = sel_b - lane;
    const uint32_t wsel = load_word(words, nw, sel_w0 + (bk >> 2));
    const uint32_t sel = (wsel >> ((bk & 3) * 8)) & 0xFFu;
    stype = static_cast<int>(sel >> 4);
    batch = 16 - static_cast<int>(sel & 15u);
  }
  const int cover = static_cast<int>(ds2i::warp_inclusive_scan(static_cast<uint32_t>(batch), lane));
  s_cover[warp][lane] = cover;
  s_stype[warp][lane] = stype;
  __syncwarp();

  // lane i: instance i's type (the selector s with cover[s-1] <= i <
  // cover[s], the first s < S with cover[s] > i), outputs and payload bytes
  int itype = 0;
  if (lane < NI) {
    int lo = 0, hi = S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cover[warp][mid] <= lane) lo = mid + 1; else hi = mid;
    }
    if (lo < S) itype = s_stype[warp][lo];
  }
  const bool ivalid = lane < NI && lane < ninst;
  const uint32_t meta = ivalid ? __ldg(lane_tab + kTypes * kLanes + min(itype, kTypes - 1)) : 0u;
  const uint32_t ints = meta & 0xFFFFu, adv = meta >> 16;
  const uint32_t ints_incl = ds2i::warp_inclusive_scan(ints, lane);
  const uint32_t adv_incl = ds2i::warp_inclusive_scan(adv, lane);
  const uint32_t pay_bytes = __shfl_sync(0xFFFFFFFFu, adv_incl, 31);
  if (lane < NI) {
    s_base[warp][lane] = static_cast<int>(ints_incl - ints);
    s_pbyte[warp][lane] = static_cast<int>(adv_incl - adv);
    s_itype[warp][lane] = itype;
  }

  // the payload words its instances span, clamped to the stream
  const long long pay_end = (pay_boff + 8LL * pay_bytes) >> 5;
  const int nstage = static_cast<int>(min(static_cast<long long>(kPayStage), pay_end + 2));
  for (int k = lane; k < nstage; k += 32) cp_async_word(&s_pay[warp][k], words, nw, pay_w0 + k);
  cp_async_wait_all();
  __syncwarp();

  // `width` bits at bit `bitoff` of the payload (all 32 bits for 32)
  auto extract = [&](long long bitoff, int width) -> uint32_t {
    const long long k = bitoff >> 5;
    const uint32_t sh = static_cast<uint32_t>(bitoff & 31);
    const uint32_t lo = k >= 0 && k < nstage ? s_pay[warp][k] : load_word(words, nw, pay_w0 + k);
    const uint32_t hi = k + 1 >= 0 && k + 1 < nstage ? s_pay[warp][k + 1]
                                                     : load_word(words, nw, pay_w0 + k + 1);
    const uint32_t x = (lo >> sh) | (sh > 0 ? hi << (32u - sh) : 0u);
    return width >= 32 ? x : x & ((1u << width) - 1u);
  };

  const int nvalid = max(0, min(ninst, NI));
  uint32_t v[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int slot = it * 32 + lane;
    // valid instances whose first output is at or before the slot
    int lo = 0, hi = nvalid;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_base[warp][mid] <= slot) lo = mid + 1; else hi = mid;
    }
    const int inst = lo - 1 < 0 ? 0 : lo - 1;
    const int type = s_itype[warp][inst];
    const int j = min(max(slot - s_base[warp][inst], 0), kLanes - 1);
    const uint32_t e = __ldg(lane_tab + min(type, kTypes - 1) * kLanes + j);
    const int ba = e & 0xFF, wa = (e >> 8) & 0xFF, bb = (e >> 16) & 0xFF, wb = e >> 24;
    const long long bits = pay_boff + 8LL * s_pbyte[warp][inst];
    uint32_t x = extract(bits + ba, wa);
    if (wb > 0) x |= extract(bits + bb, wb) << min(wa, 31);
    v[it] = type == 0 ? 1u : x;
  }
  ds2i::write_full_block_row(v, lane, mode, num_docs, nvals, f + F_BASE, blk0, tile, out, w_out,
                             freq, blkperm, den_blocks, tile_gblk0);
}

}  // namespace

// Decode every ("qmx", NI, S, 128) group of one stream of a part: n_cta
// CTA-table entries (common.cuh), each of at most 8 rows, NI and S at most
// 32. The arguments are those of ds2i_optpfor_decode_part
// (csrc/optpfor_decode.cu) and the device's lane table (int32, 15 * 256 +
// 15 words) before the stream; max_w and max_t must be 0 and 128.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int ds2i_qmx_decode_part(
    const void* words, long long nw, const void* fld, const void* gtile, const void* table,
    int n_cta, int max_w, int max_t, int mode, int num_docs, void* out, void* w,
    const void* freq, const void* blkperm, const void* den_blocks, const void* tile_gblk0,
    const void* lane_tab, void* stream) {
  if (n_cta < 0 || max_w != 0 || max_t != kT || mode < ds2i::kFreqs || mode > ds2i::kDocsBm25 ||
      out == nullptr || lane_tab == nullptr || (mode >= ds2i::kDocsPresence && w == nullptr) ||
      (mode == ds2i::kDocsBm25 && (freq == nullptr || blkperm == nullptr ||
                                   den_blocks == nullptr || tile_gblk0 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cta == 0) return static_cast<int>(cudaGetLastError());
  qmx_part_kernel<<<n_cta, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, static_cast<const int*>(fld),
      static_cast<const long long*>(gtile), static_cast<const int*>(table), mode, num_docs,
      static_cast<int*>(out), static_cast<float*>(w), static_cast<const int*>(freq),
      static_cast<const long long*>(blkperm), static_cast<const float*>(den_blocks),
      static_cast<const long long*>(tile_gblk0), static_cast<const uint32_t*>(lane_tab));
  return static_cast<int>(cudaGetLastError());
}
