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
// (common.cuh write_prefetched_block_row). Every slot equals
// ds2i_torch/ops/block_decode.py:split_decode_part_torch bit for bit.
//
// The lane table (ops/block_decode.py:qmx_lane_words, built from
// codecs/qmx.py) is an int32 array uploaded once per device: word 256 t +
// j packs LANE_TABLE[t, j] a byte a field, word 256 * 15 + t packs
// INTS_OF_TYPE[t] | ADV_OF_TYPE[t] << 16. 15 KB, read through __ldg; each
// warp copies only the 15 meta words into shared memory.
//
// What bounds it on this card: the latency of each row's work and the
// launches, not its bytes. A ranked pass launches K8 14 times (a freqs and
// a docs launch a part) of about 500 CTAs each, under one wave, for about
// 5.5 MB each (a row reads its payload, 150-500 bytes for 128 values, its
// selectors, 32 bytes of fields, and for BM25 weights 512 bytes each of
// freqs and den rows; it writes 512 bytes, 1,024 with w): 1.6 us of bytes
// a launch. The first design took 10 us a launch, and the same launches
// cut to their first CTA 61% of that (chip_smoke.py's chain line on an
// H100 at 700 W): one warp's chain, nine reads in series (CTA entry, map
// entry, fields, selectors, meta word, payload, lane table, then blkperm
// and tile_gblk0, then freq and den) and the instructions between them,
// sets the time. Timed cut-down copies showed the decode's instructions
// and the tail as large as the reads, so the design cuts both.
//
// Design: one warp per row, kWarps rows per CTA, every CTA inside one
// group. Each row's dependent reads are cut to four rounds before its
// decode: (1) the CTA entry; (2) the map entry gtile[row], the blkperm
// entry of the lane's block (it needs only the CTA entry) and a cp.async
// of the lane table's meta words; (3) the fields, tile_gblk0[tile] and the
// lane's four freqs (common.cuh prefetch_row_tail, kept in registers); (4)
// one cp.async round for the block's words from the payload's first word
// through the word after its last selector byte (the reference format puts
// the selectors right after the payload; at most stage_words(NI, S) words,
// 1,064 bytes), and the lane's four dens. After the one wait the decode
// keeps to registers, shuffles and the stage: NI and S are at most 32, so
// lane s reads selector s and lane i owns instance i; a warp scan of the
// batches gives the coverage ends, and instance i's selector is the count
// of ends at or below i (one __reduce_or_sync of a bit a selector, one
// __popc); two warp scans give the instances' first outputs and payload
// bytes. Lane l decodes slots 4 l .. 4 l + 3, which share one instance
// (every class holds a multiple of 4 values): the count of instance starts
// at or below quad l (again a mask and a __popc), its type, first output
// and payload byte by shuffle, one 16-byte read of four lane entries (the
// one dependent global read left, an L1 or L2 hit), two extracts a slot
// from the stage, unchecked where the lane's reach lies inside it (every
// well formed block); a word outside the stage (a bucketed NI past ninst,
// a malformed block) is read from the stream, clamped as the stage is. The
// tail writes the lane's four slots as one 16-byte vector a plane after
// one warp scan (common.cuh write_prefetched_block_row). No TMA: rows
// start at any byte and move under 1.1 KB, below what a bulk copy's
// 16-byte alignment and setup repay. No wgmma: there is no matrix product.

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

// words staged from the payload's first word: a block of NI instances
// (at most 32 payload bytes each) and S selectors, from byte 0..3 of its
// first word, spans at most stage_words(NI, S) words through the word
// after its last selector byte (the one extract's high half may read)
__host__ __device__ constexpr int stage_words(int ni, int s) { return (2 + 32 * ni + s) / 4 + 2; }
constexpr int kStage = stage_words(kMaxNI, kMaxS);  // 266

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
  __shared__ uint32_t s_blk[kWarps][kStage];  // payload then selectors, from BF_W0
  __shared__ uint32_t s_meta[kWarps][kTypes + 1];  // INTS_OF_TYPE | ADV_OF_TYPE << 16
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* cta = table + static_cast<size_t>(blockIdx.x) * ds2i::kCtaFields;
  if (warp >= cta[ds2i::kCtaNRows]) return;  // warp-uniform; only __syncwarp below
  const int NI = max(1, min(cta[ds2i::kCtaP1], kMaxNI));
  const int S = max(0, min(cta[ds2i::kCtaP2], kMaxS));
  const long long row = static_cast<long long>(cta[ds2i::kCtaRow0]) + warp;
  const long long blk0 = static_cast<long long>(cta[ds2i::kCtaBlk0]) + static_cast<long long>(warp) * kSteps;

  // step 2 of the chain: the row's map entry, the tail's blkperm entries
  // and the lane table's meta words, all at once; step 3: its fields, its
  // tile_gblk0 entry and freqs
  if (lane < kTypes) ds2i::cp_async_4(&s_meta[warp][lane], lane_tab + kTypes * kLanes + lane);
  const long long tile = gtile[row];
  const ds2i::RowTail tail = ds2i::prefetch_row_tail(mode, lane, blk0, tile, freq, blkperm,
                                                     den_blocks, tile_gblk0);
  const int* f = fld + static_cast<size_t>(tile) * N_FIELDS;
  const long long pay_w0 = f[BF_W0];
  const long long pay_boff = f[BF_BOFF];
  const int ninst = f[BF_B];
  const int nsel = f[BF_NEX];
  const long long sel_w0 = f[BF_EX_W0];
  const int sel_b = f[BF_EX_BOFF];
  const int base = f[F_BASE];
  const int nvals = f[F_NVALS];

  // step 4: the block's words, payload through the word after its last
  // selector byte, in one cp.async round (clamped to the stream as
  // load_word clamps; capped by the group's NI and S)
  const int nstage = static_cast<int>(
      max(0LL, min(static_cast<long long>(stage_words(NI, S)), sel_w0 - pay_w0 + 2)));
  for (int k = lane; k < nstage; k += 32) cp_async_word(&s_blk[warp][k], words, nw, pay_w0 + k);
  cp_async_wait_all();
  __syncwarp();

  // word pay_w0 + k of the stream, clamped: staged, or read from the
  // stream where a bucketed NI past ninst or a malformed block reads
  // outside the block
  auto word_at = [&](long long k) -> uint32_t {
    return k >= 0 && k < nstage ? s_blk[warp][k] : load_word(words, nw, pay_w0 + k);
  };

  // lane s: selector s, walking back from the block's last byte
  int stype = 0, batch = 0;
  if (lane < S && lane < nsel) {
    const int bk = sel_b - lane;
    const uint32_t wsel = word_at(sel_w0 - pay_w0 + (bk >> 2));
    const uint32_t sel = (wsel >> ((bk & 3) * 8)) & 0xFFu;
    stype = static_cast<int>(sel >> 4);
    batch = 16 - static_cast<int>(sel & 15u);
  }
  // selector s covers instances [cover[s-1], cover[s]); the covers of the
  // min(S, nsel) read selectors rise (a batch is 1..16), so instance i's
  // selector, the first s < S with cover[s] > i, is the count of covers
  // at or below i: bit cover[s] of one warp-wide mask
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const uint32_t cover = ds2i::warp_inclusive_scan(static_cast<uint32_t>(batch), lane);
  const uint32_t cover_bits =
      __reduce_or_sync(kFull, batch > 0 && cover < 32 ? 1u << cover : 0u);
  const int sel_of = __popc(cover_bits & ((2u << lane) - 1u));

  // lane i: instance i's type, outputs and payload bytes, and exclusive
  // scans of the last two for its first output and payload byte
  const int stype_of = __shfl_sync(kFull, stype, sel_of & 31);
  const int itype = lane < NI && sel_of < S ? stype_of : 0;
  const bool ivalid = lane < NI && lane < ninst;
  const uint32_t meta = ivalid ? s_meta[warp][min(itype, kTypes - 1)] : 0u;
  const uint32_t ints = meta & 0xFFFFu, adv = meta >> 16;
  const uint32_t ibase = ds2i::warp_inclusive_scan(ints, lane) - ints;
  const uint32_t ipbyte = ds2i::warp_inclusive_scan(adv, lane) - adv;

  // `width` bits at bit `bitoff` of the payload (all 32 bits for 32);
  // `staged`: the caller knows both words lie in the stage
  auto extract = [&](long long bitoff, int width, bool staged) -> uint32_t {
    const long long k = bitoff >> 5;
    const uint32_t sh = static_cast<uint32_t>(bitoff & 31);
    const uint32_t lo = staged ? s_blk[warp][k] : word_at(k);
    const uint32_t hi = staged ? s_blk[warp][k + 1] : word_at(k + 1);
    const uint32_t x = (lo >> sh) | (sh > 0 ? hi << (32u - sh) : 0u);
    return width >= 32 ? x : x & ((1u << width) - 1u);
  };

  // lane l decodes slots 4 l .. 4 l + 3. Every class's INTS_OF_TYPE is a
  // multiple of 4, so the first outputs of the valid instances are too and
  // rise, the four slots share one instance (the valid instances whose
  // first output is at or before slot 4 l, minus one, clipped at 0: the
  // count of set bits at or below l of a mask of first outputs / 4) and
  // read four consecutive lane entries: one 16-byte read of the table, or
  // four clamped ones where they pass its 256th entry
  const uint32_t start_bits =
      __reduce_or_sync(kFull, ivalid && ibase < kT ? 1u << (ibase >> 2) : 0u);
  const int inst = max(__popc(start_bits & ((2u << lane) - 1u)) - 1, 0);
  const int type = __shfl_sync(kFull, itype, inst);
  const int j = 4 * lane - static_cast<int>(__shfl_sync(kFull, ibase, inst));
  const uint32_t* row_tab = lane_tab + min(type, kTypes - 1) * kLanes;
  uint32_t e[kSteps];
  if (j + 3 < kLanes) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row_tab + j));
    e[0] = q.x, e[1] = q.y, e[2] = q.z, e[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) e[k] = __ldg(row_tab + min(j + k, kLanes - 1));
  }
  // the lane's extracts start at most `reach` bits past its instance's
  // first bit; where they and the words after them lie in the stage (every
  // well formed block) they read it unchecked
  const long long bits = pay_boff + 8LL * __shfl_sync(kFull, ipbyte, inst);
  int reach = 0;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    reach = max(reach, static_cast<int>(e[k] & 0xFF));
    if (e[k] >> 24) reach = max(reach, static_cast<int>((e[k] >> 16) & 0xFF));
  }
  const bool staged = bits >= 0 && ((bits + reach) >> 5) + 1 < nstage;
  uint32_t v[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int ba = e[k] & 0xFF, wa = (e[k] >> 8) & 0xFF, bb = (e[k] >> 16) & 0xFF, wb = e[k] >> 24;
    uint32_t x = extract(bits + ba, wa, staged);
    if (wb > 0) x |= extract(bits + bb, wb, staged) << min(wa, 31);
    v[k] = type == 0 ? 1u : x;
  }
  ds2i::write_prefetched_block_row(v, lane, mode, num_docs, nvals, base, blk0, out, w_out, tail);
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
  if (ds2i::misaligned16(out) || ds2i::misaligned16(w) || ds2i::misaligned16(freq) ||
      ds2i::misaligned16(den_blocks) || ds2i::misaligned16(lane_tab)) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // the 16-byte vectors of the tail
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
