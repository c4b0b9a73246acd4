// Batched EF-family segment decode for Hopper (sm_90a), K9: one launch
// decodes R segments into (rows, L_out) int32 output rows.
//
// Replaces ds2i_tpu/ops/decode.py:decode_rows (jit-compiled there as
// decode_segments_device), the decode of the JAX package's DeviceIndex and
// of its QueryEngine and FlatQueryEngine. Per segment r and slot
// j < n = min(n_vals, Lseg):
//   select  sel = the window bit (relative to sel_start) of the j-th one
//           among the bits [sel_start, sel_start + sel_len) of the W words
//           from sel_start >> 5 (indices clamped to the stream, as the JAX
//           gathers are); 0 where the window holds no j-th one;
//   low     the l-bit field at lb_start + j*l, a two-word funnel read
//           (clamped indices), masked to l bits (all 32 for l >= 32);
//   value   SEG_EF ((sel-j-1) << l) | low (the shift gives 0 for l >= 32),
//           SEG_EF_STRICT the same + j, SEG_RB sel, SEG_AO j, any other
//           kind 0; then + base; uint32 arithmetic, wrapping as XLA's
//           int32 does;
//   store   out[list_row][out_begin + j] (a negative index counts from the
//           end of the JAX op's (rows, L_out + 1) scatter target), only
//           inside the row and where the column is below L_out and below
//           list_n[list_row]. The wrapper fills `out` with the sentinel
//           first, so every other slot keeps it.
// Every slot equals ds2i_torch/ops/decode.py:decode_rows_torch bit for bit.
//
// What bounds it: not bytes (a segment of the 1x `opt` index holds 17.7
// values and moves ~130 B). The first design (a lane a window word, each
// lane storing its own word's ones one by one) made a segment wait on
// about 11 dependent reads: its fields, list_n behind list_row, the
// window, then a store loop where the lane holding most of the ones (79%
// of them in a sample: an EF segment's high bits crowd into one or two
// words) paid two low-bit loads a one in turn while 31 lanes waited.
//
// This design: a warp a segment, kWarps segments a CTA, the warps
// independent. A segment's reads come in two rounds:
//   1. its nine fields;
//   2. together: the window's first 32 words (a word a lane), its low-bit
//      words where their n*l bits span at most kStageWords words (a word a
//      lane: 17.7 x 8.8 bits ~ 5 words at 1x), and list_n[list_row], which
//      only gates the stores.
// No branch stands between the two rounds (ptxas sinks a load below an
// early exit that skips its use, which splits a round in two): a segment
// that writes nothing goes on with n = 0. Then the walk, 32 window words a
// step (the next step's words loaded before this step's work): lane w
// masks word w to the segment's bits and a warp scan of the popcounts
// ranks the step's ones. The step's ones are taken 32 ranks a round, a
// lane a rank: lane i takes rank r0 + i, finds its word by a 5-step binary
// search over the inclusive scan (__shfl_sync), its bit by the 5-step
// popcount search of the JAX tile decode, its two low words from the
// staged ones by shuffle, and stores its slot; consecutive lanes store
// consecutive columns. The ranks live in registers (the scan, one value a
// lane): a round needs nothing but the step's 32 words and their counts,
// so no buffer is sized by n, a dense ranked-bitvector step (up to 1,024
// ones) takes up to 32 rounds and a long segment (a plain `ef` list is one
// segment) goes step by step. Where the low bits span more than
// kStageWords words, a slot reads its two words from device memory, the
// 32 loads of a round together. The slots past the window's ones (sel =
// 0) are taken a lane a slot after the walk, in the same rounds. The walk
// stops at the window's last needed word, or once n ones are ranked.
// Offsets are 32-bit wherever the segment's shape bounds them (the staged
// low bits, the window's words, columns from a non-negative out_begin),
// and at most 51 registers a thread (kMinBlocks) hold 40 warps an SM with
// no spill.
//
// Measured on an H100 (PERF.md, section 6): with the chain at two rounds, the
// time is the warps' instructions (a segment's fields and offsets, a
// step's masks and scan, a round's search, select and store) more than
// their reads: neither 32 to 64 warps an SM nor three rounds to two
// moved it by more than 4%.

#include <climits>

#include "common.cuh"

namespace {

constexpr int SEG_EF = 0, SEG_EF_STRICT = 1, SEG_RB = 2, SEG_AO = 3;  // ops/segments.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 10;   // CTAs an SM: at most 51 registers a thread
constexpr int kStageWords = 32;  // the most low-bit words staged a lane a word
constexpr int kMaxW = 1 << 25;   // so that 32 * W fits in 32 bits
constexpr unsigned kFull = 0xFFFFFFFFu;

// (1 << h) - 1 for h clipped to [0, 32]; never shifts by 32
__device__ __forceinline__ uint32_t low_mask(int h) {
  return h >= 32 ? 0xFFFFFFFFu : (h <= 0 ? 0u : (1u << h) - 1u);
}

// word i of the stream, i clamped to [0, last] (last = min(nw - 1,
// INT_MAX): an int index clamps there as load_word clamps it to nw - 1)
__device__ __forceinline__ uint32_t load_word32(const uint32_t* __restrict__ words, int last,
                                                int i) {
  return __ldg(words + (i < 0 ? 0 : (i > last ? last : i)));
}

// the bit of the (rem+1)-th one of x by a branchless 5-step popcount
// search (31 where x holds rem or fewer ones past the steps' halves), as
// the JAX package's tile decode selects in a word
__device__ __forceinline__ int select_in_word(uint32_t x, int rem) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc(x & (((1u << width) - 1u) << pos));
    const bool right = rem >= c;
    rem -= right ? c : 0;
    pos += right ? width : 0;
  }
  return pos;
}

struct Segment {
  int kind, l, lb, ob, lim;
  uint32_t base;
  bool staged;   // low words held a word a lane in `lw`, word 0 at lb >> 5
  bool col32;    // ob + j lies in [0, INT_MAX] for every slot j < n
  int* orow;     // the segment's output row
};

// slot j = lane's value given its select bit `sel`, stored where the JAX
// op keeps it when `active`. Every lane of the warp calls it (shuffles).
// A staged segment's bits lie within 32 words of lb >> 5, so its offsets
// are 32-bit; the others take 64-bit offsets and device loads.
__device__ __forceinline__ void store_slot(const Segment& s, int j, int sel, bool active,
                                           uint32_t lw, const uint32_t* __restrict__ words,
                                           long long nw, int L_out) {
  const bool ef = s.kind == SEG_EF || s.kind == SEG_EF_STRICT;
  uint32_t w0 = 0, w1 = 0, sh = 0;
  if (ef && s.staged) {  // warp-uniform
    const int rb = (s.lb & 31) + j * s.l;  // the slot's bit from word lb >> 5
    sh = static_cast<uint32_t>(rb & 31);
    const int rel = rb >> 5;               // in [0, 31] where active
    w0 = __shfl_sync(kFull, lw, rel & 31);
    w1 = __shfl_sync(kFull, lw, (rel + 1) & 31);
    if (rel + 1 >= kStageWords) w1 = 0u;  // past the span: its bits are masked off
  }
  if (!active) return;
  int col;
  if (s.col32) {  // warp-uniform
    col = s.ob + j;
  } else {        // a negative index counts from the end
    long long c = static_cast<long long>(s.ob) + j;
    if (c < 0) c += static_cast<long long>(L_out) + 1;
    col = c < 0 || c >= s.lim ? -1 : static_cast<int>(c);
  }
  if (col < 0 || col >= s.lim) return;
  const bool wide = s.l >= 32 || s.l < 0;
  uint32_t val = 0;
  if (ef) {
    if (!s.staged) {
      const long long bit_off = s.lb + static_cast<long long>(j) * s.l;
      sh = static_cast<uint32_t>(bit_off & 31);
      w0 = ds2i::load_word(words, nw, bit_off >> 5);
      w1 = ds2i::load_word(words, nw, (bit_off >> 5) + 1);
    }
    const uint32_t low = ((w0 >> sh) | (sh > 0 ? w1 << (32u - sh) : 0u)) &
                         (wide ? 0xFFFFFFFFu : (1u << s.l) - 1u);
    const uint32_t high = static_cast<uint32_t>(sel - j - 1);
    val = (wide ? 0u : high << s.l) | low;
    if (s.kind == SEG_EF_STRICT) val += static_cast<uint32_t>(j);
  } else if (s.kind == SEG_RB) {
    val = static_cast<uint32_t>(sel);
  } else if (s.kind == SEG_AO) {
    val = static_cast<uint32_t>(j);
  }
  s.orow[col] = static_cast<int>(val + s.base);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_rows_kernel(const uint32_t* __restrict__ words, long long nw, int R,
                    const int* __restrict__ kind, const int* __restrict__ sel_start,
                    const int* __restrict__ sel_len, const int* __restrict__ lb_start,
                    const int* __restrict__ lower_bits, const int* __restrict__ n_vals,
                    const int* __restrict__ base, const int* __restrict__ out_begin,
                    const int* __restrict__ list_row, const int* __restrict__ list_n, int W,
                    int Lseg, int rows, int L_out, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // warp-uniform

  // round 1: the fields. No branch stands between this round and the
  // next: ptxas sinks a load below an early exit that skips its use, and
  // that would split a round into two. A segment that writes nothing goes
  // on with n = 0 and loads nothing more.
  Segment s;
  s.kind = __ldg(kind + r);
  const int start = __ldg(sel_start + r);
  const int slen = __ldg(sel_len + r);
  s.lb = __ldg(lb_start + r);
  s.l = __ldg(lower_bits + r);
  const int n0 = min(__ldg(n_vals + r), Lseg);
  s.base = static_cast<uint32_t>(__ldg(base + r));
  s.ob = __ldg(out_begin + r);
  int row = __ldg(list_row + r);
  if (row < 0) row += rows;
  const bool live = n0 > 0 && row >= 0 && row < rows;
  row = live ? row : 0;

  // the window: W words from word0, its bits [off, hi) relative to word0's
  // first bit; the walk covers the words that hold any of them (hi is
  // clipped to those words' 32 * nwin bits, which fit in 32 bits)
  const bool ef = s.kind == SEG_EF || s.kind == SEG_EF_STRICT;
  const bool windowed = ef || s.kind == SEG_RB;
  const int last = static_cast<int>(nw - 1 < INT_MAX ? nw - 1 : INT_MAX);
  const int word0 = start >> 5;
  const int off = start & 31;
  const long long hi = static_cast<long long>(off) + slen;
  const long long needed = live && windowed && slen > 0 ? (hi + 31) >> 5 : 0;
  const int nwin = static_cast<int>(needed < W ? needed : W);
  const int hi32 = static_cast<int>(hi < 32LL * nwin ? hi : 32LL * nwin);
  // the low bits: n*l bits from lb, staged where they span few words
  const long long nlw = ef && s.l >= 0
      ? ((s.lb & 31) + n0 * static_cast<long long>(s.l) + 31) >> 5 : 0;
  s.staged = live && ef && s.l >= 0 && nlw <= kStageWords;
  s.col32 = s.ob >= 0 && s.ob <= INT_MAX - max(n0, 0);

  // round 2: the window's first step, the low words and list_n together
  uint32_t win = lane < nwin ? load_word32(words, last, word0 + lane) : 0u;
  const uint32_t lw = s.staged && lane < nlw ? load_word32(words, last, (s.lb >> 5) + lane) : 0u;
  s.lim = min(L_out, __ldg(list_n + row));
  const int n = live && s.lim > 0 ? n0 : 0;  // the slots this segment writes
  s.orow = out + static_cast<long long>(row) * L_out;

  int before = 0;  // ones ranked in the earlier 32-word steps
  for (int c = 0; c < nwin && before < n; c += 32) {
    const int w = c + lane;
    // the next step's word, loaded before this step's work
    const uint32_t next = w + 32 < nwin ? load_word32(words, last, word0 + w + 32) : 0u;
    const uint32_t v = win & (low_mask(hi32 - 32 * w) & ~low_mask(off - 32 * w));
    const int pc = __popc(v);
    const int inc = static_cast<int>(ds2i::warp_inclusive_scan(static_cast<uint32_t>(pc), lane));
    const int tot = __shfl_sync(kFull, inc, 31);
    const int end = min(before + tot, n);
    for (int r0 = before; r0 < end; r0 += 32) {  // a lane a rank
      const int t = r0 + lane - before;           // the lane's rank among the step's ones
      int wi = 0;                                 // its word: the first with inc > t
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        if (__shfl_sync(kFull, inc, wi + d - 1) <= t) wi += d;
      }
      const uint32_t word = __shfl_sync(kFull, v, wi);
      const int excl = __shfl_sync(kFull, inc - pc, wi);
      const int sel = (c + wi) * 32 + select_in_word(word, t - excl) - off;
      store_slot(s, r0 + lane, sel, r0 + lane < end, lw, words, nw, L_out);
    }
    before += tot;
    win = next;
  }
  // slots past the window's ones read sel = 0, a lane a slot
  for (int j0 = before; j0 < n; j0 += 32) {
    store_slot(s, j0 + lane, 0, j0 + lane < n, lw, words, nw, L_out);
  }
}

}  // namespace

// Decode R segments (fields int32[R] each, list_n int32[rows]) from nw
// words into out, int32 (rows, L_out) already filled with the sentinel.
// 1 <= W <= 2^25 window words and Lseg >= 1 slots a segment, as the JAX
// op's statics. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int ds2i_segment_decode(const void* words, long long nw, int R, const void* kind,
                                   const void* sel_start, const void* sel_len,
                                   const void* lb_start, const void* lower_bits,
                                   const void* n_vals, const void* base, const void* out_begin,
                                   const void* list_row, const void* list_n, int W, int Lseg,
                                   int rows, int L_out, void* out, void* stream) {
  if (words == nullptr || nw < 1 || R < 0 || W < 1 || W > kMaxW || Lseg < 1 || rows < 1 ||
      L_out < 1 || out == nullptr || list_n == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(R) + kWarps - 1) / kWarps);
  segment_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, R, static_cast<const int*>(kind),
      static_cast<const int*>(sel_start), static_cast<const int*>(sel_len),
      static_cast<const int*>(lb_start), static_cast<const int*>(lower_bits),
      static_cast<const int*>(n_vals), static_cast<const int*>(base),
      static_cast<const int*>(out_begin), static_cast<const int*>(list_row),
      static_cast<const int*>(list_n), W, Lseg, rows, L_out, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's registers a thread, local (spilled) bytes a thread and
// static shared bytes a block, into attrs[0..2]; returns the CUDA error.
extern "C" int ds2i_segment_decode_attributes(int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, segment_rows_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.localSizeBytes);
  attrs[2] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
