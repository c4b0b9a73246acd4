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
// What bounds it: a segment's work is a chain of dependent steps (its
// fields, its window words, a scan of their popcounts, then the stores),
// and at the sizes of a query batch there are few bytes a segment. The
// design is the simple one: a warp a segment, kWarps segments a CTA, the
// warps independent. The warp walks the window 32 words at a time (lane w
// masks word w to the segment's bits, a warp scan of the popcounts ranks
// its ones), then each lane stores the values of the ones of its own word
// at their ranks, so a slot is written by the lane that holds its one and
// no search is needed; the slots past the window's ones (sel = 0) are
// written a lane a slot after the walk. The walk stops at the window's
// last needed word, or once n ones are ranked, so a segment of thousands
// of values (a plain `ef` list is one segment) costs its own window, not
// the W of the call.

#include "common.cuh"

namespace {

constexpr int SEG_EF = 0, SEG_EF_STRICT = 1, SEG_RB = 2, SEG_AO = 3;  // ops/segments.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// (1 << h) - 1 for h clipped to [0, 32]; never shifts by 32
__device__ __forceinline__ uint32_t low_mask(long long h) {
  return h >= 32 ? 0xFFFFFFFFu : (h <= 0 ? 0u : (1u << h) - 1u);
}

struct Segment {
  int kind, l, list_row;
  long long lb_start, out_begin;
  uint32_t base;
};

// slot j's value given its select bit `sel`, stored where the JAX op keeps it
__device__ __forceinline__ void store_slot(const Segment& s, long long j, long long sel,
                                           const uint32_t* __restrict__ words, long long nw,
                                           int L_out, int lim, int* __restrict__ out) {
  long long col = s.out_begin + j;
  if (col < 0) col += static_cast<long long>(L_out) + 1;
  if (col < 0 || col >= lim) return;
  const bool wide = s.l >= 32 || s.l < 0;
  uint32_t val = 0;
  if (s.kind == SEG_EF || s.kind == SEG_EF_STRICT) {
    const long long bit_off = s.lb_start + j * s.l;
    const long long w0i = bit_off >> 5;
    const uint32_t sh = static_cast<uint32_t>(bit_off & 31);
    const uint32_t w0 = ds2i::load_word(words, nw, w0i);
    const uint32_t w1 = ds2i::load_word(words, nw, w0i + 1);
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
  out[static_cast<long long>(s.list_row) * L_out + col] = static_cast<int>(val + s.base);
}

__global__ void __launch_bounds__(kThreads)
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
  const int n = min(n_vals[r], Lseg);
  int row = list_row[r];
  if (row < 0) row += rows;
  if (n <= 0 || row < 0 || row >= rows) return;
  const int lim = min(L_out, list_n[row]);
  if (lim <= 0) return;
  Segment s;
  s.kind = kind[r];
  s.l = lower_bits[r];
  s.list_row = row;
  s.lb_start = lb_start[r];
  s.out_begin = out_begin[r];
  s.base = static_cast<uint32_t>(base[r]);

  // the window: W words from word0, its bits [off, off + slen) relative to
  // word0's first bit; the walk covers the words that hold any of them
  const int start = sel_start[r];
  const long long slen = sel_len[r];
  const long long word0 = start >> 5;
  const long long off = start & 31;
  const long long needed = slen > 0 ? (off + slen + 31) >> 5 : 0;
  const long long nwin = needed < W ? needed : W;

  long long before = 0;  // ones ranked in the earlier 32-word steps
  for (long long c = 0; c < nwin && before < n; c += 32) {
    const long long w = c + lane;
    uint32_t v = 0;
    if (w < nwin) {
      v = ds2i::load_word(words, nw, word0 + w) &
          (low_mask(off + slen - 32 * w) & ~low_mask(off - 32 * w));
    }
    const int pc = __popc(v);
    int inc = pc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    // this lane's ones take ranks before + inc - pc, ... in bit order
    long long rank = before + inc - pc;
    while (v != 0u && rank < n) {
      const int b = __ffs(v) - 1;
      v &= v - 1u;
      store_slot(s, rank, w * 32 + b - off, words, nw, L_out, lim, out);
      ++rank;
    }
    before += __shfl_sync(kFull, inc, 31);
  }
  // slots past the window's ones read sel = 0
  for (long long j = before + lane; j < n; j += 32) {
    store_slot(s, j, 0, words, nw, L_out, lim, out);
  }
}

}  // namespace

// Decode R segments (fields int32[R] each, list_n int32[rows]) from nw
// words into out, int32 (rows, L_out) already filled with the sentinel.
// W >= 1 window words and Lseg >= 1 slots a segment, as the JAX op's
// statics. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int ds2i_segment_decode(const void* words, long long nw, int R, const void* kind,
                                   const void* sel_start, const void* sel_len,
                                   const void* lb_start, const void* lower_bits,
                                   const void* n_vals, const void* base, const void* out_begin,
                                   const void* list_row, const void* list_n, int W, int Lseg,
                                   int rows, int L_out, void* out, void* stream) {
  if (words == nullptr || nw < 1 || R < 0 || W < 1 || Lseg < 1 || rows < 1 || L_out < 1 ||
      out == nullptr || list_n == nullptr) {
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
