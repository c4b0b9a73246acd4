// The join and pack of a part for Hopper (sm_90a): K3, one launch per part.
//
// Replaces the jnp device ops ds2i_tpu/engine/resident.py:_join_bucket (a
// stable row sort by docid, shifted adds over runs of at most tmax equal
// docids, AND/OR flags, counts, top-k per row, one program per length
// bucket) and :_pack_rows (the buckets' real rows gathered, scaled by
// fscale and cast to f16). Every output equals
// ds2i_torch/ops/join.py:join_part_torch bit for bit.
//
// Per packed row (rows: [first entry, entries, tgt, first driving entry,
// driving entries]; qw: the row's tmax slot weights) the kernel reads the
// row's real directory entries ent = blk << 5 | slot and, for each
// driving entry, block blk of docs32 and w32 (32 slots, a lane each). The
// entries of a slot are contiguous and slots ascend along the row; within
// a slot the blocks' real docids strictly increase, each block holding
// its real docids first (slot 0 real) and its pads (num_docs) last.
//
// Two forms of the search, both in the JAX shifted-add order (each
// product a __fmul_rn and each add a __fadd_rn, never an FMA):
// - AND-only (ops == and: exhaustive ranked_and, and_skip, the AND
//   probe): the driving entries are the row's shortest slot's (the host
//   picks it; a row where a slot of 0 .. tgt-1 has no entry drives
//   nothing and writes -inf). A posting looks for its docid in the other
//   slots, tgt-1 down to 0, and stops at the first that lacks it; a docid
//   found in all is a candidate scored ((c[tgt-1] + c[tgt-2]) + ...) +
//   c[0], c[s] = w * qw[s].
// - General (counts, or): every entry drives. The run of a docid is owned
//   by its highest slot: a posting found in a higher slot is not a run's
//   owner; the owner adds the lower slots' c in descending slot order and
//   counts them. OR candidate: every owner; AND: an owner whose count is
//   tgt.
// A search of slot s: each live lane finds the slot's last entry whose
// first docid is <= its docid (a binary search over the first docids,
// staged in shared memory), then its docid in that block (a 5-step
// search: 5 dependent reads, L1 hits after the first where lanes share
// the block).
// Pads inside a slot's run (opt's tiles end inside lists) are > every
// real docid, so the search never finds them.
//
// Work sized to the row (the split is the host's, ops/join.py:JoinLayout):
// a row of few driving entries (2, set on the card) takes one warp (8
// rows a CTA), its entries staged in the warp's share of shared memory; a
// longer row takes CTA items of at most kChunk driving entries, warp i of
// the CTA driving entries i, i + 8, .... Nothing is filled or sorted
// ahead of the work.
// Top-k: for k <= 32 a warp keeps its list in registers, a value a lane,
// descending; a batch of 32 candidates (-inf elsewhere) that beats its
// k-th value is sorted across the lanes (a bitonic network of
// __shfl_xor_sync) and merged (elementwise max, then a half-cleaner); a
// CTA item merges its 8 warps' lists once. For k > 32 an item compacts
// its candidates into shared memory and sorts those alone. The items of
// a row of several write their counts and top-k lists to scratch and
// count their arrivals (one int per such row, the launch's own, zeroed on
// its stream before the kernel runs); the last to arrive sums the counts
// and merges the lists. Only values leave, so equal scores need no
// order. Output row:
// [and count, or count] (ops & kCounts), then the OR top-k, then the AND
// top-k; f16 (fetch16): __float2half_rn(__fmul_rn(x, fscale)), else f32.
//
// What bounds it on this card: the dependent reads of the searches, not
// bytes (a pass moves each real entry's 4 B and its block's 256 B, qw and
// tgt, the packed rows once). The AND-only form searches from the
// shortest slot alone (5.4x fewer postings than every slot at 1x) and
// stops at the first slot that lacks a docid; the warp rows leave no
// warp of a CTA idle on a 2-entry row; nothing is filled or sorted but
// candidates. No tensor-core or TMA path applies.

#include <cuda_fp16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;    // driving entries per CTA item at most (ops/join.py CHUNK)
constexpr int kStage = 2048;  // a CTA row's entries staged in shared memory up to this many
constexpr int kWarpStage = kStage / kWarps;  // a warp row's (ops/join.py WARP_STAGE)
constexpr int kWarpK = 32;    // k of a warp's register top-k at most (ops/join.py WARP_K)
enum Ops { kCounts = 1, kOr = 2, kAnd = 4 };

struct JoinArgs {
  const int* docs;
  const float* w;
  const int* ent;
  const int* rows;
  const float* qw;
  const int* items;
  const int* wrows;
  const int* merges;
  int* mcount;
  int n_items, n_wrows, num_docs, k, ops, tmax, stage, fetch16, width, nranked, sb;
  float fscale;
  void* out;
  float* sc_vals;
  int* sc_cnt;
};

// value x of column col of packed row `row`, cast for download
__device__ __forceinline__ void put(void* out, long long i, float x, int fetch16, float fscale) {
  if (fetch16) {
    static_cast<__half*>(out)[i] = __float2half_rn(__fmul_rn(x, fscale));
  } else {
    static_cast<float*>(out)[i] = x;
  }
}

// buf[0, n) sorted descending (n a power of two, every thread of the CTA
// calls it; the caller synced after filling buf)
__device__ void bitonic_desc(float* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const float a = buf[i], b = buf[j];
          if ((i & size) == 0 ? a < b : a > b) {
            buf[i] = b;
            buf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// a warp's running list `top` (a value a lane, descending) merged with 32
// ascending values: the elementwise max holds the 32 largest of both and
// is bitonic; a half-cleaner sorts it descending
__device__ __forceinline__ float topk_merge(float top, float v, int lane) {
  float m = fmaxf(top, v);
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {
    const float o = __shfl_xor_sync(kFull, m, st);
    m = (lane & st) ? fminf(m, o) : fmaxf(m, o);
  }
  return m;
}

// a batch v (a candidate or -inf a lane) into the running top-k list:
// nothing where no lane beats its k-th value, else v sorted ascending
// across the lanes by a bitonic network, then merged
__device__ __forceinline__ float topk_insert(float top, float v, int k, int lane) {
  const float kth = __shfl_sync(kFull, top, k - 1);
  if (!__any_sync(kFull, v > kth)) return top;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, st);
      const bool keep_min = ((lane & st) == 0) == ((lane & size) == 0);
      v = keep_min ? fminf(v, o) : fmaxf(v, o);
    }
  }
  return topk_merge(top, v, lane);
}

// the row's entries: from shared memory when staged, else device memory
struct RowEntries {
  const int* ent;      // the row's first entry
  const int* s_ent;    // staged entries, or nullptr
  const int* s_first;  // staged first docids
  const int* docs;

  __device__ __forceinline__ int entry(int p) const { return s_ent ? s_ent[p] : __ldg(ent + p); }
  __device__ __forceinline__ int first(int p) const {
    return s_ent ? s_first[p] : __ldg(docs + static_cast<long long>(entry(p) >> 5) * 32);
  }
};

// a warp's view of its row: lane s holds the row's first entry of a slot
// >= s and the query weight of slot s
struct Warp {
  RowEntries re;
  int nent, tgt, tmax, lane;
  int sb;
  float qw;

  __device__ __forceinline__ void init(const float* row_qw) {
    int lo = 0, n = nent;
    while (n > 0) {
      const int half = n >> 1;
      if ((re.entry(lo + half) & 31) < lane) {
        lo += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    sb = lo;
    qw = lane < tmax ? row_qw[lane] : 0.f;
  }
  // every lane calls these with the same s
  __device__ __forceinline__ int lo(int s) const { return __shfl_sync(kFull, sb, s); }
  __device__ __forceinline__ int hi(int s) const {
    const int b = __shfl_sync(kFull, sb, (s + 1) & 31);
    return s == 31 ? nent : b;
  }
  __device__ __forceinline__ float qws(int s) const { return __shfl_sync(kFull, qw, s); }
};

// each live lane's docid x in slot s: true and its weight where found
__device__ __forceinline__ bool search(const Warp& wp, const int* __restrict__ docs,
                                       const float* __restrict__ w, int x, bool live, int s,
                                       float& hw) {
  const int a = wp.lo(s), b = wp.hi(s);  // shuffles: every lane calls them
  hw = 0.f;
  if (!live) return false;
  int lo = a, n = b - a;  // lo: the slot's first entry whose first docid is > x
  while (n > 0) {
    const int half = n >> 1;
    if (wp.re.first(lo + half) <= x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  if (lo == a) return false;
  const long long base = static_cast<long long>(wp.re.entry(lo - 1) >> 5) * 32;
  int j = 0;  // the docids < x in the block (its 32 are non-decreasing)
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {
    if (__ldg(docs + base + j + st - 1) < x) j += st;
  }
  if (__ldg(docs + base + j) != x) return false;
  hw = __ldg(w + base + j);
  return true;
}

// the 32 postings of the row's entry e, a lane each: their OR and AND
// values (-inf where not a candidate) and flags
struct Drive {
  float or_v, and_v;
  bool is_or, is_and;
};

__device__ __forceinline__ Drive drive(const Warp& wp, const JoinArgs& a, int e, bool and_only) {
  const int d = wp.re.entry(e);
  const int slot = d & 31;
  const long long i = static_cast<long long>(d >> 5) * 32 + wp.lane;
  const int x = __ldg(a.docs + i);
  const float own = __fmul_rn(__ldg(a.w + i), wp.qws(slot));
  bool live = x < a.num_docs;
  float sum = own;
  Drive r;
  if (and_only) {
    for (int s = wp.tgt - 1; s >= 0; --s) {
      float c = own;
      if (s != slot) {
        if (!__any_sync(kFull, live)) break;
        float hw;
        live = search(wp, a.docs, a.w, x, live, s, hw);
        c = __fmul_rn(hw, wp.qws(s));
      }
      sum = s == wp.tgt - 1 ? c : __fadd_rn(sum, c);
    }
    r.is_or = false;
    r.or_v = -CUDART_INF_F;
    r.is_and = live;
    r.and_v = live ? sum : -CUDART_INF_F;
    return r;
  }
  int cnt = 1;
  for (int s = wp.tmax - 1; s >= 0; --s) {
    if (s == slot || wp.lo(s) == wp.hi(s)) continue;
    if (!__any_sync(kFull, live)) break;
    const float q = wp.qws(s);
    float hw;
    const bool hit = search(wp, a.docs, a.w, x, live, s, hw);
    if (s > slot) {  // doc's run ends in a higher slot
      live = live && !hit;
    } else if (hit) {
      sum = __fadd_rn(sum, __fmul_rn(hw, q));
      ++cnt;
    }
  }
  r.is_or = live;
  r.or_v = live ? sum : -CUDART_INF_F;
  r.is_and = live && cnt == wp.tgt && wp.tgt > 0;
  r.and_v = r.is_and ? sum : -CUDART_INF_F;
  return r;
}

// the row's values to the packed output (sc < 0) or to scratch slot sc
__device__ __forceinline__ void put_list(const JoinArgs& a, int row, int sc, int r, int col,
                                         int i, float v) {
  if (sc < 0) {
    put(a.out, static_cast<long long>(row) * a.width + col + i, v, a.fetch16, a.fscale);
  } else {
    a.sc_vals[(static_cast<long long>(sc) * a.nranked + r) * a.k + i] = v;
  }
}

// The merge of a row that spans several CTA items, by the last of them to
// finish: the items' counts summed, their top-k lists (in scratch,
// written by other CTAs of this launch: read past L1) merged. k <= 32:
// warp 0 merges each list into its register list; else the CTA sorts
// the lists sb values at a time in shared memory, keeping the k largest.
__device__ __forceinline__ float scratch(const JoinArgs& a, int slot, int r, long long i) {
  return __ldcg(a.sc_vals + (static_cast<long long>(slot) * a.nranked + r) * a.k + i);
}

__device__ void merge_row_warp(const JoinArgs& a, int row, int s0, int ni, int lane) {
  const long long ob = static_cast<long long>(row) * a.width;
  int col = 0;
  if (a.ops & kCounts) {
    int c0 = 0, c1 = 0;
    for (int q = lane; q < ni; q += 32) {
      c0 += __ldcg(a.sc_cnt + 2LL * (s0 + q));
      c1 += __ldcg(a.sc_cnt + 2LL * (s0 + q) + 1);
    }
    c0 = __reduce_add_sync(kFull, c0);
    c1 = __reduce_add_sync(kFull, c1);
    if (lane < 2) put(a.out, ob + lane, __int2float_rn(lane ? c1 : c0), a.fetch16, a.fscale);
    col = 2;
  }
  for (int r = 0; r < a.nranked; ++r) {
    float t = -CUDART_INF_F;
    for (int q = 0; q < ni; ++q) {
      const int i = 31 - lane;  // the list ascending across the lanes
      const float v = i < a.k ? scratch(a, s0 + q, r, i) : -CUDART_INF_F;
      if (__any_sync(kFull, v > __shfl_sync(kFull, t, a.k - 1))) t = topk_merge(t, v, lane);
    }
    if (lane < a.k) put(a.out, ob + col + lane, t, a.fetch16, a.fscale);
    col += a.k;
  }
}

__device__ void merge_row_cta(const JoinArgs& a, int row, int s0, int ni, float* s_buf,
                              int* s_cnt) {
  const int tid = threadIdx.x;
  const long long ob = static_cast<long long>(row) * a.width;
  int col = 0;
  if (a.ops & kCounts) {
    if (tid < 2) s_cnt[tid] = 0;
    __syncthreads();
    int c0 = 0, c1 = 0;
    for (int q = tid; q < ni; q += kThreads) {
      c0 += __ldcg(a.sc_cnt + 2LL * (s0 + q));
      c1 += __ldcg(a.sc_cnt + 2LL * (s0 + q) + 1);
    }
    atomicAdd(&s_cnt[0], c0);
    atomicAdd(&s_cnt[1], c1);
    __syncthreads();
    if (tid < 2) put(a.out, ob + tid, __int2float_rn(s_cnt[tid]), a.fetch16, a.fscale);
    col = 2;
  }
  const int k = a.k;
  for (int r = 0; r < a.nranked; ++r) {
    // value x of the row's lists, flat: list x / k, in scratch slot s0 + x / k
    const auto val = [&](long long x) { return scratch(a, s0 + static_cast<int>(x / k), r, x % k); };
    const long long total = static_cast<long long>(ni) * k;
    for (int i = tid; i < k; i += kThreads) s_buf[i] = val(i);
    for (long long pos = k; pos < total;) {
      const int take = static_cast<int>(min(total - pos, static_cast<long long>(a.sb - k)));
      int n = 32;
      while (n < k + take) n <<= 1;
      for (int i = k + tid; i < n; i += kThreads) {
        s_buf[i] = i - k < take ? val(pos + i - k) : -CUDART_INF_F;
      }
      __syncthreads();
      bitonic_desc(s_buf, n);
      pos += take;
    }
    __syncthreads();
    for (int i = tid; i < k; i += kThreads) put(a.out, ob + col + i, s_buf[i], a.fetch16, a.fscale);
    __syncthreads();
    col += k;
  }
}

template <bool kSmall>
__global__ void __launch_bounds__(kThreads) join_kernel(const JoinArgs a) {
  __shared__ int s_ent[kStage], s_first[kStage];
  __shared__ float s_list[2][kWarps][32];
  __shared__ int s_cnt[2], s_n[2], s_last;
  // k > 32: an item's candidates, then the merge's buffer (sb values)
  extern __shared__ float s_dyn[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool and_only = a.ops == kAnd;
  const int c0 = (a.ops & kCounts) ? 2 : 0;

  const int cta = static_cast<int>(blockIdx.x);
  if (cta >= a.n_items) {  // warp rows: a row a warp
    const int wi = (cta - a.n_items) * kWarps + warp;
    if (wi >= a.n_wrows) return;
    const int row = a.wrows[wi];
    const int* r = a.rows + 5LL * row;
    const int ent0 = r[0], nent = r[1], d0 = r[3], nd = r[4];
    int* se = s_ent + warp * kWarpStage;
    int* sf = s_first + warp * kWarpStage;
    const bool staged = nent <= min(a.stage, kWarpStage);
    if (staged) {
      for (int i = lane; i < nent; i += 32) {
        const int d = __ldg(a.ent + ent0 + i);
        se[i] = d;
        sf[i] = __ldg(a.docs + static_cast<long long>(d >> 5) * 32);
      }
    }
    __syncwarp();
    Warp wp{{a.ent + ent0, staged ? se : nullptr, sf, a.docs}, nent, r[2], a.tmax, lane};
    wp.init(a.qw + static_cast<long long>(row) * a.tmax);
    float top_or = -CUDART_INF_F, top_and = -CUDART_INF_F;
    int n_or = 0, n_and = 0;
    for (int e = d0; e < d0 + nd; ++e) {
      const Drive dv = drive(wp, a, e, and_only);
      if (a.ops & kOr) top_or = topk_insert(top_or, dv.or_v, a.k, lane);
      if (a.ops & kAnd) top_and = topk_insert(top_and, dv.and_v, a.k, lane);
      n_or += __popc(__ballot_sync(kFull, dv.is_or));
      n_and += __popc(__ballot_sync(kFull, dv.is_and));
    }
    if (c0 && lane < 2) put_list(a, row, -1, 0, 0, lane, __int2float_rn(lane ? n_or : n_and));
    int col = c0;
    if (a.ops & kOr) {
      if (lane < a.k) put_list(a, row, -1, 0, col, lane, top_or);
      col += a.k;
    }
    if ((a.ops & kAnd) && lane < a.k) put_list(a, row, -1, 0, col, lane, top_and);
    return;
  }

  // a CTA item: [row, first driving entry, driving entries, scratch slot,
  // merged row] (the last two -1 where the item is the row's only one)
  const int* it = a.items + 5LL * cta;
  const int row = it[0], d0 = it[1], ne = it[2], sc = it[3], mi = it[4];
  const int* r = a.rows + 5LL * row;
  const int ent0 = r[0], nent = r[1];
  const bool staged = nent <= a.stage;
  if (tid < 2) s_cnt[tid] = s_n[tid] = 0;
  if (staged) {
    for (int i = tid; i < nent; i += kThreads) {
      const int d = __ldg(a.ent + ent0 + i);
      s_ent[i] = d;
      s_first[i] = __ldg(a.docs + static_cast<long long>(d >> 5) * 32);
    }
  }
  __syncthreads();
  Warp wp{{a.ent + ent0, staged ? s_ent : nullptr, s_first, a.docs}, nent, r[2], a.tmax, lane};
  wp.init(a.qw + static_cast<long long>(row) * a.tmax);
  float top[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int n_or = 0, n_and = 0;
  for (int e = d0 + warp; e < d0 + ne; e += kWarps) {
    const Drive dv = drive(wp, a, e, and_only);
    const bool is_c[2] = {dv.is_or, dv.is_and};
    const float v[2] = {dv.or_v, dv.and_v};
#pragma unroll
    for (int op = 0; op < 2; ++op) {
      if (!(a.ops & (op == 0 ? kOr : kAnd))) continue;
      if (kSmall) {
        top[op] = topk_insert(top[op], v[op], a.k, lane);
      } else {  // compact the candidates
        const unsigned m = __ballot_sync(kFull, is_c[op]);
        int base = 0;
        if (lane == 0 && m) base = atomicAdd(&s_n[op], __popc(m));
        base = __shfl_sync(kFull, base, 0);
        if (is_c[op]) s_dyn[op * kChunk * 32 + base + __popc(m & ((1u << lane) - 1))] = v[op];
      }
    }
    n_or += __popc(__ballot_sync(kFull, dv.is_or));
    n_and += __popc(__ballot_sync(kFull, dv.is_and));
  }
  if (lane == 0) {
    atomicAdd(&s_cnt[0], n_and);
    atomicAdd(&s_cnt[1], n_or);
  }
  if (kSmall) {
    s_list[0][warp][lane] = top[0];
    s_list[1][warp][lane] = top[1];
  }
  __syncthreads();
  if (c0 && tid < 2) {
    if (sc < 0) {
      put_list(a, row, -1, 0, 0, tid, __int2float_rn(s_cnt[tid]));
    } else {
      a.sc_cnt[2LL * sc + tid] = s_cnt[tid];
    }
  }
  int col = c0, rk = 0;
  for (int op = 0; op < 2; ++op) {
    if (!(a.ops & (op == 0 ? kOr : kAnd))) continue;
    if (kSmall) {
      if (warp == 0) {  // the 8 warps' lists merged once
        float t = s_list[op][0][lane];
        for (int q = 1; q < kWarps; ++q) {
          const float v = s_list[op][q][31 - lane];
          if (__any_sync(kFull, v > __shfl_sync(kFull, t, a.k - 1))) t = topk_merge(t, v, lane);
        }
        if (lane < a.k) put_list(a, row, sc, rk, col, lane, t);
      }
    } else {  // the candidates alone, sorted
      float* buf = s_dyn + op * kChunk * 32;
      const int cnt = s_n[op];
      int n = 32;
      while (n < cnt) n <<= 1;
      for (int i = cnt + tid; i < n; i += kThreads) buf[i] = -CUDART_INF_F;
      __syncthreads();
      bitonic_desc(buf, n);
      for (int i = tid; i < a.k; i += kThreads) {
        put_list(a, row, sc, rk, col, i, i < n ? buf[i] : -CUDART_INF_F);
      }
    }
    col += a.k;
    ++rk;
  }
  if (sc < 0) return;
  // the row spans several items: the last to finish merges their lists
  __threadfence();
  __syncthreads();
  const int* mr = a.merges + 3LL * mi;  // [row, first scratch slot, slots]
  if (tid == 0) s_last = atomicAdd(a.mcount + mi, 1) == mr[2] - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (kSmall) {
    if (warp == 0) merge_row_warp(a, row, mr[1], mr[2], lane);
  } else {
    merge_row_cta(a, row, mr[1], mr[2], s_dyn, s_cnt);
  }
}

}  // namespace

extern "C" int ds2i_join_part(const void* docs, const void* w, const void* ent, const void* rows,
                              const void* qw, const void* items, int n_items, const void* wrows,
                              int n_wrows, const void* merges, void* mcount, int n_merge,
                              int num_docs, int k, int ops, int tmax, int stage, int fetch16, float fscale, void* out, void* sc_vals, void* sc_cnt,
                              void* stream) {
  const int nranked = ((ops & kOr) ? 1 : 0) + ((ops & kAnd) ? 1 : 0);
  const bool small = nranked == 0 || k <= kWarpK;
  // docs, w and ent are read only through a row's entries (none where
  // every row is empty)
  if (rows == nullptr || qw == nullptr || out == nullptr || sc_vals == nullptr ||
      sc_cnt == nullptr || n_items < 0 || n_wrows < 0 || n_merge < 0 || tmax < 1 || tmax > 32 ||
      (nranked && (k < 1 || k > 4096)) || ops <= 0 || ops > 7 ||
      (n_items > 0 && items == nullptr) || (n_wrows > 0 && (wrows == nullptr || !small)) ||
      (n_merge > 0 && (merges == nullptr || mcount == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = n_items + (n_wrows + kWarps - 1) / kWarps;
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  JoinArgs a;
  a.docs = static_cast<const int*>(docs);
  a.w = static_cast<const float*>(w);
  a.ent = static_cast<const int*>(ent);
  a.rows = static_cast<const int*>(rows);
  a.qw = static_cast<const float*>(qw);
  a.items = static_cast<const int*>(items);
  a.wrows = static_cast<const int*>(wrows);
  a.merges = static_cast<const int*>(merges);
  a.mcount = static_cast<int*>(mcount);
  a.n_items = n_items;
  a.n_wrows = n_wrows;
  a.num_docs = num_docs;
  a.k = k;
  a.ops = ops;
  a.tmax = tmax;
  a.stage = stage < 0 ? 0 : (stage > kStage ? kStage : stage);
  a.fetch16 = fetch16;
  a.width = ((ops & kCounts) ? 2 : 0) + nranked * k;
  a.nranked = nranked;
  a.sb = 2 * kChunk * 32;  // k > 32: the candidates of both ops, or 2k at least
  while (a.sb < 2 * k) a.sb <<= 1;
  a.fscale = fscale;
  a.out = out;
  a.sc_vals = static_cast<float*>(sc_vals);
  a.sc_cnt = static_cast<int*>(sc_cnt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_merge > 0) {  // the arrival counts, zeroed in stream order (a memset, not a kernel)
    const cudaError_t err = cudaMemsetAsync(mcount, 0, sizeof(int) * n_merge, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (small) {
    join_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    const int dyn = a.sb * static_cast<int>(sizeof(float));
    const cudaError_t err =
        cudaFuncSetAttribute(join_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    join_kernel<false><<<grid, kThreads, dyn, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
