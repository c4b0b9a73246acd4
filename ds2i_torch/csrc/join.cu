// The join and pack of a part for Hopper (sm_90a): K3, one launch per part
// and a second where a row spans several CTAs.
//
// Replaces the jnp device ops ds2i_tpu/engine/resident.py:_join_bucket (a
// stable row sort by docid, shifted adds over runs of at most tmax equal
// docids, AND/OR flags, counts, top-k per row, one program per length
// bucket) and :_pack_rows (the buckets' real rows gathered, scaled by
// fscale and cast to f16). Every output equals
// ds2i_torch/ops/join.py:join_part_torch bit for bit.
//
// Per packed row (rows: [first entry, entries, tgt]; qw: the row's tmax
// slot weights) the kernel reads only the row's real directory entries
// ent = blk << 5 | slot (no sentinel columns, no pad rows) and, per
// entry, block blk of docs32 and w32 (32 slots each). Sort-free: the
// entries of a slot are contiguous and slots ascend along the row; within
// a slot the blocks' real docids strictly increase, each block holding
// its real docids first (slot 0 real) and its pads (num_docs) last. So a
// real slot (doc < num_docs) finds doc in another slot's entries by two
// searches: the last entry whose first docid is <= doc (a binary search
// over the slot's entries), then doc among its 32 docids (5 steps). The
// run of doc is owned by its highest slot: a slot that finds doc in a
// higher slot is not a run's last entry. The owner scores the run as the
// JAX shifted adds do, its own c = w * qw first, then the lower slots'
// c in descending slot order, ((c_last + c_prev) + ...), each a
// __fmul_rn and a __fadd_rn (never contracted into an FMA), and counts
// the slots that hold doc. OR candidate: every owner; AND candidate: an
// owner whose count equals tgt (tgt > 0).
//
// Work: one CTA per item (a row's entries [e0, e0 + ne), ne <= 32, a
// warp per entry, a lane per slot). The row's entries and their first
// docids are staged in shared memory (rows of at most `stage` entries).
// Candidates go to a shared buffer of ne * 32 values (-inf elsewhere),
// sorted descending by a bitonic network; the first k are the item's
// top-k. A row of one item writes its output row at once; a row of
// several writes its counts and top-k lists to scratch, and the second
// launch (one CTA per such row) sums the counts and merges the lists,
// sorting up to `sb` values at a time and keeping the k largest. Only
// values leave, so equal scores need no order. Output row: [and count,
// or count] (ops & kCounts), then the OR top-k, then the AND top-k;
// f16 (fetch16): __float2half_rn(__fmul_rn(x, fscale)), else f32.
//
// What bounds it on this card: the dependent reads of the searches. A
// pass moves few bytes (each real entry's 4 B and its block's 256 B,
// qw and tgt, the packed rows written once), but each real slot makes up
// to tmax - 1 searches of log2(entries) + 5 dependent reads, served from
// shared memory (the row's entries and first docids) and from L2 (the
// part's docs32 and w32). No tensor-core or TMA path applies.

#include <cuda_fp16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;    // entries per item at most (ds2i_torch/ops/join.py CHUNK)
constexpr int kStage = 2048;  // a row's entries staged in shared memory up to this many
constexpr int kMergeMin = 1024;  // the merge sorts at least this many values at a time
enum Ops { kCounts = 1, kOr = 2, kAnd = 4 };

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

// the row's entries: from shared memory when staged, else device memory
struct RowEntries {
  const int* ent;     // the row's first entry
  const int* s_ent;   // staged entries, or nullptr
  const int* s_first; // staged first docids
  const int* docs;

  __device__ __forceinline__ int entry(int p) const { return s_ent ? s_ent[p] : __ldg(ent + p); }
  __device__ __forceinline__ int first(int p) const {
    return s_ent ? s_first[p] : __ldg(docs + static_cast<long long>(entry(p) >> 5) * 32);
  }
  // the slot index (block * 32 + j) of doc among entries [a, b), or -1
  __device__ __forceinline__ long long find(int doc, int a, int b) const {
    int lo = a, n = b - a;
    while (n > 0) {  // lo: the first entry whose first docid is > doc
      const int half = n >> 1;
      if (first(lo + half) <= doc) {
        lo += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    if (lo == a) return -1;
    const long long base = static_cast<long long>(entry(lo - 1) >> 5) * 32;
    int j = 0;  // the docids < doc in the block (its 32 are non-decreasing)
#pragma unroll
    for (int st = 16; st > 0; st >>= 1) {
      if (__ldg(docs + base + j + st - 1) < doc) j += st;
    }
    return __ldg(docs + base + j) == doc ? base + j : -1;
  }
};

__global__ void __launch_bounds__(kThreads)
join_items_kernel(const int* __restrict__ docs, const float* __restrict__ w,
                  const int* __restrict__ ent, const int* __restrict__ rows,
                  const float* __restrict__ qw, const int* __restrict__ items, int num_docs,
                  int k, int ops, int tmax, int stage, int fetch16, float fscale, int width,
                  int nranked, void* __restrict__ out, float* __restrict__ sc_vals,
                  int* __restrict__ sc_cnt) {
  __shared__ float s_cand[2][kChunk * 32];
  __shared__ int s_ent[kStage], s_first[kStage];
  __shared__ float s_qw[32];
  __shared__ int s_sb[33];
  __shared__ int s_cnt[2];
  const int tid = threadIdx.x;
  const int* it = items + 4LL * blockIdx.x;
  const int row = it[0], e0 = it[1], ne = it[2], sc = it[3];
  const int ent0 = rows[3LL * row], nent = rows[3LL * row + 1], tgt = rows[3LL * row + 2];
  const bool staged = nent <= stage;
  if (tid < 2) s_cnt[tid] = 0;
  if (tid < tmax) s_qw[tid] = qw[static_cast<long long>(row) * tmax + tid];
  for (int i = tid; i < kChunk * 32; i += kThreads) s_cand[0][i] = s_cand[1][i] = -CUDART_INF_F;
  if (staged) {
    for (int i = tid; i < nent; i += kThreads) {
      const int d = __ldg(ent + ent0 + i);
      s_ent[i] = d;
      s_first[i] = __ldg(docs + static_cast<long long>(d >> 5) * 32);
    }
  }
  __syncthreads();
  const RowEntries re{ent + ent0, staged ? s_ent : nullptr, s_first, docs};
  if (tid <= tmax) {  // s_sb[s]: the row's first entry of a slot >= s
    int lo = 0, n = nent;
    while (n > 0) {
      const int half = n >> 1;
      if ((re.entry(lo + half) & 31) < tid) {
        lo += half + 1;
        n -= half + 1;
      } else {
        n = half;
      }
    }
    s_sb[tid] = lo;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  int n_or = 0, n_and = 0;
  for (int e = warp; e < ne; e += kWarps) {
    const int d = re.entry(e0 + e);
    const int slot = d & 31;
    const long long i = static_cast<long long>(d >> 5) * 32 + lane;
    const int doc = __ldg(docs + i);
    if (doc >= num_docs) continue;
    float sum = __fmul_rn(__ldg(w + i), s_qw[slot]);
    int cnt = 1;
    bool owner = true;
    for (int s = tmax - 1; s >= 0; --s) {
      const int a = s_sb[s], b = s_sb[s + 1];
      if (s == slot || a == b) continue;
      const long long p = re.find(doc, a, b);
      if (p < 0) continue;
      if (s > slot) {  // doc's run ends in a higher slot
        owner = false;
        break;
      }
      sum = __fadd_rn(sum, __fmul_rn(__ldg(w + p), s_qw[s]));
      ++cnt;
    }
    if (!owner) continue;
    const bool in_and = cnt == tgt && tgt > 0;
    ++n_or;
    n_and += in_and;
    s_cand[0][e * 32 + lane] = sum;
    if (in_and) s_cand[1][e * 32 + lane] = sum;
  }
  n_or = __reduce_add_sync(0xFFFFFFFFu, n_or);
  n_and = __reduce_add_sync(0xFFFFFFFFu, n_and);
  if (lane == 0) {
    atomicAdd(&s_cnt[0], n_and);
    atomicAdd(&s_cnt[1], n_or);
  }
  __syncthreads();

  int n = 32;
  while (n < ne * 32) n <<= 1;
  const long long ob = static_cast<long long>(row) * width;
  int col = 0, r = 0;
  if (ops & kCounts) {
    if (tid < 2) {
      if (sc < 0) {
        put(out, ob + tid, __int2float_rn(s_cnt[tid]), fetch16, fscale);
      } else {
        sc_cnt[2LL * sc + tid] = s_cnt[tid];
      }
    }
    col = 2;
  }
  for (int op = 0; op < 2; ++op) {
    if (!(ops & (op == 0 ? kOr : kAnd))) continue;
    float* buf = s_cand[op];
    bitonic_desc(buf, n);
    for (int i = tid; i < k; i += kThreads) {
      const float v = i < n ? buf[i] : -CUDART_INF_F;
      if (sc < 0) {
        put(out, ob + col + i, v, fetch16, fscale);
      } else {
        sc_vals[(static_cast<long long>(sc) * nranked + r) * k + i] = v;
      }
    }
    col += k;
    ++r;
  }
}

__global__ void __launch_bounds__(kThreads)
join_merge_kernel(const int* __restrict__ merges, int k, int ops, int fetch16, float fscale,
                  int width, int nranked, int sb, void* __restrict__ out,
                  const float* __restrict__ sc_vals, const int* __restrict__ sc_cnt) {
  extern __shared__ float s_buf[];
  __shared__ int s_cnt[2];
  const int tid = threadIdx.x;
  const int* m = merges + 3LL * blockIdx.x;
  const int row = m[0], s0 = m[1], ni = m[2];
  const long long ob = static_cast<long long>(row) * width;
  int col = 0;
  if (ops & kCounts) {
    if (tid < 2) s_cnt[tid] = 0;
    __syncthreads();
    int c0 = 0, c1 = 0;
    for (int i = tid; i < ni; i += kThreads) {
      c0 += sc_cnt[2LL * (s0 + i)];
      c1 += sc_cnt[2LL * (s0 + i) + 1];
    }
    atomicAdd(&s_cnt[0], c0);
    atomicAdd(&s_cnt[1], c1);
    __syncthreads();
    if (tid < 2) put(out, ob + tid, __int2float_rn(s_cnt[tid]), fetch16, fscale);
    col = 2;
  }
  for (int r = 0; r < nranked; ++r) {
    // list q of the row: scratch slot s0 + q; value x of the flat lists
    const auto val = [&](long long x) {
      return sc_vals[((s0 + x / k) * nranked + r) * k + x % k];
    };
    const long long total = static_cast<long long>(ni) * k;
    for (int i = tid; i < k; i += kThreads) s_buf[i] = val(i);
    for (long long pos = k; pos < total;) {
      const int take = static_cast<int>(min(total - pos, static_cast<long long>(sb - k)));
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
    for (int i = tid; i < k; i += kThreads) put(out, ob + col + i, s_buf[i], fetch16, fscale);
    __syncthreads();
    col += k;
  }
}

}  // namespace

extern "C" int ds2i_join_part(const void* docs, const void* w, const void* ent, const void* rows,
                              const void* qw, const void* items, int n_items, const void* merges,
                              int n_merge, int num_docs, int k, int ops, int tmax, int stage,
                              int fetch16, float fscale, void* out, void* sc_vals, void* sc_cnt,
                              void* stream) {
  const int nranked = ((ops & kOr) ? 1 : 0) + ((ops & kAnd) ? 1 : 0);
  if (docs == nullptr || w == nullptr || ent == nullptr || rows == nullptr || qw == nullptr ||
      items == nullptr || out == nullptr || sc_vals == nullptr || sc_cnt == nullptr ||
      n_items < 0 || n_merge < 0 || tmax < 1 || tmax > 32 || (nranked && (k < 1 || k > 4096)) ||
      ops <= 0 || ops > 7 || (n_merge > 0 && merges == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_items == 0) return static_cast<int>(cudaGetLastError());
  const int width = ((ops & kCounts) ? 2 : 0) + nranked * k;
  const int stg = stage < 0 ? 0 : (stage > kStage ? kStage : stage);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  join_items_kernel<<<n_items, kThreads, 0, s>>>(
      static_cast<const int*>(docs), static_cast<const float*>(w), static_cast<const int*>(ent),
      static_cast<const int*>(rows), static_cast<const float*>(qw),
      static_cast<const int*>(items), num_docs, k, ops, tmax, stg, fetch16, fscale, width,
      nranked, out, static_cast<float*>(sc_vals), static_cast<int*>(sc_cnt));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_merge == 0) return static_cast<int>(err);
  int sb = kMergeMin;
  while (sb < 2 * k) sb <<= 1;
  join_merge_kernel<<<n_merge, kThreads, sb * sizeof(float), s>>>(
      static_cast<const int*>(merges), k, ops, fetch16, fscale, width, nranked, sb, out,
      static_cast<const float*>(sc_vals), static_cast<const int*>(sc_cnt));
  return static_cast<int>(cudaGetLastError());
}
