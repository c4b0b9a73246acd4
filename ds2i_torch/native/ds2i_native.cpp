// Native construction kernels for ds2i_tpu.
//
// The reference runs its (1+eps)-approximate partition DP
// (optimal_partition.hpp:70-121) inside C++ worker threads; here the same
// algorithm is provided as a shared library called through ctypes, with the
// indexed-sequence cost function (min of Elias-Fano / ranked-bitvector /
// all-ones bit sizes + fixed per-partition cost) evaluated inline. The
// Python DP in ds2i_tpu.sequences.partitioned is the reference
// implementation; this one must produce identical partitions (asserted by
// tests/test_native.py).
//
// Build: python ds2i_tpu/native/build.py  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstddef>
#include <algorithm>
#include <chrono>
#include <vector>
#include <cmath>
#include <limits>

namespace {

constexpr uint64_t INF_BITS = uint64_t(1) << 62;

inline uint64_t msb(uint64_t x) {
    return 63 - __builtin_clzll(x);
}

inline uint64_t ceil_log2(uint64_t x) {
    return x > 1 ? msb(x - 1) + 1 : 0;
}

struct EFParams {
    uint64_t log_sampling0;
    uint64_t log_sampling1;
    uint64_t rb_log_rank1_sampling;
    uint64_t rb_log_sampling1;
};

// compact_elias_fano bit size (mirrors sequences/ef.py EFOffsets)
inline uint64_t ef_bitsize(const EFParams& p, uint64_t universe, uint64_t n) {
    uint64_t lower_bits = universe > n ? msb(universe / n) : 0;
    uint64_t higher_bits_length = n + (universe >> lower_bits) + 2;
    uint64_t pointer_size = ceil_log2(higher_bits_length);
    uint64_t pointers0 = (higher_bits_length - n) >> p.log_sampling0;
    uint64_t pointers1 = n >> p.log_sampling1;
    return (pointers0 + pointers1) * pointer_size + higher_bits_length + n * lower_bits;
}

// compact_ranked_bitvector bit size (mirrors sequences/ef.py RBOffsets)
inline uint64_t rb_bitsize(const EFParams& p, uint64_t universe, uint64_t n) {
    uint64_t rank1_sample_size = ceil_log2(n + 1);
    uint64_t pointer_size = ceil_log2(universe);
    uint64_t rank1_samples = universe >> p.rb_log_rank1_sampling;
    uint64_t pointers1 = n >> p.rb_log_sampling1;
    return rank1_samples * rank1_sample_size + pointers1 * pointer_size + universe;
}

// indexed_sequence: min(all_ones, EF+1, RB+1)
inline uint64_t indexed_bitsize(const EFParams& p, uint64_t universe, uint64_t n) {
    uint64_t best = (universe == n) ? 0 : INF_BITS;
    uint64_t ef = ef_bitsize(p, universe, n) + 1;
    if (ef < best) best = ef;
    uint64_t rb = rb_bitsize(p, universe, n) + 1;
    if (rb < best) best = rb;
    return best;
}

struct CostWindow {
    size_t start = 0, end = 0;
    uint64_t min_p, max_p = 0;
    double cost_upper_bound;
};

}  // namespace

extern "C" {

// Returns the number of partition endpoints written to out (<= n), or -1 on
// overflow of out capacity. cost_kind: 0 = indexed_sequence cost (docs),
// 1 = strict_sequence cost (freq prefix sums; strict EF over u-n+1 with
// zero-sampling disabled, strict_sequence.hpp:24-30).
long ds2i_optimal_partition(
    const uint32_t* values, uint64_t n, uint64_t universe,
    double eps1, double eps2, uint64_t fix_cost, int cost_kind,
    uint64_t ef_log_sampling0, uint64_t ef_log_sampling1,
    uint64_t rb_log_rank1_sampling, uint64_t rb_log_sampling1,
    uint32_t* out, uint64_t out_capacity)
{
    EFParams p{ef_log_sampling0, ef_log_sampling1, rb_log_rank1_sampling, rb_log_sampling1};
    EFParams sp{63, ef_log_sampling1, 63, rb_log_sampling1};
    auto strict_bitsize = [&](uint64_t u, uint64_t m) -> uint64_t {
        uint64_t best = (u == m) ? 0 : INF_BITS;
        uint64_t ef = ef_bitsize(sp, u - m + 1, m) + 1;
        if (ef < best) best = ef;
        uint64_t rb = rb_bitsize(sp, u, m) + 1;
        if (rb < best) best = rb;
        return best;
    };
    auto cost = [&](uint64_t u, uint64_t m) -> double {
        uint64_t bits = cost_kind == 1 ? strict_bitsize(u, m) : indexed_bitsize(p, u, m);
        return double(bits + fix_cost);
    };

    double single_block_cost = cost(universe, n);
    std::vector<double> min_cost(n + 1, single_block_cost);
    min_cost[0] = 0;

    std::vector<CostWindow> windows;
    double cost_lb = cost(1, 1);
    // match the Python/C++ reference truncation: cost bounds are integers
    uint64_t cost_bound = (uint64_t)cost_lb;
    while (eps1 == 0 || (double)cost_bound < cost_lb / eps1) {
        CostWindow w;
        w.min_p = values[0];
        w.cost_upper_bound = (double)cost_bound;
        windows.push_back(w);
        if ((double)cost_bound >= single_block_cost) break;
        cost_bound = (uint64_t)(cost_bound * (1 + eps2));
    }

    std::vector<uint32_t> path(n + 1, 0);
    for (size_t i = 0; i < n; ++i) {
        size_t last_end = i + 1;
        for (auto& w : windows) {
            while (w.end < last_end) {
                w.max_p = values[w.end];
                ++w.end;
            }
            while (true) {
                double window_cost = cost(w.max_p - w.min_p + 1, w.end - w.start);
                if (min_cost[i] + window_cost < min_cost[w.end]) {
                    min_cost[w.end] = min_cost[i] + window_cost;
                    path[w.end] = (uint32_t)i;
                }
                last_end = w.end;
                if (w.end == n) break;
                if (window_cost >= w.cost_upper_bound) break;
                w.max_p = values[w.end];
                ++w.end;
            }
            w.min_p = (uint64_t)values[w.start] + 1;
            ++w.start;
        }
    }

    std::vector<uint32_t> partition;
    size_t cur = n;
    while (cur != 0) {
        partition.push_back((uint32_t)cur);
        cur = path[cur];
    }
    if (partition.size() > out_capacity) return -1;
    for (size_t k = 0; k < partition.size(); ++k) {
        out[k] = partition[partition.size() - 1 - k];
    }
    return (long)partition.size();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched compact-Elias-Fano writer.
//
// The reference encodes posting lists inside semiasync_queue worker threads
// (freq_index.hpp:54-97, compact_elias_fano.hpp:69-136). Here whole index
// construction is one call: every sequence's bit layout was precomputed on
// the host (vectorized), and this kernel writes headers, high bits, low
// bits, and both pointer arrays for all sequences, thread-parallel over
// contiguous sequence ranges. Adjacent sequences can share a 64-bit word,
// so every write is an atomic OR into the zero-initialized buffer (all
// writes touch disjoint bits, making relaxed atomics exact).

#include <thread>
#include <vector>
#include <atomic>

namespace {

inline void or_bits(uint64_t* words, int64_t pos, uint64_t value, int width) {
    if (width <= 0) return;
    if (width < 64) value &= (1ULL << width) - 1;
    int64_t w = pos >> 6;
    int s = (int)(pos & 63);
    __atomic_fetch_or(&words[w], value << s, __ATOMIC_RELAXED);
    if (s + width > 64)
        __atomic_fetch_or(&words[w + 1], value >> (64 - s), __ATOMIC_RELAXED);
}

// gamma(x): nn = x+1, l = msb(nn); LSB-first: (1<<l) in l+1 bits, then
// nn^(1<<l) in l bits (integer_codes.hpp:6-24; bitvec/codes.py)
inline int64_t write_gamma(uint64_t* words, int64_t pos, uint64_t x) {
    uint64_t nn = x + 1;
    int l = (int)msb(nn);
    or_bits(words, pos, 1ULL << l, l + 1);
    or_bits(words, pos + l + 1, nn ^ (1ULL << l), l);
    return pos + 2 * l + 1;
}

inline void ef_write_one(uint64_t* words, const uint64_t* v, int64_t n,
                         uint64_t universe, int64_t base, int log_s0, int log_s1) {
    int l = universe > (uint64_t)n ? (int)msb(universe / (uint64_t)n) : 0;
    int64_t hb_len = n + (int64_t)(universe >> l) + 2;
    int psize = (int)ceil_log2((uint64_t)hb_len);
    int64_t p0 = (hb_len - n) >> log_s0;
    int64_t p1 = n >> log_s1;
    int64_t p0_off = base;
    int64_t p1_off = p0_off + p0 * psize;
    int64_t hb_off = p1_off + p1 * psize;
    int64_t lb_off = hb_off + hb_len;
    uint64_t mask = l ? ((1ULL << l) - 1) : 0;

    for (int64_t k = 0; k < n; k++) {
        uint64_t high = (v[k] >> l) + (uint64_t)k + 1;
        int64_t pos = hb_off + (int64_t)high;
        __atomic_fetch_or(&words[pos >> 6], 1ULL << (pos & 63), __ATOMIC_RELAXED);
        if (l) or_bits(words, lb_off + k * l, v[k] & mask, l);
    }
    for (int64_t k = 1; k <= p1; k++) {
        int64_t idx = k << log_s1;
        if (idx >= n) break;  // slots past the end stay zero (reference loop bound)
        or_bits(words, p1_off + (k - 1) * psize, (v[idx] >> l) + (uint64_t)idx + 1, psize);
    }
    if (p0) {
        // walk ones in order, emitting every (k<<log_s0)-th zero position
        int64_t zeros_seen = 0, prev_one = -1, k = 1;
        int64_t next_target = (int64_t)1 << log_s0;
        int64_t total_zeros = hb_len - n;
        for (int64_t i = 0; i <= n && k <= p0; i++) {
            int64_t one = (i < n) ? (int64_t)((v[i] >> l) + (uint64_t)i + 1) : hb_len;
            int64_t gap = one - prev_one - 1;  // zeros strictly between
            while (k <= p0 && next_target < zeros_seen + gap) {
                if (next_target >= total_zeros) { k = p0 + 1; break; }
                int64_t zpos = prev_one + 1 + (next_target - zeros_seen);
                or_bits(words, p0_off + (k - 1) * psize, (uint64_t)zpos, psize);
                k++; next_target = (int64_t)k << log_s0;
            }
            zeros_seen += gap;
            prev_one = one;
        }
    }
}

}  // namespace

extern "C" {

// occs == NULL: plain EF sequences. occs != NULL: per-sequence freq_index
// docs header first — gamma_nonzero(occ), then n in ceil_log2(occ+1) bits
// when occ > 1 (freq_index.hpp:68-73) — then EF at the header's end.
void ds2i_ef_write_batch(
    uint64_t* words,
    const uint64_t* vals, const int64_t* voff,
    const int64_t* base_bits, const uint64_t* universes,
    const uint64_t* occs,
    int log_s0, int log_s1, int64_t count, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            int64_t n = voff[i + 1] - voff[i];
            int64_t pos = base_bits[i];
            if (occs) {
                pos = write_gamma(words, pos, occs[i] - 1);
                if (occs[i] > 1) {
                    int w = (int)ceil_log2(occs[i] + 1);
                    or_bits(words, pos, (uint64_t)n, w);
                    pos += w;
                }
            }
            ef_write_one(words, vals + voff[i], n, universes[i], pos, log_s0, log_s1);
        }
    };
    if (nthreads == 1 || count < 256) {
        work(0, count);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (count + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * chunk, hi = std::min(count, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched block-codec posting-list writer.
//
// The reference encodes block posting lists in C++ worker threads
// (block_posting_list.hpp:13-53 layout; codecs in block_codecs.hpp and
// qmx_codec.hpp). This is the native twin of the Python oracle encoders in
// ds2i_tpu/codecs/{optpfor,simple16,varint,interpolative,qmx,vbyte}.py and
// index/block_index.py BlockPostingList.write — it must produce byte-
// identical output (asserted by tests/test_native.py). Thread-parallel over
// contiguous list ranges like ds2i_ef_write_batch.

#include <cstring>
#include <string>

namespace blockenc {

constexpr uint32_t UNKNOWN_SUM = 0xFFFFFFFFu;
constexpr int BLOCK_SIZE = 128;

using Buf = std::vector<uint8_t>;

inline void put_u32(Buf& out, uint32_t w) {
    out.push_back(w & 0xFF);
    out.push_back((w >> 8) & 0xFF);
    out.push_back((w >> 16) & 0xFF);
    out.push_back((w >> 24) & 0xFF);
}

// TightVariableByte (vbyte.py): 7-bit groups LE-first, high bit on LAST byte
inline void vbyte_encode(Buf& out, uint64_t v) {
    while (true) {
        uint8_t byte = v & 0x7F;
        v >>= 7;
        if (v == 0) { out.push_back(byte | 0x80); break; }
        out.push_back(byte);
    }
}

// BitWriter32 (interpolative.py): 32-bit LE word bit stream
struct BitWriter32 {
    std::vector<uint32_t> words;
    uint64_t size = 0;

    void write(uint64_t bits, int length) {
        if (!length) return;
        bits &= (length < 64) ? ((uint64_t(1) << length) - 1) : ~uint64_t(0);
        int pos = (int)(size % 32);
        size += length;
        if (pos == 0) {
            words.push_back((uint32_t)(bits & 0xFFFFFFFFu));
        } else {
            words.back() |= (uint32_t)((bits << pos) & 0xFFFFFFFFu);
            if (length > 32 - pos) words.push_back((uint32_t)(bits >> (32 - pos)));
        }
        // bits wider than 32 never occur here (write_int caps at b <= 32)
    }

    // centered minimal binary code for val in [0, u)
    void write_int(uint64_t val, uint64_t u) {
        int b = 63 - __builtin_clzll(u);  // msb(u), u >= 1
        uint64_t m = (uint64_t(1) << (b + 1)) - u;
        if (val < m) {
            write(val, b);
        } else {
            val += m;
            write(val >> 1, b);
            write(val & 1, 1);
        }
    }

    void write_interpolative(const uint64_t* cum, long lo_i, long hi_i,
                             uint64_t low, uint64_t high) {
        long n = hi_i - lo_i;
        if (n <= 0) return;
        long h = lo_i + n / 2;
        uint64_t val = cum[h];
        write_int(val - low, high - low + 1);
        write_interpolative(cum, lo_i, h, low, val);
        write_interpolative(cum, h + 1, hi_i, val, high);
    }

    void tobytes(Buf& out) const {
        uint64_t nbytes = (size + 7) / 8;
        for (uint64_t i = 0; i < nbytes; i++)
            out.push_back((uint8_t)(words[i / 4] >> ((i % 4) * 8)));
    }
};

// interpolative.py InterpolativeBlock.encode: values are gaps; prefix-sum,
// optional vbyte(sum) when unknown, then interpolative bits over cum[0..n-1)
inline void interp_encode(Buf& out, const uint32_t* gaps, int n, uint32_t sum_of_values) {
    uint64_t cum[BLOCK_SIZE];
    uint64_t c = 0;
    for (int i = 0; i < n; i++) { c += gaps[i]; cum[i] = c; }
    uint64_t sum = sum_of_values;
    if (sum_of_values == UNKNOWN_SUM) {
        sum = cum[n - 1];
        vbyte_encode(out, sum);
    }
    BitWriter32 bw;
    bw.write_interpolative(cum, 0, n - 1, 0, sum);
    bw.tobytes(out);
}

// simple16.py: 4-bit selector + 28 data bits; 16 modes of (count, bits)
struct S16Mode { int cnt; uint8_t widths[28]; };
inline const S16Mode* s16_modes() {
    static S16Mode modes[16];
    static bool init = false;
    if (!init) {
        const int spec[16][4][2] = {
            {{28,1}}, {{7,2},{14,1}}, {{14,1},{7,2}}, {{14,2}},
            {{4,3},{8,2}}, {{8,2},{4,3}}, {{7,4}}, {{4,5},{2,4}},
            {{2,4},{4,5}}, {{3,6},{2,5}}, {{2,5},{3,6}}, {{4,7}},
            {{2,9},{1,10}}, {{1,10},{2,9}}, {{2,14}}, {{1,28}},
        };
        for (int s = 0; s < 16; s++) {
            int k = 0;
            for (int r = 0; r < 4; r++) {
                for (int c = 0; c < spec[s][r][0]; c++) modes[s].widths[k++] = (uint8_t)spec[s][r][1];
            }
            modes[s].cnt = k;
        }
        init = true;
    }
    return modes;
}

// encode; returns number of u32 words appended (values must be < 2^28)
inline int simple16_encode(std::vector<uint32_t>& words, const uint32_t* vals, int n) {
    const S16Mode* modes = s16_modes();
    int emitted = 0;
    int i = 0;
    while (i < n) {
        for (int sel = 0; sel < 16; sel++) {
            const S16Mode& m = modes[sel];
            int k = std::min(m.cnt, n - i);
            bool fits = true;
            for (int j = 0; j < k; j++) {
                if (vals[i + j] >= (uint32_t(1) << m.widths[j])) { fits = false; break; }
            }
            if (!fits) continue;
            uint32_t w = 0;
            int shift = 0;
            for (int j = 0; j < m.cnt; j++) {
                uint32_t v = j < k ? vals[i + j] : 0;
                w |= v << shift;
                shift += m.widths[j];
            }
            words.push_back(((uint32_t)sel << 28) | w);
            emitted++;
            i += k;
            break;
        }
    }
    return emitted;
}

// optpfor.py: possLogs grid, <= wins ties (largest feasible b at min size)
inline const int* poss_logs(int& count) {
    static const int logs[] = {0,1,2,3,4,5,6,7,8,9,10,11,12,13,16,20,32};
    count = (int)(sizeof(logs) / sizeof(logs[0]));
    return logs;
}

// exception stream for width b: [pos0, posgap-1 ..., high-1 ...]; returns
// false when infeasible (>255 exceptions or a stream value >= 2^28)
inline bool opt_exceptions(const uint32_t* v, int n, int b, std::vector<uint32_t>& stream) {
    stream.clear();
    if (b >= 32) return true;
    int prev = -1;
    int n_ex = 0;
    std::vector<uint32_t> highs;
    for (int i = 0; i < n; i++) {
        if (v[i] >= (uint32_t(1) << b)) {
            if (++n_ex > 255) return false;
            uint32_t h = v[i] >> b;
            if (h - 1 >= (uint32_t(1) << 28)) return false;
            if (prev < 0) stream.push_back((uint32_t)i);
            else stream.push_back((uint32_t)(i - prev - 1));
            highs.push_back(h - 1);
            prev = i;
        }
    }
    for (uint32_t h : highs) stream.push_back(h);
    for (uint32_t s : stream) if (s >= (uint32_t(1) << 28)) return false;
    return true;
}

inline void pack_bits(std::vector<uint32_t>& words, const uint32_t* v, int n, int b) {
    if (b == 0) return;
    size_t total = ((size_t)n * b + 31) / 32;
    size_t base = words.size();
    words.resize(base + total, 0);
    uint64_t mask = b < 32 ? ((uint64_t(1) << b) - 1) : 0xFFFFFFFFull;
    for (int i = 0; i < n; i++) {
        uint64_t off = (uint64_t)i * b;
        uint64_t val = (uint64_t)v[i] & mask;
        size_t widx = base + (off >> 5);
        int shift = (int)(off & 31);
        words[widx] |= (uint32_t)((val << shift) & 0xFFFFFFFFull);
        if (shift + b > 32) words[widx + 1] |= (uint32_t)(val >> (32 - shift));
    }
}

inline void optpfor_encode(Buf& out, const uint32_t* gaps, int n, uint32_t sum_of_values) {
    if (n < BLOCK_SIZE) { interp_encode(out, gaps, n, sum_of_values); return; }
    int nlogs;
    const int* logs = poss_logs(nlogs);
    std::vector<uint32_t> stream, tmp;
    int best_b = 32;
    long best_words = -1;
    for (int li = 0; li < nlogs; li++) {
        int b = logs[li];
        long slot_words = ((long)n * b + 31) / 32;
        long ex_words = 0;
        if (b < 32) {
            if (!opt_exceptions(gaps, n, b, stream)) continue;
            if (!stream.empty()) {
                tmp.clear();
                ex_words = simple16_encode(tmp, stream.data(), (int)stream.size());
            }
        }
        long total = slot_words + ex_words;
        if (best_words < 0 || total <= best_words) { best_b = b; best_words = total; }
    }
    int b = best_b;
    std::vector<uint32_t> slot;
    pack_bits(slot, gaps, n, b < 32 ? b : 32);
    std::vector<uint32_t> exw;
    int n_ex = 0;
    if (b < 32) {
        opt_exceptions(gaps, n, b, stream);
        // count actual exceptions (stream holds 2 entries per exception)
        n_ex = (int)(stream.size() / 2);
        if (!stream.empty()) simple16_encode(exw, stream.data(), (int)stream.size());
    }
    out.push_back((uint8_t)b);
    out.push_back((uint8_t)n_ex);
    for (uint32_t w : slot) put_u32(out, w);
    for (uint32_t w : exw) put_u32(out, w);
}

// varint.py G8IU: groups of 1 desc byte + 8 data bytes
inline void varint_encode(Buf& out, const uint32_t* vals, int n, uint32_t sum_of_values) {
    if (n < BLOCK_SIZE) { interp_encode(out, vals, n, sum_of_values); return; }
    int i = 0;
    while (i < n) {
        uint8_t desc = 0;
        uint8_t data[8];
        int used = 0;
        while (i < n) {
            uint32_t v = vals[i];
            int bl = v < (1u << 8) ? 1 : v < (1u << 16) ? 2 : v < (1u << 24) ? 3 : 4;
            if (used + bl > 8) break;
            for (int j = 0; j < bl; j++) data[used++] = (uint8_t)(v >> (8 * j));
            desc |= 1 << (used - 1);
            i++;
        }
        while (used < 8) data[used++] = 0;
        out.push_back(desc);
        out.insert(out.end(), data, data + 8);
    }
}

// QMX — the reference byte format (qmx_codec.hpp; native twin of
// codecs/qmx.py, byte-identical by test). 15 width classes, values
// striped over four 32-bit lanes per 16-byte payload word (4 classes
// use two words with straddling values), selector = (type<<4) |
// (~(batch-1)&0xF), selectors appended REVERSED after the payload,
// ds2i wrapper prefixes vbyte(enc_len).
namespace qmx {

static const int BITS_OF_TYPE[15] = {0,1,2,3,4,5,6,7,8,9,10,12,16,21,32};
static const int INTS_OF_TYPE[15] = {256,128,64,40,32,24,20,36,16,28,12,20,8,12,4};
// bits -> (type, ints); -1 for non-class widths
inline int type_of_bits(int w) {
    switch (w) {
        case 0: return 0; case 1: return 1; case 2: return 2; case 3: return 3;
        case 4: return 4; case 5: return 5; case 6: return 6; case 7: return 7;
        case 8: return 8; case 9: return 9; case 10: return 10; case 12: return 11;
        case 16: return 12; case 21: return 13; case 32: return 14;
        default: return -1;
    }
}
// decode-side payload advance per instance (bytes)
inline int adv_of_type(int t) {
    int w = BITS_OF_TYPE[t];
    if (t == 0) return 0;
    return (w == 7 || w == 9 || w == 12 || w == 21) ? 32 : 16;
}

inline uint8_t bits_needed_for(uint32_t v) {
    if (v == 0x01) return 0;
    if (v <= 0x01) return 1;
    if (v <= 0x03) return 2;
    if (v <= 0x07) return 3;
    if (v <= 0x0F) return 4;
    if (v <= 0x1F) return 5;
    if (v <= 0x3F) return 6;
    if (v <= 0x7F) return 7;
    if (v <= 0xFF) return 8;
    if (v <= 0x1FF) return 9;
    if (v <= 0x3FF) return 10;
    if (v <= 0xFFF) return 12;
    if (v <= 0xFFFF) return 16;
    if (v <= 0x1FFFFF) return 21;
    return 32;
}

// (type, lane) -> packed bit layout within the instance payload:
// value = bits[boff_a .. +wa) | bits[boff_b .. +wb) << wa
struct Lane { int16_t ba, wa, bb, wb; };
struct LaneTable {
    Lane tab[15][128];
    LaneTable() {
        memset(tab, 0, sizeof(tab));
        for (int t = 1; t < 15; t++) {
            int w = BITS_OF_TYPE[t];
            int ints = INTS_OF_TYPE[t];
            for (int j = 0; j < ints; j++) {
                Lane& L = tab[t][j];
                if (w == 8)  { L = {(int16_t)(j * 8), 8, 0, 0}; continue; }
                if (w == 16) { L = {(int16_t)(j * 16), 16, 0, 0}; continue; }
                if (w == 32) { L = {(int16_t)(j * 32), 32, 0, 0}; continue; }
                if (w != 7 && w != 9 && w != 12 && w != 21) {
                    L = {(int16_t)((j & 3) * 32 + (j >> 2) * w), (int16_t)w, 0, 0};
                    continue;
                }
                // two-word classes; word1 restart offsets are the
                // reference's hardcoded +3/+4/+8/+11
                int n0 = (w == 7) ? 16 : (w == 9) ? 12 : (w == 12) ? 8 : 4;
                int off1 = (w == 7) ? 3 : (w == 9) ? 4 : (w == 12) ? 8 : 11;
                int lo = 32 - (n0 >> 2) * w;
                if (j < n0) {
                    L = {(int16_t)((j & 3) * 32 + (j >> 2) * w), (int16_t)w, 0, 0};
                } else if (j < n0 + 4) {
                    L = {(int16_t)((j & 3) * 32 + (n0 >> 2) * w), (int16_t)lo,
                         (int16_t)(128 + (j & 3) * 32), (int16_t)(w - lo)};
                } else {
                    L = {(int16_t)(128 + (j & 3) * 32 + ((j - n0 - 4) >> 2) * w + off1),
                         (int16_t)w, 0, 0};
                }
            }
        }
    }
};
inline const LaneTable& lane_table() { static LaneTable lt; return lt; }

// assign per-value widths: group-of-4 max, end-of-block forcing,
// promotion cascade (qmx_codec.hpp encode steps 1-3)
inline void assign_widths(const uint32_t* vals, int bs, uint8_t* len_buf /* bs+512 */) {
    for (int i = 0; i < bs; i++) len_buf[i] = bits_needed_for(vals[i]);
    memset(len_buf + bs, 0, 512);

    for (int p = 0; p < bs + 4; p += 4) {
        uint8_t m = std::max(std::max(len_buf[p], len_buf[p + 1]),
                             std::max(len_buf[p + 2], len_buf[p + 3]));
        len_buf[p] = len_buf[p + 1] = len_buf[p + 2] = len_buf[p + 3] = m;
    }

    int p = 0;
    while (p < bs) {
        int rem = bs - p;
        if (rem < 4) {
            uint8_t largest = 0;
            for (int b = 0; b < 8; b++) largest = std::max(largest, len_buf[p + b]);
            if (largest <= 8)       for (int b = 0; b < 8; b++) len_buf[p + b] = 8;
            else if (largest <= 16) for (int b = 0; b < 8; b++) len_buf[p + b] = 16;
            else if (largest <= 32) for (int b = 0; b < 8; b++) len_buf[p + b] = 32;
        } else if (rem < 8) {
            uint8_t largest = 0;
            for (int b = 0; b < 8; b++) largest = std::max(largest, len_buf[p + b]);
            if (largest <= 8) for (int b = 0; b < 8; b++) len_buf[p + b] = 8;
            // (the reference repeats the <=8 test where <=16 was meant;
            // replicated as-is for byte identity)
        } else if (rem < 16) {
            uint8_t largest = 0;
            for (int b = 0; b < 16; b++) largest = std::max(largest, len_buf[p + b]);
            if (largest <= 8) for (int b = 0; b < 16; b++) len_buf[p + b] = 8;
        }

        int w = len_buf[p];
        int t = type_of_bits(w);
        if (t < 0) { abort(); }  // unreachable: cascade only yields classes
        int ints = INTS_OF_TYPE[t];
        static const int NEXT[33] = {1,2,3,4,5,6,7,8,9,10,12,0,16,0,0,0,21,
                                     0,0,0,0,32,0,0,0,0,0,0,0,0,0,0,64};
        int nxt = NEXT[w];
        bool promoted = false;
        for (int blk = 0; blk < ints; blk += 4) {
            if (len_buf[p + blk] > w) {
                len_buf[p] = len_buf[p + 1] = len_buf[p + 2] = len_buf[p + 3] = (uint8_t)nxt;
                promoted = true;
            }
        }
        if (!promoted && len_buf[p] == w) {
            for (int b = 0; b < ints; b++) len_buf[p + b] = (uint8_t)w;
            p += ints;
        }
    }
}

inline void pack_instance(Buf& dest, const uint32_t* vals, int t) {
    int w = BITS_OF_TYPE[t];
    int ints = INTS_OF_TYPE[t];
    int nbytes = adv_of_type(t);
    uint32_t lanes[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const LaneTable& lt = lane_table();
    for (int j = 0; j < ints; j++) {
        const Lane& L = lt.tab[t][j];
        uint64_t lowmask = (L.wa >= 32) ? 0xFFFFFFFFull : ((1ull << L.wa) - 1);
        uint32_t lo = (uint32_t)(vals[j] & lowmask);
        lanes[L.ba >> 5] |= lo << (L.ba & 31);
        if (L.wb) lanes[L.bb >> 5] |= (vals[j] >> L.wa) << (L.bb & 31);
    }
    for (int b = 0; b < nbytes; b++)
        dest.push_back((uint8_t)(lanes[b >> 2] >> (8 * (b & 3))));
    (void)w;
}

inline void write_out(Buf& dest, const uint32_t* vals, int raw_count, int bits, Buf& keys) {
    int t = type_of_bits(bits);
    int ints = INTS_OF_TYPE[t];
    int count = (raw_count + ints - 1) / ints;
    std::vector<uint32_t> padded(vals, vals + raw_count);
    padded.resize((size_t)count * ints, 0);
    int vi = 0;
    while (count > 0) {
        int batch = count > 16 ? 16 : count;
        keys.push_back((uint8_t)((t << 4) | (~(batch - 1) & 0x0F)));
        count -= batch;
        for (int c = 0; c < batch; c++) {
            if (bits == 0) {
                vi += 256;
            } else if (bits == 8 || bits == 16 || bits == 32) {
                // plain stores stop at the run's end (truncated tail)
                int size = bits / 8;
                int take = std::min(ints, std::max(0, raw_count - vi));
                for (int j = 0; j < take; j++)
                    for (int b = 0; b < size; b++)
                        dest.push_back((uint8_t)(padded[vi + j] >> (8 * b)));
                vi += ints;
            } else {
                pack_instance(dest, padded.data() + vi, t);
                vi += ints;
            }
        }
    }
}

inline size_t encode_block(Buf& out, const uint32_t* vals, int bs) {
    std::vector<uint8_t> len_buf(bs + 512);
    assign_widths(vals, bs, len_buf.data());

    size_t start = out.size();
    Buf keys;
    int rlen = 1;
    int bits = len_buf[0];
    for (int i = 1; i < bs; i++) {
        if (len_buf[i] == bits) {
            rlen++;
        } else {
            write_out(out, vals + i - rlen, rlen, bits, keys);
            bits = len_buf[i];
            rlen = 1;
        }
    }
    write_out(out, vals + bs - rlen, rlen, bits, keys);
    out.insert(out.end(), keys.rbegin(), keys.rend());
    return out.size() - start;
}

}  // namespace qmx

inline void qmx_encode(Buf& out, const uint32_t* vals, int n, uint32_t sum_of_values) {
    if (n < BLOCK_SIZE) { interp_encode(out, vals, n, sum_of_values); return; }
    Buf body;
    qmx::encode_block(body, vals, n);
    vbyte_encode(out, body.size());
    out.insert(out.end(), body.begin(), body.end());
}

using EncodeFn = void (*)(Buf&, const uint32_t*, int, uint32_t);

// block_index.py BlockPostingList.write: vbyte(n); u32 maxs[]; u32
// endpoints[blocks-1]; per block codec(docs gaps, known sum) +
// codec(freqs-1, unknown sum)
inline void write_list(Buf& out, const uint32_t* docs, const uint32_t* freqs,
                       long n, EncodeFn enc) {
    long blocks = (n + BLOCK_SIZE - 1) / BLOCK_SIZE;
    vbyte_encode(out, (uint64_t)n);
    size_t maxs_at = out.size();
    out.resize(out.size() + 4 * blocks + 4 * (blocks - 1));
    size_t body_at = out.size();

    Buf body;
    uint32_t gaps[BLOCK_SIZE], f1[BLOCK_SIZE];
    long block_base = 0;
    for (long b = 0; b < blocks; b++) {
        long lo = b * BLOCK_SIZE;
        long hi = std::min(lo + BLOCK_SIZE, n);
        int cur = (int)(hi - lo);
        uint32_t last_doc = docs[hi - 1];
        long prev = lo ? (long)docs[lo - 1] : -1;
        for (int j = 0; j < cur; j++) {
            gaps[j] = (uint32_t)((long)docs[lo + j] - prev - 1);
            prev = docs[lo + j];
            f1[j] = freqs[lo + j] - 1;
        }
        enc(body, gaps, cur, (uint32_t)(last_doc - block_base - (cur - 1)));
        enc(body, f1, cur, UNKNOWN_SUM);
        // patch max + endpoint
        uint32_t* maxs = (uint32_t*)nullptr;
        (void)maxs;
        size_t mp = maxs_at + 4 * b;
        out[mp] = last_doc & 0xFF; out[mp+1] = (last_doc >> 8) & 0xFF;
        out[mp+2] = (last_doc >> 16) & 0xFF; out[mp+3] = (last_doc >> 24) & 0xFF;
        if (b != blocks - 1) {
            uint32_t cursor = (uint32_t)body.size();
            size_t ep = maxs_at + 4 * blocks + 4 * b;
            out[ep] = cursor & 0xFF; out[ep+1] = (cursor >> 8) & 0xFF;
            out[ep+2] = (cursor >> 16) & 0xFF; out[ep+3] = (cursor >> 24) & 0xFF;
        }
        block_base = (long)last_doc + 1;
    }
    (void)body_at;
    out.insert(out.end(), body.begin(), body.end());
}

}  // namespace blockenc

extern "C" {

// Encode `count` posting lists (concatenated docs/freqs, offsets offs[i] ..
// offs[i+1]) into one malloc'd byte stream. codec: 0 optpfor, 1 varint,
// 2 interpolative, 3 qmx. Writes per-list end offsets into list_ends.
// Returns total bytes (free with ds2i_buffer_free), or -1 on error.
int64_t ds2i_block_write_batch(
    const uint32_t* docs, const uint32_t* freqs, const int64_t* offs,
    int64_t count, int codec, int nthreads,
    uint8_t** out_bytes, int64_t* list_ends)
{
    using namespace blockenc;
    EncodeFn enc = nullptr;
    switch (codec) {
        case 0: enc = optpfor_encode; break;
        case 1: enc = varint_encode; break;
        case 2: enc = [](Buf& o, const uint32_t* v, int n, uint32_t s) { interp_encode(o, v, n, s); }; break;
        case 3: enc = qmx_encode; break;
        default: return -1;
    }
    if (nthreads < 1) nthreads = 1;
    int nt = (int)std::min<int64_t>(nthreads, std::max<int64_t>(count, 1));
    std::vector<Buf> bufs(nt);
    std::vector<std::vector<int64_t>> ends(nt);
    int64_t chunk = (count + nt - 1) / nt;
    auto work = [&](int t) {
        int64_t lo = t * chunk, hi = std::min(count, lo + chunk);
        Buf& buf = bufs[t];
        for (int64_t i = lo; i < hi; i++) {
            write_list(buf, docs + offs[i], freqs + offs[i], offs[i + 1] - offs[i], enc);
            ends[t].push_back((int64_t)buf.size());
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    int64_t total = 0;
    for (auto& b : bufs) total += (int64_t)b.size();
    uint8_t* out = (uint8_t*)malloc(total ? total : 1);
    if (!out) return -1;
    int64_t pos = 0;
    int64_t li = 0;
    for (int t = 0; t < nt; t++) {
        if (!bufs[t].empty()) memcpy(out + pos, bufs[t].data(), bufs[t].size());
        for (int64_t e : ends[t]) list_ends[li++] = pos + e;
        pos += (int64_t)bufs[t].size();
    }
    *out_bytes = out;
    return total;
}

void ds2i_buffer_free(uint8_t* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched block tile-table builder.
//
// Native twin of engine/block_tiles.py build_block_tables: per 128-int
// block and per stream (docs, freqs), record the O(1) decode constants the
// device kernels need. The Python walk decodes every interpolative tail to
// find its bit length; at 20M+ postings that dominates engine init, so the
// whole walk runs here. Group statics come back as packed keys
// (kind | p1 | p2 | T) that Python un-interns with np.unique — identical
// tables and keys to the Python builder (tests/test_engine.py).

namespace blocktab {

constexpr uint32_t UNKNOWN_SUM = 0xFFFFFFFFu;
constexpr int TILE128 = 128;
// field columns (engine/tiles.py N_FIELDS layout + block_tiles.py reuse)
constexpr int NF = 11;
// cursors stored as (word index, bit-in-word): i32 word indexing
// addresses streams up to 8GB (block_tiles.py layout)
constexpr int F_KIND = 0, BF_W0 = 1, BF_B = 2, BF_NEX = 3, BF_EX_W0 = 4,
              BF_BOFF = 5, BF_EX_BOFF = 6, F_BASE = 8, F_NVALS = 9;
constexpr int KIND_OPT = 8, KIND_INTERP = 9, KIND_VAR = 10, KIND_QMX = 11;

inline int bucket(long v, const int* t, int n) {
    for (int i = 0; i < n; i++) if (v <= t[i]) return t[i];
    return t[n - 1];
}
const int E_BUCKETS[] = {0, 4, 8, 16, 32, 64, 128};
const int NC_BUCKETS[] = {8, 16, 32, 64, 128};
const int WIN_BUCKETS[] = {4, 16, 64, 180};
const int G_BUCKETS[] = {24, 40, 64};
const int NW_BUCKETS[] = {8, 16, 32};  // QMX instances per block (max 32)
const int S_BUCKETS[] = {8, 16, 32};   // QMX selectors per block (max 32)

inline uint32_t rd_u32(const uint8_t* d, long p) {
    return (uint32_t)d[p] | ((uint32_t)d[p + 1] << 8) |
           ((uint32_t)d[p + 2] << 16) | ((uint32_t)d[p + 3] << 24);
}

inline uint64_t vbyte_read(const uint8_t* d, long& p) {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
        uint8_t c = d[p++];
        v |= (uint64_t)(c & 0x7F) << shift;
        shift += 7;
        if (c & 0x80) break;
    }
    return v;
}

// simple16 mode sizes (values per selector)
const int S16_COUNT[16] = {28, 21, 21, 14, 12, 12, 7, 6, 6, 5, 5, 4, 3, 3, 2, 1};

inline int s16_words(const uint8_t* d, long pos, int nvals) {
    int got = 0, w = 0;
    while (got < nvals) {
        got += S16_COUNT[rd_u32(d, pos + 4 * w) >> 28];
        w++;
    }
    return w;
}

struct BitReader {
    const uint8_t* buf;
    long byte0;
    long word_idx = 0;
    int avail = 0;
    uint64_t acc = 0;
    long pos = 0;
    BitReader(const uint8_t* b, long p) : buf(b), byte0(p) {}
    uint64_t read(int length) {
        if (!length) return 0;
        while (avail < length) {
            acc |= (uint64_t)rd_u32(buf, byte0 + word_idx * 4) << avail;
            avail += 32;
            word_idx++;
        }
        uint64_t val = acc & ((length < 64) ? ((uint64_t(1) << length) - 1) : ~uint64_t(0));
        acc >>= length;
        avail -= length;
        pos += length;
        return val;
    }
    uint64_t read_int(uint64_t u) {
        int b = 63 - __builtin_clzll(u);
        uint64_t m = (uint64_t(1) << (b + 1)) - u;
        uint64_t val = read(b);
        if (val >= m) val = (val << 1) + read(1) - m;
        return val;
    }
    void walk(long n, uint64_t low, uint64_t high) {
        if (n <= 0) return;
        long h = n / 2;
        uint64_t val = low + read_int(high - low + 1);
        walk(h, low, val);
        walk(n - 1 - h, val, high);
    }
};

// returns end byte; fills row + packed key pieces
inline long interp_stream(const uint8_t* d, long pos, int cur, uint32_t known_sum,
                          int32_t* row, int& kind, int& p1, int& p2) {
    long q = pos;
    uint64_t s = known_sum;
    if (known_sum == UNKNOWN_SUM) s = vbyte_read(d, q);
    long end = q;
    if (cur > 1) {
        BitReader br(d, q);
        br.walk(cur - 1, 0, s);
        end = q + (br.pos + 7) / 8;
    }
    row[F_KIND] = KIND_INTERP;
    row[BF_W0] = (int32_t)(q >> 2);
    row[BF_BOFF] = (int32_t)((q & 3) * 8);
    row[BF_EX_W0] = (int32_t)s;
    row[F_NVALS] = cur;
    long bits = (end - q) * 8;
    kind = KIND_INTERP;
    p1 = bucket((31 + bits) / 32 + 1, WIN_BUCKETS, 4);
    p2 = 0;
    return end;
}

inline long opt_stream(const uint8_t* d, long pos, int cur, int32_t* row,
                       int& kind, int& p1, int& p2) {
    int b = d[pos];
    int nex = d[pos + 1];
    long sw = ((long)cur * (b < 32 ? b : 32) + 31) / 32;
    long ex_pos = pos + 2 + 4 * sw;
    int ew = nex ? s16_words(d, ex_pos, 2 * nex) : 0;
    row[F_KIND] = KIND_OPT;
    row[BF_W0] = (int32_t)((pos + 2) >> 2);
    row[BF_BOFF] = (int32_t)(((pos + 2) & 3) * 8);
    row[BF_B] = b;
    row[BF_NEX] = nex;
    row[BF_EX_W0] = (int32_t)(ex_pos >> 2);
    row[BF_EX_BOFF] = (int32_t)((ex_pos & 3) * 8);
    row[F_NVALS] = cur;
    kind = KIND_OPT;
    p1 = b;  // exact width (static-width kernel path)
    p2 = bucket(nex, E_BUCKETS, 7);
    return ex_pos + 4 * ew;
}

inline long var_stream(const uint8_t* d, long pos, int cur, int32_t* row,
                       int& kind, int& p1, int& p2) {
    int got = 0, g = 0;
    while (got < cur) {
        got += __builtin_popcount(d[pos + 9 * g]);
        g++;
    }
    row[F_KIND] = KIND_VAR;
    row[BF_W0] = (int32_t)(pos >> 2);
    row[BF_BOFF] = (int32_t)((pos & 3) * 8);
    row[BF_B] = g;
    row[F_NVALS] = cur;
    kind = KIND_VAR;
    p1 = bucket(g, G_BUCKETS, 3);
    p2 = 0;
    return pos + 9 * g;
}

inline long qmx_stream(const uint8_t* d, long pos, int cur, int32_t* row,
                       int& kind, int& p1, int& p2) {
    // Reference format: vbyte(enc_len), payload, selectors REVERSED at the
    // end. Replay the decoder's selector walk (while in <= keys) to count
    // selectors and instances (qmx_codec.hpp decode loop).
    long q = pos;
    uint64_t elen = vbyte_read(d, q);
    long in = q, keys = q + (long)elen - 1;
    long ns = 0, ninst = 0;
    while (in <= keys) {
        uint8_t sel = d[keys--];
        ns++;
        int t = sel >> 4;
        int batch = 16 - (sel & 0x0F);
        ninst += batch;
        in += (long)batch * blockenc::qmx::adv_of_type(t);
    }
    row[F_KIND] = KIND_QMX;
    row[BF_W0] = (int32_t)(q >> 2);
    row[BF_BOFF] = (int32_t)((q & 3) * 8);
    row[BF_B] = (int32_t)ninst;
    row[BF_NEX] = (int32_t)ns;
    row[BF_EX_W0] = (int32_t)((q + (long)elen - 1) >> 2);  // LAST selector byte
    row[BF_EX_BOFF] = (int32_t)((q + (long)elen - 1) & 3);
    row[F_NVALS] = cur;
    kind = KIND_QMX;
    p1 = bucket(ninst, NW_BUCKETS, 3);
    p2 = bucket(ns, S_BUCKETS, 3);
    return q + (long)elen;
}

// codec ids: 0 optpfor, 1 varint, 2 interpolative, 3 qmx, 4 mixed
// (mixed per-block type byte: 0 pfor, 1 varint, 2 interpolative)
inline long full_stream(const uint8_t* d, long pos, int cur, uint32_t known_sum,
                        int codec, int32_t* row, int& kind, int& p1, int& p2) {
    if (codec == 4) {
        int t = d[pos++];
        codec = (t == 0) ? 0 : (t == 1) ? 1 : 2;
    }
    switch (codec) {
        case 0: return opt_stream(d, pos, cur, row, kind, p1, p2);
        case 1: return var_stream(d, pos, cur, row, kind, p1, p2);
        case 3: return qmx_stream(d, pos, cur, row, kind, p1, p2);
        default: return interp_stream(d, pos, cur, known_sum, row, kind, p1, p2);
    }
}

}  // namespace blocktab

extern "C" {

// Pass 1 (fields == NULL): returns the total tile count.
// Pass 2: fills docs_fields/freqs_fields (n_tiles x 8 i32), tile_list
// (i64), list_tile_start (size+1 i64), dkey/fkey (i64 packed statics:
// kind<<40 | p1<<30 | p2<<20 | T). Thread-parallel over lists (pass 2)
// using per-list tile offsets computed in pass 1 via list_tile_start.
int64_t ds2i_block_tables(
    const uint8_t* data, const int64_t* list_offsets, int64_t size, int codec,
    int nthreads,
    int32_t* docs_fields, int32_t* freqs_fields, int64_t* tile_list,
    int64_t* list_tile_start, int64_t* dkey, int64_t* fkey)
{
    using namespace blocktab;
    if (docs_fields == nullptr) {
        int64_t tiles = 0;
        for (int64_t i = 0; i < size; i++) {
            long p = (long)list_offsets[i];
            uint64_t n = vbyte_read(data, p);
            tiles += (int64_t)((n + TILE128 - 1) / TILE128);
        }
        return tiles;
    }
    // per-list tile starts first (cheap scan), then parallel fill
    list_tile_start[0] = 0;
    for (int64_t i = 0; i < size; i++) {
        long p = (long)list_offsets[i];
        uint64_t n = vbyte_read(data, p);
        list_tile_start[i + 1] = list_tile_start[i] + (int64_t)((n + TILE128 - 1) / TILE128);
    }
    if (nthreads < 1) nthreads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            long p = (long)list_offsets[i];
            uint64_t n = vbyte_read(data, p);
            long blocks = (long)((n + TILE128 - 1) / TILE128);
            // header: maxs[blocks] + endpoints[blocks-1]
            long maxs_at = p;
            p += 4 * blocks + 4 * (blocks - 1);
            int64_t t0 = list_tile_start[i];
            long block_base = 0;
            for (long bi = 0; bi < blocks; bi++) {
                long lo_v = bi * TILE128;
                int cur = (int)std::min<long>(TILE128, (long)n - lo_v);
                long last = rd_u32(data, maxs_at + 4 * bi);
                int32_t* drow = docs_fields + (t0 + bi) * NF;
                int32_t* frow = freqs_fields + (t0 + bi) * NF;
                uint32_t sum_d = (uint32_t)(last - block_base - (cur - 1));
                int dk, dp1, dp2, fk, fp1, fp2, T;
                long p2, p3;
                if (cur == TILE128) {
                    p2 = full_stream(data, p, cur, sum_d, codec, drow, dk, dp1, dp2);
                    p3 = full_stream(data, p2, cur, UNKNOWN_SUM, codec, frow, fk, fp1, fp2);
                    T = TILE128;
                } else {
                    p2 = interp_stream(data, p, cur, sum_d, drow, dk, dp1, dp2);
                    p3 = interp_stream(data, p2, cur, UNKNOWN_SUM, frow, fk, fp1, fp2);
                    T = bucket(cur, NC_BUCKETS, 5);
                }
                drow[F_BASE] = (int32_t)block_base;
                tile_list[t0 + bi] = i;
                dkey[t0 + bi] = ((int64_t)dk << 40) | ((int64_t)dp1 << 30) | ((int64_t)dp2 << 20) | T;
                fkey[t0 + bi] = ((int64_t)fk << 40) | ((int64_t)fp1 << 30) | ((int64_t)fp2 << 20) | T;
                p = p3;
                block_base = last + 1;
            }
        }
    };
    int nt = (int)std::min<int64_t>(nthreads, std::max<int64_t>(size, 1));
    if (nt == 1 || size < 64) {
        work(0, size);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (size + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            int64_t lo = t * chunk, hi = std::min<int64_t>(size, lo + chunk);
            if (lo >= hi) break;
            ts.emplace_back(work, lo, hi);
        }
        for (auto& th : ts) th.join();
    }
    return list_tile_start[size];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched construction for the selector/partitioned index types
// (`single`, `uniform`, `opt`).
//
// Native twin of the Python writers in sequences/{selectors,partitioned}.py
// + freq_index headers, bit-identical (tests/test_native.py): each list is
// encoded into a thread-local bit buffer (docs: header + docs sequence;
// freqs: positive/strict sequence of the prefix sums), then all buffers
// are OR-blitted into the two collection bitvectors at exclusive-scan
// offsets. The partition DP reuses ds2i_optimal_partition's machinery.

namespace seqw {

constexpr uint64_t INF = uint64_t(1) << 62;

struct Params {
    int ef_s0, ef_s1, rb_rank, rb_sel;
    EFParams ef() const {
        return EFParams{(uint64_t)ef_s0, (uint64_t)ef_s1, (uint64_t)rb_rank, (uint64_t)rb_sel};
    }
};

struct Builder {
    std::vector<uint64_t> w;
    int64_t size = 0;

    void ensure_bits(int64_t bits) {
        size_t need = (size_t)((bits + 63) / 64) + 1;
        if (w.size() < need) w.resize(need, 0);
    }
    void or_at(int64_t pos, uint64_t value, int width) {
        if (width <= 0) return;
        if (width < 64) value &= (uint64_t(1) << width) - 1;
        int64_t wi = pos >> 6;
        int s = (int)(pos & 63);
        w[wi] |= value << s;
        if (s + width > 64) w[wi + 1] |= value >> (64 - s);
    }
    void append_bits(uint64_t value, int width) {
        ensure_bits(size + width);
        or_at(size, value, width);
        size += width;
    }
    void zero_extend(int64_t bits) {
        ensure_bits(size + bits);
        size += bits;
    }
    void append_builder(const Builder& o) {
        ensure_bits(size + o.size);
        int64_t nw = (o.size + 63) / 64;
        for (int64_t i = 0; i < nw; i++) {
            int width = (int)std::min<int64_t>(64, o.size - 64 * i);
            or_at(size + 64 * i, o.w[i], width);
        }
        size += o.size;
    }
    // gamma/delta (bitvec/codes.py)
    void gamma(uint64_t x) {
        uint64_t nn = x + 1;
        int l = (int)msb(nn);
        append_bits(uint64_t(1) << l, l + 1);
        append_bits(nn ^ (uint64_t(1) << l), l);
    }
    void gamma_nonzero(uint64_t x) { gamma(x - 1); }
    void delta(uint64_t x) {
        uint64_t nn = x + 1;
        int l = (int)msb(nn);
        gamma((uint64_t)l);
        append_bits(nn ^ (uint64_t(1) << l), l);
    }
};

// bit sizes come from the partition DP's shared formulas (EFParams
// versions near the top of this file) so the cost model and the writer
// can never disagree
inline uint64_t ef_bitsize(const Params& p, uint64_t universe, uint64_t n) {
    return ::ef_bitsize(p.ef(), universe, n);
}

inline uint64_t rb_bitsize(const Params& p, uint64_t universe, uint64_t n) {
    return ::rb_bitsize(p.ef(), universe, n);
}

// compact EF append at the builder's end (ef_write_one writes by OR)
inline void ef_append(Builder& b, const Params& p, const uint64_t* v, int64_t n, uint64_t universe) {
    int64_t base = b.size;
    b.zero_extend((int64_t)ef_bitsize(p, universe, (uint64_t)n));
    ef_write_one(b.w.data(), v, n, universe, base, p.ef_s0, p.ef_s1);
}

// ranked bitvector append (sequences/ef.py CompactRankedBitvector.write)
inline void rb_append(Builder& b, const Params& p, const uint64_t* v, int64_t n, uint64_t universe) {
    int64_t base = b.size;
    uint64_t rss = ceil_log2((uint64_t)n + 1);
    uint64_t ps = ceil_log2(universe);
    int64_t rank1_samples = (int64_t)(universe >> p.rb_rank);
    int64_t pointers1 = n >> p.rb_sel;
    int64_t rank_off = base;
    int64_t ptr_off = rank_off + rank1_samples * (int64_t)rss;
    int64_t bits_off = ptr_off + pointers1 * (int64_t)ps;
    b.zero_extend(bits_off - base + (int64_t)universe);

    for (int64_t i = 0; i < n; i++) {
        int64_t pos = bits_off + (int64_t)v[i];
        b.w[pos >> 6] |= uint64_t(1) << (pos & 63);
    }
    int64_t vi = 0;
    for (int64_t k = 1; k <= rank1_samples; k++) {
        uint64_t spos = (uint64_t)k << p.rb_rank;
        if (spos >= universe) break;
        while (vi < n && v[vi] < spos) vi++;  // rank = #ones strictly below
        b.or_at(rank_off + (k - 1) * (int64_t)rss, (uint64_t)vi, (int)rss);
    }
    for (int64_t k = 1; k <= pointers1; k++) {
        int64_t idx = k << p.rb_sel;
        if (idx >= n) break;
        b.or_at(ptr_off + (k - 1) * (int64_t)ps, v[idx], (int)ps);
    }
}

// selectors.py IndexedSequence/StrictSequence: choice + 1 type bit
// (all_ones implicit). strict: EF over u-n+1 of v-i, sampling disabled.
inline void indexed_append(Builder& b, const Params& p, const uint64_t* v, int64_t n,
                           uint64_t u, bool strict, std::vector<uint64_t>& scratch) {
    Params sp = strict ? Params{63, p.ef_s1, 63, p.rb_sel} : p;
    uint64_t best = (u == (uint64_t)n) ? 0 : INF;
    int type = 2;  // all_ones
    uint64_t ef = (strict ? ef_bitsize(sp, u - n + 1, n) : ef_bitsize(sp, u, n)) + 1;
    if (ef < best) { best = ef; type = 0; }
    uint64_t rb = rb_bitsize(sp, u, n) + 1;
    if (rb < best) { best = rb; type = 1; }
    if (u != (uint64_t)n) b.append_bits((uint64_t)type, 1);
    if (type == 0) {
        if (strict) {
            scratch.resize(n);
            for (int64_t i = 0; i < n; i++) scratch[i] = v[i] - (uint64_t)i;
            ef_append(b, sp, scratch.data(), n, u - n + 1);
        } else {
            ef_append(b, sp, v, n, u);
        }
    } else if (type == 1) {
        rb_append(b, sp, v, n, u);
    }
    // all_ones: nothing
}

// partitioned.py write; kind: 0 = single-partition container is N/A here —
// this is the partitioned container used by `uniform` (fixed 2^log) and
// `opt` (DP). strict_base selects StrictSequence partitions.
inline void partitioned_append(
    Builder& b, const Params& p, const uint64_t* v, int64_t n, uint64_t universe,
    bool uniform, bool strict_base, int log_part,
    double eps1, double eps2, uint64_t fix_cost,
    std::vector<uint32_t>& part_scratch, std::vector<uint64_t>& scratch,
    std::vector<uint64_t>& scratch2)
{
    // partition points (ends), 1-based positions
    part_scratch.clear();
    if (uniform) {
        int64_t psz = int64_t(1) << log_part;
        for (int64_t e = psz; e < n; e += psz) part_scratch.push_back((uint32_t)e);
        part_scratch.push_back((uint32_t)n);
    } else {
        // reuse the DP (values fit u32 per caller contract)
        std::vector<uint32_t> v32(n);
        for (int64_t i = 0; i < n; i++) v32[i] = (uint32_t)v[i];
        part_scratch.resize(n + 1);
        long cnt = ds2i_optimal_partition(
            v32.data(), (uint64_t)n, universe, eps1, eps2, fix_cost,
            strict_base ? 1 : 0, (uint64_t)p.ef_s0, (uint64_t)p.ef_s1,
            (uint64_t)p.rb_rank, (uint64_t)p.rb_sel,
            part_scratch.data(), (uint64_t)part_scratch.size());
        part_scratch.resize(cnt);
    }
    int64_t partitions = (int64_t)part_scratch.size();
    b.gamma_nonzero((uint64_t)partitions);

    if (partitions == 1) {
        uint64_t cur_base = v[0];
        scratch.resize(n);
        for (int64_t i = 0; i < n; i++) scratch[i] = v[i] - cur_base;
        uint64_t ub = ceil_log2(universe);
        b.append_bits(cur_base, (int)ub);
        if (n > 1) {
            if (cur_base + scratch[n - 1] + 1 == universe) b.delta(0);
            else b.delta(scratch[n - 1]);
        }
        indexed_append(b, p, scratch.data(), n, scratch[n - 1] + 1, strict_base, scratch2);
        return;
    }

    Builder seqs;
    std::vector<uint64_t> endpoints, ubs;
    ubs.push_back(v[0]);
    uint64_t cur_base = v[0];
    int64_t cur_i = 0;
    for (int64_t pi = 0; pi < partitions; pi++) {
        int64_t pend = (int64_t)part_scratch[pi];
        int64_t m = pend - cur_i;
        scratch.resize(m);
        for (int64_t i = 0; i < m; i++) scratch[i] = v[cur_i + i] - cur_base;
        uint64_t ub = v[pend - 1];
        indexed_append(seqs, p, scratch.data(), m, scratch[m - 1] + 1, strict_base, scratch2);
        endpoints.push_back((uint64_t)seqs.size);
        ubs.push_back(ub);
        cur_base = ub + 1;
        cur_i = pend;
    }
    uint64_t endpoint_bits = ceil_log2((uint64_t)seqs.size + 1);
    b.gamma(endpoint_bits);
    if (!uniform) {
        // sizes stream: EF of ends[:-1] over universe n
        scratch.resize(partitions - 1);
        for (int64_t i = 0; i < partitions - 1; i++) scratch[i] = part_scratch[i];
        ef_append(b, p, scratch.data(), partitions - 1, (uint64_t)n);
    }
    ef_append(b, p, ubs.data(), (int64_t)ubs.size(), universe);
    for (int64_t i = 0; i + 1 < (int64_t)endpoints.size(); i++)
        b.append_bits(endpoints[i], (int)endpoint_bits);
    b.append_builder(seqs);
}

}  // namespace seqw

extern "C" {

// kind: 0 = single (indexed docs, strict-seq freqs)
//       1 = uniform, 2 = opt (partitioned containers)
// freqs passed RAW (positive); prefix sums are taken here.
// SINGLE pass: each thread encodes its list range into one contiguous
// bit buffer (so the partition DP runs exactly once per list), then the
// thread buffers are bit-blitted into malloc'd outputs. d_ends/f_ends
// receive per-list exclusive-scan BIT offsets; *d_words/*f_words the
// malloc'd word buffers (free with ds2i_buffer_free); returns total
// docs-stream bits via *d_bits and freq bits via *f_bits.
int64_t ds2i_seq_write_batch_v2(
    int kind,
    const uint64_t* docs, const uint64_t* freqs, const int64_t* voff,
    int64_t count, uint64_t num_docs, const uint64_t* occs,
    int ef_s0, int ef_s1, int rb_rank, int rb_sel, int log_part,
    double eps1, double eps2, uint64_t fix_cost, int nthreads,
    uint64_t** d_words, int64_t* d_bits, int64_t* d_ends,
    uint64_t** f_words, int64_t* f_bits, int64_t* f_ends)
{
    using namespace seqw;
    Params p{ef_s0, ef_s1, rb_rank, rb_sel};
    if (nthreads < 1) nthreads = 1;
    int nt = (int)std::min<int64_t>(nthreads, std::max<int64_t>(count, 1));
    if (count < 128) nt = 1;

    std::vector<Builder> dbufs(nt), fbufs(nt);
    int64_t chunk = (count + nt - 1) / nt;

    auto work = [&](int t) {
        int64_t lo = t * chunk, hi = std::min<int64_t>(count, lo + chunk);
        std::vector<uint64_t> cum, scratch, scratch2;
        std::vector<uint32_t> parts;
        Builder& db = dbufs[t];
        Builder& fb = fbufs[t];
        for (int64_t i = lo; i < hi; i++) {
            int64_t n = voff[i + 1] - voff[i];
            const uint64_t* dv = docs + voff[i];
            uint64_t occ = occs[i];
            int64_t d0 = db.size, f0 = fb.size;

            // freq_index docs header (freq_index.hpp:68-73)
            db.gamma_nonzero(occ);
            if (occ > 1) db.append_bits((uint64_t)n, (int)ceil_log2(occ + 1));
            // docs sequence over universe num_docs
            if (kind == 0) {
                indexed_append(db, p, dv, n, num_docs, false, scratch2);
            } else {
                partitioned_append(db, p, dv, n, num_docs, kind == 1, false, log_part,
                                   eps1, eps2, fix_cost, parts, scratch, scratch2);
            }

            // freqs: prefix sums, universe occ + 1
            cum.resize(n);
            uint64_t c = 0;
            const uint64_t* fv = freqs + voff[i];
            for (int64_t j = 0; j < n; j++) { c += fv[j]; cum[j] = c; }
            if (kind == 0) {
                indexed_append(fb, p, cum.data(), n, occ + 1, true, scratch2);
            } else {
                partitioned_append(fb, p, cum.data(), n, occ + 1, kind == 1, true, log_part,
                                   eps1, eps2, fix_cost, parts, scratch, scratch2);
            }
            d_ends[i] = db.size - d0;  // per-list bit sizes for now
            f_ends[i] = fb.size - f0;
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }

    // exclusive scan of per-list sizes -> global bit offsets
    int64_t dtot = 0, ftot = 0;
    for (int64_t i = 0; i < count; i++) {
        int64_t ds = d_ends[i], fs = f_ends[i];
        d_ends[i] = dtot; f_ends[i] = ftot;
        dtot += ds; ftot += fs;
    }
    *d_bits = dtot; *f_bits = ftot;
    uint64_t* dw = (uint64_t*)calloc((size_t)(dtot + 63) / 64 + 1, 8);
    uint64_t* fw = (uint64_t*)calloc((size_t)(ftot + 63) / 64 + 1, 8);
    if (!dw || !fw) { free(dw); free(fw); return -1; }
    int64_t dpos = 0, fpos = 0;
    for (int t = 0; t < nt; t++) {
        Builder& db = dbufs[t];
        for (int64_t wi = 0; wi * 64 < db.size; wi++) {
            int width = (int)std::min<int64_t>(64, db.size - 64 * wi);
            or_bits(dw, dpos + 64 * wi, db.w[wi], width);
        }
        dpos += db.size;
        std::vector<uint64_t>().swap(db.w);  // cap peak memory during blit
        Builder& fb = fbufs[t];
        for (int64_t wi = 0; wi * 64 < fb.size; wi++) {
            int width = (int)std::min<int64_t>(64, fb.size - 64 * wi);
            or_bits(fw, fpos + 64 * wi, fb.w[wi], width);
        }
        fpos += fb.size;
        std::vector<uint64_t>().swap(fb.w);
    }
    *d_words = dw; *f_words = fw;
    return 0;
}

}  // extern "C"

// ============================================================================
// Native CPU query engine — reference-style cursors over block indexes.
//
// The modern-CPU serving path AND the measured same-machine baseline for
// BASELINE.md: block_posting_list document_enumerator semantics
// (block_posting_list.hpp:84-331 — one docs block decoded at a time,
// freqs lazily, next_geq via linear block_maxs scan) driving the
// queries.hpp operators (and_query:35-86, or_query:88-131,
// ranked_and:322-401, ranked_or:404-476) with the scores-only topk_queue
// (queries.hpp:152-197) and bm25 weights (bm25.hpp).
// Codecs: OptPFor(+Simple16) full blocks, interpolative partials —
// byte-identical twins of codecs/{optpfor,simple16,interpolative}.py.
// ============================================================================

namespace cpuq {

using blocktab::vbyte_read;
using blocktab::rd_u32;

constexpr uint32_t UNKNOWN_SUM = 0xFFFFFFFFu;
constexpr int BS = 128;

// simple16 per-mode widths (codecs/simple16.py S16_MODES)
struct S16Tab {
    int8_t widths[16][28];
    int8_t counts[16];
    S16Tab() {
        static const int modes[16][4][2] = {
            {{28,1},{0,0}}, {{7,2},{14,1}}, {{14,1},{7,2}}, {{14,2},{0,0}},
            {{4,3},{8,2}}, {{8,2},{4,3}}, {{7,4},{0,0}}, {{4,5},{2,4}},
            {{2,4},{4,5}}, {{3,6},{2,5}}, {{2,5},{3,6}}, {{4,7},{0,0}},
            {{2,9},{1,10}}, {{1,10},{2,9}}, {{2,14},{0,0}}, {{1,28},{0,0}},
        };
        for (int m = 0; m < 16; m++) {
            int k = 0;
            for (int r = 0; r < 4; r++)
                for (int c = 0; c < modes[m][r][0]; c++) widths[m][k++] = (int8_t)modes[m][r][1];
            counts[m] = (int8_t)k;
        }
    }
};
inline const S16Tab& s16tab() { static S16Tab t; return t; }

// decode nvals simple16 values at byte pos; returns words consumed
inline int s16_decode(const uint8_t* d, long pos, int nvals, uint32_t* out) {
    const S16Tab& T = s16tab();
    int got = 0, w = 0;
    while (got < nvals) {
        uint32_t word = rd_u32(d, pos + 4 * w);
        int sel = word >> 28;
        uint32_t payload = word & 0x0FFFFFFF;
        int cnt = T.counts[sel];
        int shift = 0;
        for (int j = 0; j < cnt && got < nvals; j++) {
            int width = T.widths[sel][j];
            out[got++] = (payload >> shift) & ((1u << width) - 1);
            shift += width;
        }
        w++;
    }
    return w;
}

// interpolative decode (codecs/interpolative.py BitReader32 semantics)
struct BitRd {
    const uint8_t* buf; long byte0; long word_idx = 0; int avail = 0;
    uint64_t acc = 0; long pos = 0;
    BitRd(const uint8_t* b, long p) : buf(b), byte0(p) {}
    uint32_t read(int len) {
        if (!len) return 0;
        while (avail < len) {
            acc |= (uint64_t)rd_u32(buf, byte0 + word_idx * 4) << avail;
            avail += 32; word_idx++;
        }
        uint32_t v = (uint32_t)(acc & ((len < 64) ? ((1ull << len) - 1) : ~0ull));
        acc >>= len; avail -= len; pos += len;
        return v;
    }
    uint32_t read_int(uint64_t u) {
        int b = 63 - __builtin_clzll(u);
        uint64_t m = (1ull << (b + 1)) - u;
        uint64_t v = read(b);
        if (v >= m) v = (v << 1) + read(1) - m;
        return (uint32_t)v;
    }
    void walk(uint32_t* out, int lo_i, int hi_i, uint32_t low, uint32_t high) {
        int n = hi_i - lo_i;
        if (n <= 0) return;
        int h = lo_i + n / 2;
        uint32_t val = low + read_int((uint64_t)high - low + 1);
        out[h] = val;
        walk(out, lo_i, h, low, val);
        walk(out, h + 1, hi_i, val, high);
    }
};

inline long interp_dec(const uint8_t* d, long pos, uint32_t sum, int n, uint32_t* out) {
    uint64_t s = sum;
    if (sum == UNKNOWN_SUM) s = vbyte_read(d, pos);
    uint32_t cum[BS];
    cum[n - 1] = (uint32_t)s;
    long consumed = 0;
    if (n > 1) {
        BitRd br(d, pos);
        br.walk(cum, 0, n - 1, 0, (uint32_t)s);
        consumed = (br.pos + 7) / 8;
    }
    out[0] = cum[0];
    for (int i = 1; i < n; i++) out[i] = cum[i] - cum[i - 1];
    return pos + consumed;
}

inline long opt_dec(const uint8_t* d, long pos, uint32_t sum, int n, uint32_t* out) {
    if (n < BS) return interp_dec(d, pos, sum, n, out);
    int b = d[pos], n_ex = d[pos + 1];
    pos += 2;
    int bb = b < 32 ? b : 32;
    long slot_words = ((long)n * bb + 31) / 32;
    if (bb == 0) {
        for (int i = 0; i < n; i++) out[i] = 0;
    } else {
        long bit = 0;
        for (int i = 0; i < n; i++, bit += bb) {
            long w = bit >> 5; int s = (int)(bit & 31);
            uint64_t x = rd_u32(d, pos + 4 * w);
            if (s + bb > 32) x |= (uint64_t)rd_u32(d, pos + 4 * (w + 1)) << 32;
            out[i] = (uint32_t)((x >> s) & ((bb >= 32) ? 0xFFFFFFFFull : ((1ull << bb) - 1)));
        }
    }
    pos += 4 * slot_words;
    if (n_ex) {
        uint32_t ex[2 * BS];
        int used = s16_decode(d, pos, 2 * n_ex, ex);
        pos += 4 * used;
        uint32_t p = 0;
        for (int e = 0; e < n_ex; e++) {
            p = e ? p + ex[e] + 1 : ex[0];
            out[p] |= (ex[n_ex + e] + 1) << b;
        }
    }
    return pos;
}

struct Cursor {
    const uint8_t* data;
    long n = 0, blocks = 0;
    long maxs_at = 0, endp_at = 0, body = 0;
    long cur_block = -1;
    int cur_size = 0;
    uint32_t block_base = 0;
    long freq_pos = -1;  // freqs byte pos of cur block (decoded lazily)
    bool freqs_done = false;
    long pos_in_block = 0;
    long position = 0;
    uint32_t docs_buf[BS], freqs_buf[BS];
    float qw = 0.0f;
    uint32_t universe = 0;

    void open(const uint8_t* d, long off, uint32_t num_docs) {
        data = d;
        long p = off;
        n = (long)vbyte_read(d, p);
        blocks = (n + BS - 1) / BS;
        maxs_at = p;
        endp_at = p + 4 * blocks;
        body = endp_at + 4 * (blocks - 1);
        universe = num_docs;
        cur_block = -1;
        position = 0;
        decode_block(0);
    }
    uint32_t block_max(long b) const { return rd_u32(data, maxs_at + 4 * b); }
    long block_off(long b) const {
        return body + (b ? (long)rd_u32(data, endp_at + 4 * (b - 1)) : 0);
    }
    void decode_block(long b) {
        cur_block = b;
        long lo = b * BS;
        cur_size = (int)std::min<long>(BS, n - lo);
        block_base = b ? block_max(b - 1) + 1 : 0;
        uint32_t last = block_max(b);
        long p = opt_dec(data, block_off(b), last - block_base - (cur_size - 1),
                         cur_size, docs_buf);
        // prefix-sum gaps -> docids
        uint32_t acc = block_base;
        for (int i = 0; i < cur_size; i++) {
            acc += docs_buf[i] + (i ? 1 : 0);
            docs_buf[i] = acc;
        }
        freq_pos = p;
        freqs_done = false;
        pos_in_block = 0;
    }
    uint32_t docid() const {
        return position < n ? docs_buf[pos_in_block] : universe;
    }
    uint32_t freq() {
        if (!freqs_done) {
            uint32_t tmp[BS];
            opt_dec(data, freq_pos, UNKNOWN_SUM, cur_size, tmp);
            for (int i = 0; i < cur_size; i++) freqs_buf[i] = tmp[i] + 1;
            freqs_done = true;
        }
        return freqs_buf[pos_in_block];
    }
    void next() {
        position++;
        if (position >= n) return;
        if (++pos_in_block == cur_size) decode_block(cur_block + 1);
    }
    void next_geq(uint32_t lb) {
        if (position >= n) return;
        if (lb > block_max(cur_block)) {
            // linear block_maxs scan (block_posting_list.hpp:124-146)
            long b = cur_block + 1;
            while (b + 1 < blocks && block_max(b) < lb) b++;
            if (block_max(b) < lb) { position = n; return; }
            decode_block(b);
            position = b * BS;
        }
        while (docs_buf[pos_in_block] < lb) {
            pos_in_block++; position++;
            if (pos_in_block == cur_size) {
                if (cur_block + 1 >= blocks) { position = n; return; }
                decode_block(cur_block + 1);
                position = cur_block * BS;
            }
        }
    }
};

// scores-only top-k min-heap (queries.hpp:152-197)
struct TopK {
    float* heap; int k; int size = 0;
    TopK(float* buf, int kk) : heap(buf), k(kk) {}
    bool would_enter(float s) const { return size < k || s > heap[0]; }
    void insert(float s) {
        if (size < k) {
            heap[size++] = s;
            std::push_heap(heap, heap + size, std::greater<float>());
        } else if (s > heap[0]) {
            std::pop_heap(heap, heap + size, std::greater<float>());
            heap[size - 1] = s;
            std::push_heap(heap, heap + size, std::greater<float>());
        }
    }
    void finalize() { std::sort_heap(heap, heap + size, std::greater<float>()); }
};

constexpr float K1 = 1.2f, B = 0.5f;
inline float dtw(uint32_t f, float nl) {
    float ff = (float)f;
    return ff / (ff + K1 * (1.0f - B + B * nl));
}

}  // namespace cpuq

extern "C" {

// Native CPU cursor query over a block_optpfor index. op: 0 and-count,
// 1 or-count, 2 ranked_and, 3 ranked_or. Queries CSR: qterms/qweights
// flat, qoffs[num_queries+1]. out_scores: (num_queries * k) f32, padded
// with -inf; out_counts: per-query result counts. Returns 0, or -1 on
// bad input.
int64_t ds2i_cpu_block_query(
    const uint8_t* data, const int64_t* endpoints, int64_t num_lists,
    const float* norm_lens, int64_t num_docs,
    const int64_t* qterms, const float* qweights, const int64_t* qoffs,
    int64_t num_queries, int op, int k,
    float* out_scores, int64_t* out_counts, double* out_us /* nullable */)
{
    using namespace cpuq;
    std::vector<Cursor> curs;
    std::vector<float> heapbuf(k > 0 ? k : 1);
    for (int64_t q = 0; q < num_queries; q++) {
        auto t_start = std::chrono::steady_clock::now();
        long t0 = qoffs[q], t1 = qoffs[q + 1];
        int nt = (int)(t1 - t0);
        curs.clear();
        curs.resize(nt);
        for (int i = 0; i < nt; i++) {
            int64_t t = qterms[t0 + i];
            if (t < 0 || t >= num_lists) return -1;
            curs[i].open(data, endpoints[t], (uint32_t)num_docs);
            curs[i].qw = qweights[t0 + i];
        }
        float* out_q = out_scores + q * k;
        for (int i = 0; i < k; i++) out_q[i] = -std::numeric_limits<float>::infinity();
        out_counts[q] = 0;
        if (nt == 0) continue;

        if (op == 0 || op == 2) {
            // leapfrog intersection, shortest list first (queries.hpp:53-82)
            std::sort(curs.begin(), curs.end(),
                      [](const Cursor& a, const Cursor& b) { return a.n < b.n; });
            TopK topk(heapbuf.data(), k);
            uint64_t results = 0;
            uint32_t candidate = curs[0].docid();
            size_t i = 1;
            while (candidate < num_docs) {
                for (; i < curs.size(); i++) {
                    curs[i].next_geq(candidate);
                    if (curs[i].docid() != candidate) {
                        candidate = curs[i].docid();
                        i = 0;
                        break;
                    }
                }
                if (i == curs.size()) {
                    results++;
                    if (op == 2) {
                        float nl = norm_lens[candidate];
                        float score = 0.0f;
                        for (auto& c : curs) score += c.qw * dtw(c.freq(), nl);
                        topk.insert(score);
                    }
                    curs[0].next();
                    candidate = curs[0].docid();
                    i = 1;
                }
            }
            out_counts[q] = (int64_t)results;
            if (op == 2) {
                topk.finalize();
                for (int i2 = 0; i2 < topk.size; i2++) out_q[i2] = topk.heap[i2];
                out_counts[q] = topk.size;
            }
        } else {
            // DAAT union (queries.hpp:88-131 / ranked_or :404-476)
            TopK topk(heapbuf.data(), k);
            uint64_t results = 0;
            uint32_t cur_doc = (uint32_t)num_docs;
            for (auto& c : curs) cur_doc = std::min(cur_doc, c.docid());
            while (cur_doc < num_docs) {
                results++;
                float score = 0.0f;
                uint32_t next_doc = (uint32_t)num_docs;
                for (auto& c : curs) {
                    if (c.docid() == cur_doc) {
                        if (op == 3) score += c.qw * dtw(c.freq(), norm_lens[cur_doc]);
                        c.next();
                    }
                    next_doc = std::min(next_doc, c.docid());
                }
                if (op == 3) topk.insert(score);
                cur_doc = next_doc;
            }
            out_counts[q] = (int64_t)results;
            if (op == 3) {
                topk.finalize();
                for (int i2 = 0; i2 < topk.size; i2++) out_q[i2] = topk.heap[i2];
                out_counts[q] = topk.size;
            }
        }
        if (out_us) {
            out_us[q] = std::chrono::duration<double, std::micro>(
                std::chrono::steady_clock::now() - t_start).count();
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Resident exception patch tables (engine/block_tiles.build_exception_patches
// native twin): decode each OptPFor row's Simple16 exception stream ONCE into
// (slot position, high<<b) u32 pairs, interleaved at out[2*base[r]]. The
// stream layout is block_codecs.hpp:203-216's [first pos, pos gaps - 1,
// high parts - 1]; byte-identical output to the vectorized numpy builder
// (tested). Thread-parallel over rows.

extern "C" {

void ds2i_s16_exception_patches(
    const uint8_t* data, int64_t nbytes,
    const int32_t* w0, const int32_t* boff, const int32_t* nex,
    const int32_t* b, const int64_t* base, int64_t nrows,
    uint32_t* out, int nthreads)
{
    const blockenc::S16Mode* modes = blockenc::s16_modes();
    auto rd32_at_bit = [&](int64_t bit) -> uint32_t {
        int64_t byte = bit >> 3;
        int sh = (int)(bit & 7);
        uint64_t v = 0;
        for (int i = 0; i < 8 && byte + i < nbytes; i++)
            v |= (uint64_t)data[byte + i] << (8 * i);
        return (uint32_t)(v >> sh);
    };
    auto work = [&](int64_t lo, int64_t hi) {
        uint32_t vals[260];
        for (int64_t r = lo; r < hi; r++) {
            int K = 2 * nex[r];
            if (K <= 0) continue;
            int64_t bit = (int64_t)(uint32_t)w0[r] * 32 + boff[r];
            int got = 0;
            while (got < K) {
                uint32_t word = rd32_at_bit(bit);
                bit += 32;
                const blockenc::S16Mode& m = modes[word >> 28];
                uint32_t payload = word & 0x0FFFFFFFu;
                int sh = 0;
                for (int i = 0; i < m.cnt && got < K; i++) {
                    int wd = m.widths[i];
                    vals[got++] = (payload >> sh) & ((wd >= 32) ? 0xFFFFFFFFu : ((1u << wd) - 1));
                    sh += wd;
                }
            }
            uint32_t* o = out + 2 * base[r];
            uint32_t pos = 0;
            int n = nex[r];
            for (int i = 0; i < n; i++) {
                pos = i == 0 ? vals[0] : pos + vals[i] + 1;
                uint32_t high = vals[n + i] + 1;
                o[2 * i] = pos;
                o[2 * i + 1] = (b[r] < 32) ? (high << b[r]) : 0;
            }
        }
    };
    if (nthreads < 1) nthreads = 1;
    int nt = (int)std::min<int64_t>(nthreads, std::max<int64_t>(nrows, 1));
    if (nt == 1 || nrows < 4096) {
        work(0, nrows);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (nrows + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            int64_t lo = t * chunk, hi = std::min<int64_t>(nrows, lo + chunk);
            if (lo >= hi) break;
            ts.emplace_back(work, lo, hi);
        }
        for (auto& th : ts) th.join();
    }
}

}  // extern "C"
