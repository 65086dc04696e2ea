// The ncc host tier: exact search, exact f64 replay and post-processing
// scans in C++ (g++ -O3 -march=native -ffp-contract=off -fopenmp, built by
// native/build.py::build_host, bound with ctypes by native/ncc_cpu.py).
//
// Counterpart of focr_tpu/native/ncc_kernel.cpp: its search, replay and
// winner-scan entry points with the same semantics; post-processing of a
// whole page in one call (focr_post_page); and one more for the page reader
// (focr_png_unfilter). This is host code, not a device kernel: the
// matcher's device stage (K1 sweep + K2 compaction) returns candidate
// positions, and focr_ncc_replay_pos_u8 decides each of them exactly here.
//
// Semantics (focr_tpu_torch/oracle/ncc_oracle.py is the bit-exact spec):
//   * search domain y in [1, r_h-n_h+1), x in per-row [start, end)
//   * integer correlation acc (exact)
//   * f64 similarity  sim = (acc - (s_n*s_p)*(1/n)) * (rnorm_n * rnorm_p)
//     in the reference's association and order (ncc.cpp:206-215)
//   * emit iff sim != +inf && sim > (f64)(f32)threshold, in scan order
//   * stop at capacity (ncc.cpp:222-229)
//
// A zero-variance window gives rnorm_p = inf and num = 0, so sim = nan and
// the comparison drops it: no special case. Bit parity with the NumPy replay
// needs every f64 op to round on its own: the build passes -ffp-contract=off,
// without which gcc fuses the multiply-subtracts into FMAs and about 28% of
// similarities change in the last bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <limits>
#include <vector>

#include <omp.h>

namespace {

struct FMatch {
    uint16_t x;
    uint16_t y;
    float similarity;
};

}  // namespace

extern "C" {

// Search one needle over one page (n_w <= 16: the FMatch coordinates and the
// reference's own width limit). Returns the number of matches written
// (<= cap); negative on argument errors.
int64_t focr_ncc_search_u8(
    const uint8_t* ref, int64_t r_w, int64_t r_h,
    const uint8_t* needle, int64_t n_w, int64_t n_h,
    const int64_t* patch_sum,    // [r_h * r_w], valid inside [start, end)
    const double* patch_rnorm,   // [r_h * r_w]
    const int64_t* start_end,    // [r_h][2]
    float threshold,
    FMatch* out, int64_t cap) {
    if (n_w > r_w || n_h > r_h || n_w <= 0 || n_h <= 0 || cap < 0) return -1;

    const int64_t n = n_w * n_h;
    int64_t s_n = 0, s2_n = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t v = needle[i];
        s_n += v;
        s2_n += v * v;
    }
    const double n_recip = 1.0 / static_cast<double>(n);
    const double norm2_n =
        static_cast<double>(s2_n) -
        static_cast<double>(s_n) * static_cast<double>(s_n) / static_cast<double>(n);
    const double rnorm_n = 1.0 / std::sqrt(norm2_n);
    const double thr = static_cast<double>(threshold);  // f64 of the f32 value
    const double s_n_d = static_cast<double>(s_n);
    const double inf = std::numeric_limits<double>::infinity();

    const int64_t y_searches = r_h - n_h + 1;
    std::vector<int32_t> acc(static_cast<size_t>(r_w));
    int64_t count = 0;

    for (int64_t y = 1; y < y_searches; ++y) {
        const int64_t start = start_end[2 * y];
        const int64_t end = start_end[2 * y + 1];
        if (start >= end) continue;
        const int64_t span = end - start;

        // one needle row at a time into a stride-1 i32 span: the compiler
        // vectorizes it to the u8 -> i16 -> i32 multiply-add the reference
        // hand-codes (ncc.cpp:106-142)
        int32_t* a = acc.data();
        for (int64_t i = 0; i < span; ++i) a[i] = 0;
        for (int64_t dy = 0; dy < n_h; ++dy) {
            const uint8_t* row = ref + (y + dy) * r_w + start;
            const uint8_t* nd = needle + dy * n_w;
            for (int64_t dx = 0; dx < n_w; ++dx) {
                const int32_t nv = nd[dx];
                if (nv == 0) continue;
                const uint8_t* r = row + dx;
                for (int64_t i = 0; i < span; ++i) {
                    a[i] += nv * static_cast<int32_t>(r[i]);
                }
            }
        }

        const int64_t* sp_row = patch_sum + y * r_w;
        const double* rn_row = patch_rnorm + y * r_w;
        for (int64_t i = 0; i < span; ++i) {
            const int64_t x = start + i;
            const double num =
                static_cast<double>(a[i]) -
                (s_n_d * static_cast<double>(sp_row[x])) * n_recip;
            const double sim = num * (rnorm_n * rn_row[x]);
            if (sim != inf && sim > thr) {
                if (count >= cap) return count;  // scan-order truncation
                out[count].x = static_cast<uint16_t>(x);
                out[count].y = static_cast<uint16_t>(y);
                out[count].similarity = static_cast<float>(sim);
                ++count;
            }
        }
    }
    return count;
}

// Search T needles of one size over one page, each into its own slice of
// `cap` entries; counts[t] receives each needle's match count. OpenMP across
// needles (the reference's rayon fan-out, main.rs:442).
void focr_ncc_search_many_u8(
    const uint8_t* ref, int64_t r_w, int64_t r_h,
    const uint8_t* needles, int64_t t_count, int64_t n_w, int64_t n_h,
    const int64_t* patch_sum,
    const double* patch_rnorm,
    const int64_t* start_end,
    float threshold,
    FMatch* out, int64_t cap, int64_t* counts) {
#pragma omp parallel for schedule(dynamic)
    for (int64_t t = 0; t < t_count; ++t) {
        counts[t] = focr_ncc_search_u8(
            ref, r_w, r_h,
            needles + t * n_w * n_h, n_w, n_h,
            patch_sum, patch_rnorm, start_end,
            threshold, out + t * cap, cap);
    }
}

}  // extern "C"

namespace {

// Exact integer stats of one window for the replay: correlation acc, window
// sum and sum of squares, all read from the same n_h rows of page bytes (one
// pass over ~n cache-resident bytes per candidate instead of scattered
// integral-table loads). Templated on the needle width so the inner loop has
// a constant trip count; NW == 0 is the generic instance, which takes every
// width the device sweep takes (n_w > 16 included). Exactness: the search
// domain is x, y >= 1, where direct window sums equal the reference's `_nz`
// integral lookups bit for bit (oracle/ncc_oracle.py's closed form).
template <int NW>
inline void win_stats(const uint8_t* ref, int64_t r_w, const uint8_t* needle,
                      int64_t n_h, int64_t n_w, int64_t y, int64_t x,
                      int64_t* acc_o, int64_t* sp_o, int64_t* s2p_o) {
    int64_t acc = 0, sp = 0, s2p = 0;
    const int w = NW > 0 ? NW : static_cast<int>(n_w);
    for (int64_t dy = 0; dy < n_h; ++dy) {
        const uint8_t* r = ref + (y + dy) * r_w + x;
        const uint8_t* nr = needle + dy * n_w;
        // i32 per-row partials, summed in i64: a row's Σp² <= n_w·255²,
        // and n_w <= n < 2³¹/255² for every needle the sweep takes
        // (ops/ncc_kernels.py::sweep_tier's bound n·65025 < 2³¹)
        int32_t a = 0, s = 0, q = 0;
        for (int dx = 0; dx < w; ++dx) {
            const int32_t v = r[dx];
            a += static_cast<int32_t>(nr[dx]) * v;
            s += v;
            q += v * v;
        }
        acc += a;
        sp += s;
        s2p += q;
    }
    *acc_o = acc;
    *sp_o = sp;
    *s2p_o = s2p;
}

// The whole replay loop, templated on the needle width so win_stats inlines
// into the candidate walk (an indirect call per candidate defeats both the
// inlining and the constant-trip unroll).
template <int NW>
void replay_impl(
    const uint8_t* ref, int64_t r_w, int64_t r_h,
    const int32_t* pos,
    const int64_t* starts, const int64_t* ends, int64_t n_needles,
    const uint8_t* bank, int64_t n_w, int64_t n_h,
    const int64_t* s_n_arr, const int64_t* s2_n_arr,
    double threshold, int64_t row_len,
    int64_t max_matches,
    int32_t* out_x, int32_t* out_y, float* out_sim,
    int32_t* out_counts, uint8_t* out_warn, int team) {
    const double n_recip = 1.0 / static_cast<double>(n_w * n_h);
    const double nd = static_cast<double>(n_w * n_h);
    constexpr int CH = 2048;  // candidates per two-phase chunk
#pragma omp parallel for schedule(dynamic) num_threads(team)
    for (int64_t t = 0; t < n_needles; ++t) {
        const uint8_t* needle = bank + t * n_h * n_w;
        const double s_n = static_cast<double>(s_n_arr[t]);
        const double norm2_n =
            static_cast<double>(s2_n_arr[t]) - s_n * s_n / nd;
        const double rnorm_n = 1.0 / std::sqrt(norm2_n);
        const int64_t off = starts[t];
        int64_t emitted = 0;
        int64_t kept = 0;
        // two phases per chunk: gather the integer stats of a block of
        // candidates, then run the f64 similarity as a flat elementwise
        // loop. One candidate's sqrt + div chain is ~60 cycles of latency;
        // batched, the compiler vectorizes it, and vsqrtpd/vdivpd round
        // correctly per lane, so the sims stay bit-identical to the scalar
        // order (same operations, same association).
        int32_t cx[CH], cy[CH];
        double accd[CH], spb[CH], s2pb[CH], sim[CH];
        int nc = 0;
        auto flush = [&]() {
            for (int i = 0; i < nc; ++i) {
                const double spd = spb[i];
                const double num = accd[i] - (s_n * spd) * n_recip;
                const double norm_p = s2pb[i] - (spd * spd) / nd;
                const double rnorm_p = 1.0 / std::sqrt(norm_p);
                sim[i] = num * (rnorm_n * rnorm_p);
            }
            for (int i = 0; i < nc; ++i) {
                if (sim[i] != std::numeric_limits<double>::infinity() &&
                    sim[i] > threshold) {
                    ++kept;
                    if (emitted < max_matches) {
                        out_x[off + emitted] = cx[i];
                        out_y[off + emitted] = cy[i];
                        out_sim[off + emitted] = static_cast<float>(sim[i]);
                        ++emitted;
                    }
                }
            }
            nc = 0;
        };
        for (int64_t c = starts[t]; c < ends[t]; ++c) {
            const int64_t lin = static_cast<int64_t>(pos[c]);
            const int64_t y = lin / row_len;
            const int64_t x = lin - y * row_len;
            int64_t acc, sp, s2p;
            win_stats<NW>(ref, r_w, needle, n_h, n_w, y, x, &acc, &sp, &s2p);
            cx[nc] = static_cast<int32_t>(x);
            cy[nc] = static_cast<int32_t>(y);
            accd[nc] = static_cast<double>(acc);  // exact: < 2^53
            spb[nc] = static_cast<double>(sp);
            s2pb[nc] = static_cast<double>(s2p);
            if (++nc == CH) flush();
        }
        flush();
        out_counts[t] = static_cast<int32_t>(emitted);
        out_warn[t] = kept >= max_matches ? 1 : 0;
    }
}

}  // namespace

extern "C" {

// Exact f64 replay of the device's candidate positions (the host half of
// models/ncc.py::NccMatcher): for every candidate, recompute the window's
// integer acc/Σp/Σp² from the page bytes (win_stats) and apply the
// reference's f64 similarity (ncc.cpp:206-215, same association and order),
// emitting each needle's hits in scan order with the MAX_MATCHES truncation
// (ncc.cpp:222-229).
//
// Positions are full-page linear indices lin = y*row_len + x, grouped by
// needle in ascending order as the device returns them; starts/ends give
// each needle's candidate range. Outputs are written at each needle's own
// offset starts[t] (capacity: one hit per candidate), so needles run in
// parallel with no shared state (OpenMP, in a team of n_threads; 0 or less:
// the runtime's default team). Callers that replay several pages at once
// size the team to their share of the cores. warn[t] is set when the needle
// kept >= max_matches hits, the reference's WARN condition.
void focr_ncc_replay_pos_u8(
    const uint8_t* ref, int64_t r_w, int64_t r_h,
    const int32_t* pos,
    const int64_t* starts, const int64_t* ends, int64_t n_needles,
    const uint8_t* bank, int64_t n_w, int64_t n_h,
    const int64_t* s_n_arr, const int64_t* s2_n_arr,
    double threshold, int64_t row_len,
    int64_t max_matches,
    int32_t* out_x, int32_t* out_y, float* out_sim,
    int32_t* out_counts, uint8_t* out_warn, int64_t n_threads) {
    const int team = n_threads > 0 ? static_cast<int>(n_threads) : omp_get_max_threads();
    switch (n_w) {
#define FOCR_REPLAY_CASE(NW)                                              \
    case NW:                                                              \
        replay_impl<NW>(ref, r_w, r_h, pos, starts, ends,                 \
                        n_needles, bank, n_w, n_h, s_n_arr, s2_n_arr,     \
                        threshold, row_len, max_matches,                  \
                        out_x, out_y, out_sim, out_counts, out_warn, team); \
        break;
        FOCR_REPLAY_CASE(4)
        FOCR_REPLAY_CASE(5)
        FOCR_REPLAY_CASE(6)
        FOCR_REPLAY_CASE(7)
        FOCR_REPLAY_CASE(8)
        FOCR_REPLAY_CASE(9)
        FOCR_REPLAY_CASE(10)
        FOCR_REPLAY_CASE(11)
        FOCR_REPLAY_CASE(12)
        FOCR_REPLAY_CASE(13)
        FOCR_REPLAY_CASE(14)
        FOCR_REPLAY_CASE(15)
        FOCR_REPLAY_CASE(16)
#undef FOCR_REPLAY_CASE
        default:
            replay_impl<0>(ref, r_w, r_h, pos, starts, ends,
                           n_needles, bank, n_w, n_h, s_n_arr, s2_n_arr,
                           threshold, row_len, max_matches,
                           out_x, out_y, out_sim, out_counts, out_warn, team);
    }
}

// Overlap-run winner scan (models/post.py::_run_winners): given hits sorted
// by the composite (y << xbits) + x key (lexicographic y, then x: the
// reference's two stable sort_by_key passes, ncc.rs:741, 753), write the
// index of each run's winner. Runs follow partition_by (ncc.rs:1036-1052): a
// run is anchored at its FIRST element and its members satisfy key - anchor
// <= overlap (the key's field widths keep runs inside a text line); the
// winner is the LAST maximal similarity (Rust max_by, ncc.rs:763). Returns
// the number of runs.
int64_t focr_post_winners(
    const int64_t* key, const float* sim, int64_t n, int64_t overlap,
    int64_t* win_out) {
    int64_t nr = 0;
    int64_t i = 0;
    while (i < n) {
        const int64_t anchor = key[i];
        float best = sim[i];
        int64_t bi = i;
        int64_t j = i + 1;
        while (j < n && key[j] - anchor <= overlap) {
            if (sim[j] >= best) {  // last max wins ties
                best = sim[j];
                bi = j;
            }
            ++j;
        }
        win_out[nr++] = bi;
        i = j;
    }
    return nr;
}

// Post-processing of one page's hits (models/post.py::_post_page): the
// reference's process_hits (ncc.rs:723-786) over the page's HitStruct arrays
// in engine order, in one call:
//   * anchor filter: keep the hits whose y holds any hit with f32 similarity
//     >= anchor (ncc.rs:724-739), through a dense table over y;
//   * stable sort by (y, x): a counting sort over x, then one over y, each
//     with as many buckets as the page's largest coordinate needs. Stability
//     is the reference's two stable sort_by_key passes (ncc.rs:741, 753),
//     which the run anchor and the last-max tie break both depend on;
//   * runs: partition_by (ncc.rs:1036-1052) anchors each run at its FIRST
//     element; its members share the anchor's y and have x - x_anchor <=
//     overlap (a negative overlap makes every hit its own run);
//   * winners: the LAST maximal similarity of each run (Rust max_by,
//     ncc.rs:763).
// Writes each winner's original index, in run order, to win_out and the
// code of its needle's letter (codes[nid]) to code_out (capacity n each), so
// the caller's text needs no gather of its own; and the split points between
// text lines (winner counts at which a new y starts) to bounds_out (capacity
// n), their number to *n_bounds. Returns the number of winners; -1 when a
// coordinate lies outside 0..65535 (the reference's u16 coordinates,
// ncc.rs:66-72), -2 when a needle id lies outside the code table.
int64_t focr_post_page(
    const int64_t* y, const int64_t* x, const float* sim, const int32_t* nid, int64_t n,
    float anchor, int64_t overlap, const uint32_t* codes, int64_t n_codes,
    int64_t* win_out, uint32_t* code_out, int64_t* bounds_out, int64_t* n_bounds) {
    *n_bounds = 0;
    int64_t ymax = 0, xmax = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (static_cast<uint64_t>(y[i]) > 0xffff || static_cast<uint64_t>(x[i]) > 0xffff)
            return -1;
        if (nid[i] < 0 || nid[i] >= n_codes) return -2;
        ymax = std::max(ymax, y[i]);
        xmax = std::max(xmax, x[i]);
    }
    if (n <= 0) return 0;
    struct Hit {
        uint16_t x, y;
        uint32_t i;  // original index (a page holds far fewer than 2^32 hits)
    };
    // per-thread scratch: the collect threads post pages concurrently
    thread_local std::vector<uint8_t> anchored;
    thread_local std::vector<int64_t> cx, cy;
    thread_local std::vector<Hit> a, b;
    anchored.assign(static_cast<size_t>(ymax) + 1, 0);
    for (int64_t i = 0; i < n; ++i)
        if (sim[i] >= anchor) anchored[y[i]] = 1;
    cx.assign(static_cast<size_t>(xmax) + 2, 0);
    cy.assign(static_cast<size_t>(ymax) + 2, 0);
    a.resize(static_cast<size_t>(n));
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (!anchored[y[i]]) continue;
        a[m++] = Hit{static_cast<uint16_t>(x[i]), static_cast<uint16_t>(y[i]),
                     static_cast<uint32_t>(i)};
        ++cx[x[i] + 1];
        ++cy[y[i] + 1];
    }
    if (m == 0) return 0;
    for (size_t k = 1; k < cx.size(); ++k) cx[k] += cx[k - 1];
    for (size_t k = 1; k < cy.size(); ++k) cy[k] += cy[k - 1];
    b.resize(static_cast<size_t>(m));
    for (int64_t k = 0; k < m; ++k) b[cx[a[k].x]++] = a[k];
    for (int64_t k = 0; k < m; ++k) a[cy[b[k].y]++] = b[k];

    int64_t nr = 0, nb = 0;
    int64_t k = 0;
    while (k < m) {
        const Hit h = a[k];
        float best = sim[h.i];
        int64_t bi = h.i;
        int64_t j = k + 1;
        while (j < m && a[j].y == h.y &&
               static_cast<int64_t>(a[j].x) - static_cast<int64_t>(h.x) <= overlap) {
            const float s = sim[a[j].i];
            if (s >= best) {  // last max wins ties
                best = s;
                bi = a[j].i;
            }
            ++j;
        }
        if (nr > 0 && h.y != a[k - 1].y) bounds_out[nb++] = nr;
        code_out[nr] = codes[nid[bi]];
        win_out[nr++] = bi;
        k = j;
    }
    *n_bounds = nb;
    return nr;
}

// PNG row unfiltering (PNG §9), for io/images.py's page reader: ``in`` holds
// ``rows`` rows of 1 + stride bytes, each its filter type (0 None, 1 Sub,
// 2 Up, 3 Average, 4 Paeth) and its filtered bytes; ``out`` gets rows x
// stride reconstructed bytes. bpp is the filter's byte distance to the left
// neighbour (bytes a pixel, at least 1); the row above the first is zeros.
// Average and Paeth read the byte just reconstructed to their left, which is
// why this runs here and not in NumPy (io/images.py::unfilter_reference is
// the plain version). Returns -1, or the first row whose filter type is not
// 0-4.
int64_t focr_png_unfilter(const uint8_t* in, int64_t rows, int64_t stride, int64_t bpp,
                          uint8_t* out) {
    for (int64_t y = 0; y < rows; ++y) {
        const uint8_t* s = in + y * (stride + 1) + 1;
        uint8_t* o = out + y * stride;
        const uint8_t* p = y ? o - stride : nullptr;
        switch (in[y * (stride + 1)]) {
        case 0:
            std::copy(s, s + stride, o);
            break;
        case 1:
            for (int64_t x = 0; x < stride; ++x)
                o[x] = static_cast<uint8_t>(s[x] + (x >= bpp ? o[x - bpp] : 0));
            break;
        case 2:
            for (int64_t x = 0; x < stride; ++x)
                o[x] = static_cast<uint8_t>(s[x] + (p ? p[x] : 0));
            break;
        case 3:
            for (int64_t x = 0; x < stride; ++x) {
                const int a = x >= bpp ? o[x - bpp] : 0;
                const int b = p ? p[x] : 0;
                o[x] = static_cast<uint8_t>(s[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t x = 0; x < stride; ++x) {
                const int a = x >= bpp ? o[x - bpp] : 0;
                const int b = p ? p[x] : 0;
                const int c = p && x >= bpp ? p[x - bpp] : 0;
                const int pe = a + b - c;
                const int pa = std::abs(pe - a), pb = std::abs(pe - b), pc = std::abs(pe - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                o[x] = static_cast<uint8_t>(s[x] + pred);
            }
            break;
        default:
            return y;
        }
    }
    return -1;
}

}  // extern "C"
