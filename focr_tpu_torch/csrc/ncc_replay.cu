// K3: the exact f64 replay of the ncc sweep's candidates, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the host replay of focr_tpu (focr_tpu/models/ncc.py:1422 ->
// native/ncc_cpu.py:104 replay_group -> native/ncc_kernel.cpp:256), which
// focr_tpu runs on the host only because a TPU has no f64 unit. It is the
// same function as csrc/ncc_host.cpp::focr_ncc_replay_pos_u8 (:280-319): the
// same arguments, op order, MAX_MATCHES cap and WARN condition. For every
// candidate position K2 emitted (crop-local y·row_len + x, in (page, needle,
// y, x) scan order), it recomputes the window's exact integer correlation
// acc, Σp and Σp² from the cropped page bytes and applies the reference's f64
// similarity (ncc.cpp:206-215):
//
//   norm2_n = f64(s2_n) − s_n·s_n/n      rnorm_n = 1/sqrt(norm2_n)
//   num     = acc − (s_n·sp)·(1/n)       norm_p  = s2p − (sp·sp)/n
//   sim     = num·(rnorm_n·rnorm_p)      keep    = sim != +inf && sim > thr
//
// Every f64 operation is an explicit round-to-nearest intrinsic (__dmul_rn,
// __dsub_rn, __ddiv_rn, __dsqrt_rn), which the compiler never contracts into
// an FMA (and the build passes --fmad=false besides): one rounding per
// operation, as the host library's -ffp-contract=off build does, so the
// similarities are bit-identical to it. NaN (a zero-variance window or
// needle) fails the > test.
//
// Layout: one block per (page, needle) segment. The block stages the needle
// in shared memory, finds its segment's first candidate (the page's offset
// plus the counts of the needles before it, which K2's count kernel wrote on
// the device), then walks the segment in chunks of RT candidates, one thread
// each, reading its window from the crop (a wave of 8 cropped pages is ~3.8
// MB and stays in L2). The keep flags of a chunk are ranked in scan order (a
// ballot and popcount in each warp, the warps' totals through shared memory,
// a running base across chunks), and a hit is written at the segment's own
// offset plus its rank while the rank is below max_matches. The walk ends
// once max_matches hits are kept: the count and the WARN flag are then known.
//
// What bounds it on the H100: bytes, and it is far from them. Per candidate
// 4 B of position in and 12 B of x, y and sim out, plus the crop once a page
// (~0.94 MB a canonical page: ~0.0003 ms at 3.35 TB/s); the f64 divide and
// square root chains and the byte-wise window walk are latency this simple
// design does not hide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RT = 256;            // threads of a replay block: candidates a chunk
constexpr int RWARPS = RT / 32;

__global__ void __launch_bounds__(RT)
focr_ncc_replay_kernel(const uint8_t* __restrict__ imgs, int Hc, int Wc,
                       const int32_t* __restrict__ pos, const int64_t* __restrict__ off,
                       const int32_t* __restrict__ hcnt, int T,
                       const uint8_t* __restrict__ bank, int nh, int nw,
                       const int64_t* __restrict__ s_n_arr, const int64_t* __restrict__ s2_n_arr,
                       double thr, int row_len, int cy0, int cx0, long long max_matches,
                       int32_t* __restrict__ out_x, int32_t* __restrict__ out_y,
                       float* __restrict__ out_sim, int32_t* __restrict__ counts,
                       uint8_t* __restrict__ warn)
{
    extern __shared__ uint8_t s_needle[];
    __shared__ long long s_part[RWARPS];
    __shared__ int s_kept[RWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long seg = blockIdx.x;  // page · T + needle
    const int b = static_cast<int>(seg / T), t = static_cast<int>(seg % T);
    const int n = nh * nw;
    for (int i = tid; i < n; i += RT) s_needle[i] = bank[static_cast<long long>(t) * n + i];
    // the segment's first candidate: off[b] + Σ hcnt[b, t'] over t' < t
    long long part = 0;
    for (int k = tid; k < t; k += RT) part += hcnt[static_cast<long long>(b) * T + k];
#pragma unroll
    for (int d = 16; d; d >>= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
    if (lane == 0) s_part[warp] = part;
    __syncthreads();
    long long start = off[b];
#pragma unroll
    for (int w = 0; w < RWARPS; ++w) start += s_part[w];
    const long long len = hcnt[seg];

    // the needle's terms, as replay_impl computes them once a needle
    const double nd = static_cast<double>(n);
    const double n_recip = __ddiv_rn(1.0, nd);
    const double s_n = static_cast<double>(s_n_arr[t]);
    const double norm2_n = __dsub_rn(static_cast<double>(s2_n_arr[t]),
                                     __ddiv_rn(__dmul_rn(s_n, s_n), nd));
    const double rnorm_n = __ddiv_rn(1.0, __dsqrt_rn(norm2_n));
    const double inf = __longlong_as_double(0x7ff0000000000000ll);
    const uint8_t* page = imgs + static_cast<long long>(b) * Hc * Wc;
    const unsigned below = (1u << lane) - 1u;  // the lanes before this one

    long long kept = 0;  // hits accepted so far in the segment (uniform)
    for (long long c0 = 0; c0 < len && kept < max_matches; c0 += RT) {
        const long long c = c0 + tid;
        bool keep = false;
        int x = 0, y = 0;
        double sim = 0.0;
        if (c < len) {
            const int lin = pos[start + c];
            y = lin / row_len;
            x = lin - y * row_len;
            // exact integer stats: i32 per row (a row's Σp² <= nw·255² < 2³¹),
            // summed in i64, as win_stats does
            long long acc = 0, sp = 0, s2p = 0;
            for (int dy = 0; dy < nh; ++dy) {
                const uint8_t* r = page + static_cast<long long>(y + dy) * Wc + x;
                const uint8_t* nr = s_needle + dy * nw;
                int a = 0, s = 0, q = 0;
                for (int dx = 0; dx < nw; ++dx) {
                    const int v = r[dx];
                    a += static_cast<int>(nr[dx]) * v;
                    s += v;
                    q += v * v;
                }
                acc += a;
                sp += s;
                s2p += q;
            }
            const double spd = static_cast<double>(sp);  // exact: < 2^53
            const double num = __dsub_rn(static_cast<double>(acc),
                                         __dmul_rn(__dmul_rn(s_n, spd), n_recip));
            const double norm_p = __dsub_rn(static_cast<double>(s2p),
                                            __ddiv_rn(__dmul_rn(spd, spd), nd));
            const double rnorm_p = __ddiv_rn(1.0, __dsqrt_rn(norm_p));
            sim = __dmul_rn(num, __dmul_rn(rnorm_n, rnorm_p));
            keep = sim != inf && sim > thr;
        }
        // rank the keep flags in scan order: within the warp, then across warps
        const unsigned ballot = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) s_kept[warp] = __popc(ballot);
        __syncthreads();
        int before = __popc(ballot & below), total = 0;
#pragma unroll
        for (int w = 0; w < RWARPS; ++w) {
            const int v = s_kept[w];
            before += w < warp ? v : 0;
            total += v;
        }
        const long long rank = kept + before;
        if (keep && rank < max_matches) {
            const long long o = start + rank;
            out_x[o] = x + cx0;
            out_y[o] = y + cy0;
            out_sim[o] = __double2float_rn(sim);
        }
        kept += total;
        __syncthreads();  // s_kept is rewritten by the next chunk
    }
    if (tid == 0) {
        counts[seg] = static_cast<int32_t>(kept < max_matches ? kept : max_matches);
        warn[seg] = kept >= max_matches ? 1 : 0;
    }
}

}  // namespace

// imgs u8 [B, Hc, Wc] (the wave's cropped pages), pos i32 (K2's positions,
// crop-local y·row_len + x), off i64 [B+1] and hcnt i32 [B, T] (K2's counts),
// bank u8 [T, nh, nw], s_n and s2_n i64 [T]; out_x, out_y i32, out_sim f32
// sized like pos (segment (b, t)'s hits at its own candidate offset), counts
// i32 and warn u8 [B, T]. Launches nothing for B·T == 0. Returns
// cudaGetLastError().
extern "C" int focr_ncc_replay(const void* imgs, int B, int Hc, int Wc, const void* pos,
                               const void* off, const void* hcnt, int T, const void* bank,
                               int nh, int nw, const void* s_n, const void* s2_n, double thr,
                               int row_len, int cy0, int cx0, long long max_matches,
                               void* out_x, void* out_y, void* out_sim, void* counts,
                               void* warn, void* stream)
{
    const long long segs = static_cast<long long>(B) * T;
    if (segs == 0) return static_cast<int>(cudaGetLastError());
    focr_ncc_replay_kernel<<<static_cast<unsigned>(segs), RT, static_cast<size_t>(nh) * nw,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(imgs), Hc, Wc, static_cast<const int32_t*>(pos),
        static_cast<const int64_t*>(off), static_cast<const int32_t*>(hcnt), T,
        static_cast<const uint8_t*>(bank), nh, nw, static_cast<const int64_t*>(s_n),
        static_cast<const int64_t*>(s2_n), thr, row_len, cy0, cx0, max_matches,
        static_cast<int32_t*>(out_x), static_cast<int32_t*>(out_y),
        static_cast<float*>(out_sim), static_cast<int32_t*>(counts),
        static_cast<uint8_t*>(warn));
    return static_cast<int>(cudaGetLastError());
}
