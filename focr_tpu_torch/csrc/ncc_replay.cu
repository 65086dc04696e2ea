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
// Layout: one block per (page, needle) segment, of `warps` warps (1 to RMAXW;
// the wrapper always gives ops/replay_kernels.py::WARPS, 3, the fastest count
// on the canonical wave, whose segments hold 88 candidates at the median and
// 320 at most). Warp j of a round takes the segment's piece of RPIECE
// candidates at (round·warps + j)·RPIECE, RU steps of 32 at once (one per
// lane a step, the steps' loads and f64 chains interleaved); a segment longer
// than a round takes more rounds. Each warp finds
// the segment's first candidate itself (the page's offset plus a warp-wide
// sum of the counts of the needles before it, which K2's count kernel wrote
// on the device). The keep flags are ranked in scan order by one ballot a
// step and a running base; with several warps, each warp's total goes
// through shared memory once a round (one __syncthreads; the two slots
// alternate by round). A hit is written at the segment's offset plus its rank
// while the rank is below max_matches, and the walk ends once max_matches
// hits are kept: the count and the WARN flag are then known.
//
// Windows are read a word at a time. A window row at byte a takes the aligned
// 32-bit words from a & ~3 on, lined up with __funnelshift_r; __dp4a sums
// acc against the needle's row words (staged once a block in shared memory,
// zero past nw), Σp against 0x01010101 and Σp² against the word itself (the
// last word of a row masked to the row's bytes). A window's sums stay below
// n·65025 < 2³¹ (the wrapper checks it), so 32 bits hold them exactly. The
// kernel is compiled for each width 4..16 (nw a constant: the row's words
// unroll and the word past the row is loaded only where the row reaches it)
// and once generic (any nw, K1's wide tier). A warp whose windows all end
// before the crop tensor's last whole word loads straight from memory; one
// near the end takes guarded loads, where a word that would reach past the
// tensor's last byte is assembled from the bytes that exist.
//
// What bounds it on the H100: bytes, and it is far from them. Per candidate
// 4 B of position in and 12 B of x, y and sim out, plus the crop once a page
// (~0.94 MB a canonical page: ~0.0003 ms at 3.35 TB/s). What is left is
// latency: a warp's window rows are loaded one after another, then come the
// f64 divide and square root chains. RU steps in flight and a segment's
// several warps hide part of it; a canonical wave gives a SM only ~5 working
// warps, too few to hide the rest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RU = 4;              // steps of 32 candidates a warp takes at once
constexpr int RPIECE = 32 * RU;    // candidates of a warp's piece
constexpr int RMAXW = 8;           // most warps a segment

struct Crop {
    const uint8_t* bytes;
    const uint32_t* words;         // the same memory (4-byte aligned)
    long long full;                // whole words in the tensor
    int rem;                       // bytes after them
};

// word i of the crop tensor; past its end only the bytes that exist, then 0
__device__ __forceinline__ uint32_t crop_word(const Crop& c, long long i)
{
    if (i < c.full) return __ldg(c.words + i);
    uint32_t v = 0;
    if (i == c.full)
        for (int q = 0; q < c.rem; ++q) v |= static_cast<uint32_t>(c.bytes[4 * i + q]) << (8 * q);
    return v;
}

// acc, Σp and Σp² of one window row of nw bytes at byte ar of the crop,
// added to the running sums: the row's words lined up from the aligned words
// at ar & ~3 on; the word past the last aligned one is loaded only where the
// row's bytes reach into it, and the row's last word is masked to its bytes
// (the needle's words are zero there already). GUARD: some word may lie past
// the tensor's last whole word (crop_word); else the loads go straight to
// memory, from one address a row
template <int NW, bool GUARD>
__device__ __forceinline__ void row_sums(const Crop& crop, long long ar, const uint32_t* nrow,
                                         int nw, uint32_t& acc, uint32_t& sp, uint32_t& s2p)
{
    const int nww = NW > 0 ? (NW + 3) / 4 : (nw + 3) >> 2;
    const int pad = 4 * nww - (NW > 0 ? NW : nw);  // bytes of the last word past the row
    const long long w0 = ar >> 2;
    const uint32_t* p = crop.words + w0;
    const int s = static_cast<int>(ar & 3);
    uint32_t lo = GUARD ? crop_word(crop, w0) : __ldg(p);
#pragma unroll
    for (int k = 0; k < nww; ++k) {
        const bool last = k == nww - 1;
        uint32_t hi = 0u;
        if (!last || s > pad) hi = GUARD ? crop_word(crop, w0 + k + 1) : __ldg(p + k + 1);
        uint32_t v = __funnelshift_r(lo, hi, 8 * s);
        if (last) v &= 0xffffffffu >> (8 * pad);
        acc = __dp4a(v, nrow[k], acc);
        sp = __dp4a(v, 0x01010101u, sp);
        s2p = __dp4a(v, v, s2p);
        lo = hi;
    }
}

// the window sums of RU candidates (their first rows at bytes a[u])
template <int NW, bool GUARD>
__device__ __forceinline__ void window_sums(const Crop& crop, const long long* a, int nh, int Wc,
                                            const uint32_t* s_needle, int nw, uint32_t* acc,
                                            uint32_t* sp, uint32_t* s2p)
{
    const int nww = NW > 0 ? (NW + 3) / 4 : (nw + 3) >> 2;
    for (int dy = 0; dy < nh; ++dy) {
#pragma unroll
        for (int u = 0; u < RU; ++u)
            row_sums<NW, GUARD>(crop, a[u] + static_cast<long long>(dy) * Wc,
                                s_needle + dy * nww, nw, acc[u], sp[u], s2p[u]);
    }
}

template <int NW>  // NW > 0: the needle width; 0: any width (nw_rt)
__global__ void __launch_bounds__(32 * RMAXW)
focr_ncc_replay_kernel(const uint8_t* __restrict__ imgs, long long img_bytes, int Hc, int Wc,
                       const int32_t* __restrict__ pos,
                       const int64_t* __restrict__ off, const int32_t* __restrict__ hcnt, int T,
                       const uint8_t* __restrict__ bank, int nh, int nw_rt,
                       const int64_t* __restrict__ s_n_arr, const int64_t* __restrict__ s2_n_arr,
                       double thr, int row_len, int cy0, int cx0, long long max_matches,
                       int32_t* __restrict__ out_x, int32_t* __restrict__ out_y,
                       float* __restrict__ out_sim, int32_t* __restrict__ counts,
                       uint8_t* __restrict__ warn)
{
    extern __shared__ uint32_t s_needle[];  // [nh, nww] the needle's row words
    __shared__ int s_kept[2][RMAXW];
    const int nw = NW > 0 ? NW : nw_rt;
    const int nww = (nw + 3) >> 2;          // words of a window row
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const long long seg = blockIdx.x;       // page · T + needle
    const int b = static_cast<int>(seg / T), t = static_cast<int>(seg % T);

    const Crop crop{imgs, reinterpret_cast<const uint32_t*>(imgs), img_bytes >> 2,
                    static_cast<int>(img_bytes & 3)};
    const uint8_t* needle = bank + static_cast<long long>(t) * nh * nw;
    for (int i = threadIdx.x; i < nh * nww; i += blockDim.x) {
        const int dy = i / nww, k = i - dy * nww;
        uint32_t w = 0;
        for (int q = 0; q < 4; ++q)
            if (4 * k + q < nw) w |= static_cast<uint32_t>(needle[dy * nw + 4 * k + q]) << (8 * q);
        s_needle[i] = w;
    }
    // the segment's first candidate: off[b] + Σ hcnt[b, t'] over t' < t
    long long part = 0;
#pragma unroll 8
    for (int k = lane; k < t; k += 32) part += hcnt[static_cast<long long>(b) * T + k];
#pragma unroll
    for (int d = 16; d; d >>= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
    const long long start = off[b] + part;
    const long long len = hcnt[seg];
    if (warps > 1)
        __syncthreads();
    else
        __syncwarp();

    // the needle's terms, as replay_impl computes them once a needle
    const double nd = static_cast<double>(nh * nw);
    const double n_recip = __ddiv_rn(1.0, nd);
    const double s_n = static_cast<double>(s_n_arr[t]);
    const double norm2_n = __dsub_rn(static_cast<double>(s2_n_arr[t]),
                                     __ddiv_rn(__dmul_rn(s_n, s_n), nd));
    const double rnorm_n = __ddiv_rn(1.0, __dsqrt_rn(norm2_n));
    const double inf = __longlong_as_double(0x7ff0000000000000ll);
    const long long page = static_cast<long long>(b) * Hc;
    const unsigned below = (1u << lane) - 1u;  // the lanes before this one

    long long kept = 0;  // hits accepted so far in the segment (uniform)
    int parity = 0;
    for (long long r0 = 0; r0 < len && kept < max_matches;
         r0 += static_cast<long long>(warps) * RPIECE) {
        const long long c0 = r0 + static_cast<long long>(warp) * RPIECE;
        bool keep[RU];
        int cx[RU], cy[RU];
        double sim[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) keep[u] = false;
        if (c0 < len) {  // uniform across the warp
            long long a[RU];
            bool live[RU], inside = true;
            uint32_t acc[RU], sp[RU], s2p[RU];
#pragma unroll
            for (int u = 0; u < RU; ++u) {
                const long long c = c0 + 32 * u + lane;
                live[u] = c < len;
                const int lin = live[u] ? pos[start + c] : 0;
                cy[u] = lin / row_len;
                cx[u] = lin - cy[u] * row_len;
                a[u] = (page + cy[u]) * Wc + cx[u];
                acc[u] = sp[u] = s2p[u] = 0u;
                // the last row's words, the one past them included
                inside &= ((a[u] + static_cast<long long>(nh - 1) * Wc) >> 2) + nww < crop.full;
            }
            // only windows near the tensor's end need the guarded loads
            if (__all_sync(0xffffffffu, inside))
                window_sums<NW, false>(crop, a, nh, Wc, s_needle, nw, acc, sp, s2p);
            else
                window_sums<NW, true>(crop, a, nh, Wc, s_needle, nw, acc, sp, s2p);
#pragma unroll
            for (int u = 0; u < RU; ++u) {
                const double spd = static_cast<double>(sp[u]);  // exact: < 2^31
                const double num = __dsub_rn(static_cast<double>(acc[u]),
                                             __dmul_rn(__dmul_rn(s_n, spd), n_recip));
                const double norm_p = __dsub_rn(static_cast<double>(s2p[u]),
                                                __ddiv_rn(__dmul_rn(spd, spd), nd));
                const double rnorm_p = __ddiv_rn(1.0, __dsqrt_rn(norm_p));
                sim[u] = __dmul_rn(num, __dmul_rn(rnorm_n, rnorm_p));
                keep[u] = live[u] && sim[u] != inf && sim[u] > thr;
            }
        }
        // rank the keep flags in scan order: step by step within the warp,
        // then across the round's warps
        unsigned bal[RU];
        int mine = 0;
#pragma unroll
        for (int u = 0; u < RU; ++u) {
            bal[u] = __ballot_sync(0xffffffffu, keep[u]);
            mine += __popc(bal[u]);
        }
        long long base = kept, round_kept = mine;
        if (warps > 1) {
            if (lane == 0) s_kept[parity][warp] = mine;
            __syncthreads();
            round_kept = 0;
            for (int j = 0; j < warps; ++j) {
                const int v = s_kept[parity][j];
                base += j < warp ? v : 0;
                round_kept += v;
            }
            parity ^= 1;
        }
#pragma unroll
        for (int u = 0; u < RU; ++u) {
            const long long rank = base + __popc(bal[u] & below);
            if (keep[u] && rank < max_matches) {
                const long long o = start + rank;
                out_x[o] = cx[u] + cx0;
                out_y[o] = cy[u] + cy0;
                out_sim[o] = __double2float_rn(sim[u]);
            }
            base += __popc(bal[u]);
        }
        kept += round_kept;
    }
    if (threadIdx.x == 0) {
        counts[seg] = static_cast<int32_t>(kept < max_matches ? kept : max_matches);
        warn[seg] = kept >= max_matches ? 1 : 0;
    }
}

template <int NW>
cudaError_t launch(unsigned segs, int warps, size_t smem, cudaStream_t stream,
                   const uint8_t* imgs, long long img_bytes, int Hc, int Wc, const int32_t* pos,
                   const int64_t* off, const int32_t* hcnt,
                   int T, const uint8_t* bank, int nh, int nw, const int64_t* s_n,
                   const int64_t* s2_n, double thr, int row_len, int cy0, int cx0,
                   long long max_matches, int32_t* out_x, int32_t* out_y, float* out_sim,
                   int32_t* counts, uint8_t* warn)
{
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            focr_ncc_replay_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    focr_ncc_replay_kernel<NW><<<segs, 32 * warps, smem, stream>>>(
        imgs, img_bytes, Hc, Wc, pos, off, hcnt, T, bank, nh, nw, s_n, s2_n, thr, row_len, cy0, cx0,
        max_matches, out_x, out_y, out_sim, counts, warn);
    return cudaGetLastError();
}

}  // namespace

// A size group's needles, checked once by the wrapper
// (ops/replay_kernels.py::replay_needles): bank u8 [T, nh, nw], s_n and s2_n
// i64 [T].
struct FocrReplayNeedles {
    const void* bank;
    const void* s_n;
    const void* s2_n;
    int T, nh, nw;
};

// imgs u8 [B, Hc, Wc] (the wave's cropped pages, 4-byte aligned), pos i32
// [total] (K2's positions, crop-local y·row_len + x), off i64 [B+1] and hcnt
// i32 [B, T] (K2's counts). out: the output buffer of 12·total + 5·B·T bytes,
// placed here as x i32 [total], y i32 [total], sim f32 [total] (segment (b,
// t)'s hits at its own candidate offset), counts i32 [B, T], warn u8 [B, T]
// (ops/replay_kernels.py::split_replay reads it). instance: nw for the
// instances compiled for 4..16, 0 for the generic one
// (ops/replay_kernels.py::replay_plan); warps: 1..RMAXW a segment, any count
// giving the same output. Launches nothing for
// B·T == 0. Returns a CUDA error code (cudaErrorInvalidValue for an instance
// or warp count the plan never gives).
extern "C" int focr_ncc_replay(const void* imgs, int B, int Hc, int Wc, const void* pos,
                               long long total, const void* off, const void* hcnt,
                               const FocrReplayNeedles* nd, int instance, int warps, double thr,
                               int cy0, int cx0, long long max_matches, void* out, void* stream)
{
    const long long segs = static_cast<long long>(B) * nd->T;
    if (segs == 0) return static_cast<int>(cudaGetLastError());
    if ((instance != 0 && instance != nd->nw) || warps < 1 || warps > RMAXW)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long img_bytes = static_cast<long long>(B) * Hc * Wc;
    const int row_len = (Wc - nd->nw + 1 + 31) / 32 * 32;  // ops/ncc.py::word_stride · 32
    uint8_t* o = static_cast<uint8_t*>(out);
    int32_t* out_x = reinterpret_cast<int32_t*>(o);
    int32_t* out_y = reinterpret_cast<int32_t*>(o + 4 * total);
    float* out_sim = reinterpret_cast<float*>(o + 8 * total);
    int32_t* counts = reinterpret_cast<int32_t*>(o + 12 * total);
    uint8_t* warn = o + 12 * total + 4 * segs;
    const size_t smem = static_cast<size_t>(nd->nh) * ((nd->nw + 3) / 4) * sizeof(uint32_t);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaErrorInvalidValue;
    switch (instance) {
#define FOCR_REPLAY_CASE(NW)                                                                  \
    case NW:                                                                                  \
        e = launch<NW>(static_cast<unsigned>(segs), warps, smem, s,                           \
                       static_cast<const uint8_t*>(imgs), img_bytes, Hc, Wc,                  \
                       static_cast<const int32_t*>(pos), static_cast<const int64_t*>(off),    \
                       static_cast<const int32_t*>(hcnt), nd->T,                              \
                       static_cast<const uint8_t*>(nd->bank), nd->nh, nd->nw,                 \
                       static_cast<const int64_t*>(nd->s_n),                                  \
                       static_cast<const int64_t*>(nd->s2_n), thr, row_len, cy0, cx0,         \
                       max_matches, out_x, out_y, out_sim, counts, warn);                     \
        break;
        FOCR_REPLAY_CASE(0)
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
            break;
    }
    return static_cast<int>(e);
}
