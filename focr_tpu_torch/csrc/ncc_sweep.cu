// K1: the NCC candidate sweep, for NVIDIA Hopper (sm_90a).
//
// Replaces focr_tpu/ops/pallas_ncc.py::_kernel_rows (:98-230, launched by
// _call_rows :904-944). For every page b, needle t of one size group and
// window (x, y) it computes the exact integer cross-correlation acc, the
// window sums Σp and Σp², and the ε-guarded, division-free threshold test of
// pallas_ncc.py:205-220, op for op in IEEE f32:
//
//   norm2p = fma(-(sp·sp), f32(1/n), s2p)
//   num    = fma(-sn_n[t], sp, acc)
//   keep   = sp > 0 && norm2p > -8 && x >= 1 && x < W-nw+1 && y >= 1
//            && num > fma(thr_eps, rtn[t]·sqrt(max(norm2p - 8, 0)), -48)
//
// (the TPU kernel folds the row masks into a +inf denominator, which gives
// the same accept set: inf·0 = NaN and inf both compare false). The three
// fused multiply-adds are exactly those XLA makes of focr_tpu's kernel body
// on the CPU, where it always allows FMA fusion, so the mask is bit-identical
// to focr_tpu's CPU reference; one rounding in place of two keeps inside the
// −8 and −48 error bounds. Every other op must round on its own: the build
// passes --fmad=false and the test uses the _rn intrinsics.
//
// Output: mask int32 [B, T, Hs, NW] — bit k of word g is window column
// x = 32g + k, so a needle-local position y·(32·NW) + x equals the TPU
// plane's — and rcnt int32 [B, T, Hs], the set bits of each mask row.
//
// What bounds it on the H100: int32 multiply-add throughput. An uncropped
// canonical page (792×662, 296 needles of 13×8 and 13×9) takes about 17 G
// multiply-adds. The design does four per instruction with __dp4a (u8·u8
// summed into u32, exact), loads each 4-pixel group once for a tile of 8
// needles (the needles' 4-byte words for one (dy, dx/4) are contiguous in
// shared memory, read as two 16-byte broadcasts), and stages the page band
// in shared memory once per block. Σp and Σp² ride the same loop (two more
// dp4a), so window_stats is fused in. Nothing of the TPU's banding, ndmr
// pre-shifted needle tiles or pack matrix is kept: those served VMEM and the
// MXU. Tensor cores (integer wgmma) and TMA are later work.
//
// Block: (page, tile of TT needles, TR window rows × XW 32-column words);
// each warp owns one (row, word) item at a time, one window column a lane,
// and packs the keep bits with __ballot_sync. Row counts are summed with
// integer atomics (exact), as several column tiles share a row.
//
// The wide instance (WIDE = true) serves what the test above does not:
// needles with n·65025 >= 2^24, where the int -> f32 casts round, or
// thr−ε <= 0, where num > c·den is no longer sim > c. It keeps the same
// integer sums (u32 __dp4a, exact while n·65025 < 2^32; the host refuses
// n·65025 >= 2^31, as focr_tpu's i32 correlate does) and replaces the test by
// focr_tpu/ops/ncc.py::ncc_candidates (:193-232), op for op in f32, with no
// FMA:
//
//   valid  = sp > 0 && n·s2p − sp² > 0 (exact int64) && needle norm² > 0
//   norm2p = f32(s2p) − f32(sp)·f32(sp) / f32(n)
//   num    = f32(acc) − (f32(Σn)·f32(sp))·(1/n)
//   den    = (rn[t]·sqrt(max(norm2p ± err_p, 0)))·(1 ± 2⁻²¹)
//   keep   = valid && x, y >= 1 && num > (thr−ε)·den − slack
//
// with the lower bound of den for thr−ε >= 0 and the upper one below 0
// (rn[t] carries the needle's side, NaN for a zero-variance needle, which
// fails every compare); err_p = 8·2⁻²⁴·n·65025 and slack = 32·2⁻²⁴·n·65025
// + 16 cover every rounding, so the set is still a superset. Where the needle
// tile would overflow shared memory, the wide instance reads the host-packed
// needle words from device memory instead (L1 broadcasts).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 8;       // needles per block (two uint4 of needle words)
constexpr int TR = 16;      // window rows per block
constexpr int XW = 8;       // 32-column words per block: 256 window columns
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// Scalars of the wide instance's test (see above), computed by the host.
struct WideTest {
    float err;    // ±err_p: −err_p for thr−ε >= 0 (den_lo), +err_p below (den_hi)
    float c_den;  // 1 − 2⁻²¹ or 1 + 2⁻²¹, the same side
    float slack;
};

template <bool WIDE>
__global__ void __launch_bounds__(NTHREADS)
ncc_sweep_kernel(const uint8_t* __restrict__ imgs, int H, int W,
                 const uint8_t* __restrict__ needles, int T, int nh, int nw,
                 const float* __restrict__ sn_n, const float* __restrict__ rtn,
                 float thr_eps, float inv_n,
                 int32_t* __restrict__ mask, int32_t* __restrict__ rcnt,
                 int Hs, int NW, int n_xt, int pitch,
                 const uint32_t* __restrict__ nd_words, WideTest wt)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float sn_s[TT];
    __shared__ float rtn_s[TT];

    const int nw4 = (nw + 3) >> 2;  // 4-byte needle words per needle row
    // nd_s[(dy·nw4 + q)·TT + t]: byte k = needle[t0+t][dy][4q+k], 0 past nw/T
    uint32_t* nd_s = reinterpret_cast<uint32_t*>(smem);
    // the wide instance may read the same layout from device memory
    const bool nd_global = WIDE && nd_words != nullptr;
    // img_s[r·pitch + c] = page[y0 + r][xb + c], 0 outside the page
    unsigned char* img_s = smem + (nd_global ? 0 : static_cast<size_t>(nh) * nw4 * TT * 4);

    const int xt = blockIdx.x % n_xt;
    const int band = blockIdx.x / n_xt;
    const int t0 = blockIdx.y * TT;
    const int b = blockIdx.z;
    const int y0 = band * TR;
    const int g0 = xt * XW;
    const int xb = g0 * 32;
    const int tid = threadIdx.x;

    const uint32_t* nd = nd_s;
    if (nd_global) nd = nd_words + static_cast<size_t>(blockIdx.y) * nh * nw4 * TT;
    for (int i = tid; !nd_global && i < nh * nw4 * TT; i += NTHREADS) {
        const int t = i % TT;
        const int q = (i / TT) % nw4;
        const int dy = i / (TT * nw4);
        uint32_t v = 0;
        if (t0 + t < T) {
            const uint8_t* src = needles + (static_cast<size_t>(t0 + t) * nh + dy) * nw;
            for (int k = 0; k < 4; ++k) {
                const int dx = 4 * q + k;
                if (dx < nw) v |= static_cast<uint32_t>(src[dx]) << (8 * k);
            }
        }
        nd_s[i] = v;
    }
    if (tid < TT) {
        const bool ok = t0 + tid < T;
        sn_s[tid] = ok ? sn_n[t0 + tid] : 0.f;
        rtn_s[tid] = ok ? rtn[t0 + tid] : 0.f;
    }
    const int brows = TR + nh - 1;
    const uint8_t* page = imgs + static_cast<size_t>(b) * H * W;
    for (int i = tid; i < brows * pitch; i += NTHREADS) {
        const int r = i / pitch;
        const int c = i - r * pitch;
        const int y = y0 + r;
        const int x = xb + c;
        img_s[i] = (y < H && x < W) ? page[static_cast<size_t>(y) * W + x] : 0;
    }
    __syncthreads();

    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int Wv = W - nw + 1;
    for (int item = warp; item < TR * XW; item += NWARPS) {
        const int r = item / XW;
        const int gw = item - r * XW;
        const int y = y0 + r;
        const int g = g0 + gw;
        if (y >= Hs || g >= NW) continue;  // whole warp
        const int xl = gw * 32 + lane;
        const int x = xb + xl;
        const int sh = (xl & 3) * 8;

        uint32_t acc[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[t] = 0;
        uint32_t sp = 0, s2p = 0;
        for (int dy = 0; dy < nh; ++dy) {
            const uint32_t* rw =
                reinterpret_cast<const uint32_t*>(img_s + (r + dy) * pitch) + (xl >> 2);
            const uint4* ndr = reinterpret_cast<const uint4*>(nd + dy * nw4 * TT);
            uint32_t lo = rw[0];
            for (int q = 0; q < nw4; ++q) {
                const uint32_t hi = rw[q + 1];
                // pixels x+4q .. x+4q+3 of row y+dy, lowest byte first
                const uint32_t p4 = __funnelshift_r(lo, hi, sh);
                lo = hi;
                const int valid = nw - 4 * q;
                const uint32_t pm =
                    valid >= 4 ? p4 : (p4 & ((1u << (8 * valid)) - 1u));
                sp = __dp4a(pm, 0x01010101u, sp);
                s2p = __dp4a(pm, pm, s2p);
                const uint4 na = ndr[2 * q];
                const uint4 nb = ndr[2 * q + 1];
                acc[0] = __dp4a(p4, na.x, acc[0]);
                acc[1] = __dp4a(p4, na.y, acc[1]);
                acc[2] = __dp4a(p4, na.z, acc[2]);
                acc[3] = __dp4a(p4, na.w, acc[3]);
                acc[4] = __dp4a(p4, nb.x, acc[4]);
                acc[5] = __dp4a(p4, nb.y, acc[5]);
                acc[6] = __dp4a(p4, nb.z, acc[6]);
                acc[7] = __dp4a(p4, nb.w, acc[7]);
            }
        }

        bool row_ok;
        float spf, q;
        if constexpr (WIDE) {
            // sp < 2^24 converts exactly; s2p and acc (< 2^31) round, as in
            // ncc_candidates
            spf = __int2float_rn(static_cast<int>(sp));
            const float norm2p = __fsub_rn(__int2float_rn(static_cast<int>(s2p)),
                                           __fdiv_rn(__fmul_rn(spf, spf),
                                                     __int2float_rn(nh * nw)));
            const long long var = static_cast<long long>(nh * nw) * s2p
                                  - static_cast<long long>(sp) * sp;
            row_ok = sp > 0 && var > 0 && x >= 1 && x < Wv && y >= 1;
            q = __fsqrt_rn(fmaxf(__fadd_rn(norm2p, wt.err), 0.f));
        } else {
            // every value below is an exact integer < 2^24 (n·65025 < 2^24
            // picks this instance), so the int -> f32 conversions are exact
            spf = static_cast<float>(static_cast<int>(sp));
            const float s2pf = static_cast<float>(static_cast<int>(s2p));
            const float norm2p = __fmaf_rn(-__fmul_rn(spf, spf), inv_n, s2pf);
            row_ok = spf > 0.f && norm2p > -8.f && x >= 1 && x < Wv && y >= 1;
            q = __fsqrt_rn(fmaxf(__fsub_rn(norm2p, 8.f), 0.f));
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            if (t0 + t >= T) break;  // whole warp
            bool keep;
            if constexpr (WIDE) {
                const float num = __fsub_rn(__uint2float_rn(acc[t]),
                                            __fmul_rn(__fmul_rn(sn_s[t], spf), inv_n));
                const float den = __fmul_rn(__fmul_rn(rtn_s[t], q), wt.c_den);
                keep = row_ok && num > __fsub_rn(__fmul_rn(thr_eps, den), wt.slack);
            } else {
                const float num =
                    __fmaf_rn(-sn_s[t], spf, static_cast<float>(static_cast<int>(acc[t])));
                const float rhs = __fmaf_rn(thr_eps, __fmul_rn(rtn_s[t], q), -48.f);
                keep = row_ok && num > rhs;
            }
            const uint32_t m = __ballot_sync(0xffffffffu, keep);
            if (lane == 0) {
                const size_t row = (static_cast<size_t>(b) * T + t0 + t) * Hs + y;
                mask[row * NW + g] = static_cast<int32_t>(m);
                if (m) atomicAdd(&rcnt[row], __popc(m));
            }
        }
    }
}

}  // namespace

// imgs u8 [B, H, W]; needles u8 [T, nh, nw]; sn_n, rtn f32 [T];
// mask int32 [B, T, H-nh+1, NW] (every word written); rcnt int32
// [B, T, H-nh+1], zeroed by the caller. wide = 0: the narrow test (sn_n =
// Σn/n, rtn = √norm² or +inf, inv_n = f32(1/n)); wide = 1: the wide test
// (sn_n = f32(Σn), rtn = the needle's side of den or NaN, inv_n = 1/f32(n),
// and err, c_den, slack); nd_words, for the wide test only and may be null:
// the needle words packed as [ceil(T/8), nh, ceil(nw/4), 8] u32, read from
// device memory in place of the shared-memory tile. Returns
// cudaGetLastError().
extern "C" int focr_ncc_sweep(const void* imgs, int B, int H, int W,
                              const void* needles, int T, int nh, int nw,
                              const void* sn_n, const void* rtn,
                              float thr_eps, float inv_n,
                              void* mask, void* rcnt, void* stream,
                              int wide, const void* nd_words,
                              float err, float c_den, float slack)
{
    const int Hs = H - nh + 1;
    const int NW = (W - nw + 1 + 31) / 32;
    const int nw4 = (nw + 3) / 4;
    const int pitch = XW * 32 + 4 * nw4;  // covers x + dx and the funnel's next word
    const int n_bands = (Hs + TR - 1) / TR;
    const int n_xt = (NW + XW - 1) / XW;
    const size_t smem = (wide && nd_words ? 0 : static_cast<size_t>(nh) * nw4 * TT * 4)
                        + static_cast<size_t>(TR + nh - 1) * pitch;
    auto kernel = wide ? ncc_sweep_kernel<true> : ncc_sweep_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(n_bands * n_xt, (T + TT - 1) / TT, B);
    kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(imgs), H, W,
        static_cast<const uint8_t*>(needles), T, nh, nw,
        static_cast<const float*>(sn_n), static_cast<const float*>(rtn),
        thr_eps, inv_n,
        static_cast<int32_t*>(mask), static_cast<int32_t*>(rcnt),
        Hs, NW, n_xt, pitch, static_cast<const uint32_t*>(nd_words),
        WideTest{err, c_den, slack});
    return static_cast<int>(cudaGetLastError());
}
