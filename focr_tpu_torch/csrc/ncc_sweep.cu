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
// The wide instance serves what the test above does not: needles with
// n·65025 >= 2^24, where the int -> f32 casts round, or thr−ε <= 0, where
// num > c·den is no longer sim > c. It keeps the same integer sums (exact in
// s32 while n·65025 < 2^31, which the host enforces, as focr_tpu's i32
// correlate does) and replaces the test by focr_tpu/ops/ncc.py::
// ncc_candidates (:193-232), op for op in f32, with no FMA:
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
// + 16 cover every rounding, so the set is still a superset.
//
// What bounds it on the H100. The canonical ncc wave (8 pages cropped to
// 766×626, 74 needles of 13×8 and 222 of 13×9) needs ~15.7 G u8
// multiply-adds a page: 31 G int8 operations, 0.016 ms at the 1,979 TOP/s of
// the int8 tensor cores; the mask plane it writes is ~17.4 MB a page, 0.005
// ms at 3.35 TB/s. So the correlation bounds it, and it belongs on the tensor
// cores (as the TPU kernel's jnp.dot on the MXU, pallas_ncc.py:197-201).
// Beside it, the threshold test is ~7 f32/int ops for each of the ~147 M
// (needle, window) pairs a page (needles padded to 16, columns to 32), about
// 0.035 ms of the CUDA cores' instruction rate; a column outside the keep
// domain carries q = NaN, which fails the compare exactly as the && did, so
// the domain costs nothing a needle. Measured on the H100, the test is not
// what sets this design's pace (a variant with one integer compare in its
// place ran only ~15% faster; converting acc < 2^23 to f32 by OR-and-subtract
// in place of the I2F instruction ran ~2.5% slower): the shared-memory
// traffic of building B and reading A, and issuing the mma.sync, are. That is
// why B is built once an item and held in registers for every chunk of
// needles (0.184 ms/page against 0.228 rebuilding it for every chunk of 2
// M-tiles, 0.284 for every chunk of 4).
//
// The design: acc is an implicit GEMM on the int8 tensor cores,
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32, exact (u8·u8 summed into s32).
//
//   M = 16 needles. K = the needle's pixels as 4-byte words (dy, q), each
//   needle row padded to nw4 = ceil(nw/4) words, the total padded to a
//   multiple of 8 words (32 bytes, one k-step): 4 k-steps for 13×8, 5 for
//   13×9. The padding bytes of A are 0, so whatever page bytes meet them in
//   B add nothing to acc. The host packs A in fragment order
//   (ops/ncc_kernels.py::pack_needle_fragments: one uint4 a lane for each
//   (M-tile, k-step), once a needle bank) and the block stages its M-tiles'
//   fragments in shared memory; where they do not fit (the wide instance's
//   largest needles) the block reads them from device memory.
//   N = 8 consecutive window columns of one window row. Lane 4g+tq holds
//   window column g and k-words 8s+tq, 8s+tq+4; each register is one
//   __funnelshift_r of two shared-memory words of the page band (window
//   columns are not 4-aligned), at a byte offset (dy·pitch + 4q) read from a
//   per-block table, so one B fragment serves every M-tile of the item.
//
// A warp item is one window row × one 32-column mask word: 4 N-tiles, and
// every needle of the block, in chunks of MT = 2 M-tiles (32 C registers a
// lane). A block takes at most MTZ = 16 M-tiles (256 needles: every group of
// the main path); a larger group spreads its M-tiles over grid.z, so the
// shared memory a block needs does not grow with the group. The B fragments
// of up to KH = 5 k-steps (40 registers) are built once an item and serve
// every chunk; a larger needle rebuilds them for each chunk and each KH
// k-steps. The C fragment puts needle rows g, g+8 against columns 2tq, 2tq+1
// of each N-tile, so a lane holds 8 of the 32 keep bits of each of its two
// needles' words; two __shfl_xor_sync ORs
// (1, 2) complete the words, with no ballot and no shared-memory staging. Σp
// and Σp² are per window, not per needle: each lane computes them once an
// item for its own column with __dp4a over the real pixels only (the byte
// mask keeps the K padding and the bytes past nw out of them), turns them
// into the column's f32 terms (one sqrt), and the epilogue fetches the 8
// columns it needs by __shfl_sync. Row counts are __popc of the words,
// summed with integer atomics (exact) as several column tiles share a row.
//
// Block: (page, TR window rows × XW mask words, MTZ M-tiles), 8 warps over
// the valid items. The launcher derives the whole plan (k-steps, grid, where
// A lives) from T, nh and nw. Left for a later PR: wgmma (it needs B in
// shared memory in its canonical layout, i.e. the im2col tile written there
// first: this design builds B in registers instead), TMA or cp.async
// double-buffering of the page band, and staging the mask words so they
// leave the SM coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MT = 2;       // 16-needle M-tiles a chunk holds at most
constexpr int MTZ = 16;     // M-tiles a block holds at most (the rest: grid.z)
constexpr int NT = 4;       // 8-column N-tiles a warp item: one 32-column word
constexpr int KH = 5;       // k-steps of B fragments held in registers
constexpr int TR = 8;       // window rows per block
constexpr int XW = 8;       // 32-column words per block: 256 window columns
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr size_t SMEM_MAX = 232448 - 1024;  // shared memory a block may use on the H100

// the two instances: the narrow test and the wide test
enum Mode { NARROW = 0, WIDE = 1 };

// Scalars of the wide instance's test (see above), computed by the host.
struct WideTest {
    float err;    // ±err_p: −err_p for thr−ε >= 0 (den_lo), +err_p below (den_hi)
    float c_den;  // 1 − 2⁻²¹ or 1 + 2⁻²¹, the same side
    float slack;
};

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint4& a, uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// keep for one (needle, column): q is NaN for a column outside the domain
template <int MODE>
__device__ __forceinline__ bool keep_test(int acc, float sn, float rtn, float spf, float q,
                                          float thr_eps, float inv_n, const WideTest& wt)
{
    if constexpr (MODE == WIDE) {
        const float num = __fsub_rn(__uint2float_rn(static_cast<uint32_t>(acc)),
                                    __fmul_rn(__fmul_rn(sn, spf), inv_n));
        const float den = __fmul_rn(__fmul_rn(rtn, q), wt.c_den);
        return num > __fsub_rn(__fmul_rn(thr_eps, den), wt.slack);
    } else {
        // acc < 2^24 (n·65025 < 2^24 picks this instance): exact in f32
        const float num = __fmaf_rn(-sn, spf, static_cast<float>(acc));
        return num > __fmaf_rn(thr_eps, __fmul_rn(rtn, q), -48.f);
    }
}

template <int MODE, bool ASMEM>
__global__ void __launch_bounds__(NTHREADS)
focr_ncc_sweep_kernel(const uint8_t* __restrict__ imgs, int H, int W,
                 const uint4* __restrict__ afrag, int T, int nh, int nw, int nks,
                 const float* __restrict__ sn_n, const float* __restrict__ rtn,
                 float thr_eps, float inv_n,
                 int32_t* __restrict__ mask, int32_t* __restrict__ rcnt,
                 int Hs, int NW, int n_xt, int pitch, WideTest wt)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int nw4 = (nw + 3) >> 2;  // 4-byte needle words per needle row
    // this block's M-tiles: mz0 .. mz0 + nmz - 1
    const int mz0 = blockIdx.z * MTZ;
    const int nmz = min(MTZ, ((T + 15) >> 4) - mz0);
    // a_s[(m·nks + s)·32 + lane] (ablk in device memory): the lane's A
    // fragment of the block's M-tile m, k-step s, as packed by the host
    const uint4* ablk = afrag + static_cast<size_t>(mz0) * nks * 32;
    uint4* a_s = reinterpret_cast<uint4*>(smem);
    const size_t a_bytes = ASMEM ? static_cast<size_t>(nmz) * nks * 32 * 16 : 0;
    float* sn_s = reinterpret_cast<float*>(smem + a_bytes);
    float* rtn_s = sn_s + nmz * 16;
    // koff_s[w]: byte offset in the band of k-word w = (dy, q) of a window,
    // dy·pitch + 4q; 0 for the padding words (their A bytes are 0)
    int* koff_s = reinterpret_cast<int*>(rtn_s + nmz * 16);
    // img_s[r·pitch + c] = page[y0 + r][xb + c], 0 outside the page
    unsigned char* img_s = reinterpret_cast<unsigned char*>(koff_s + nks * 8);

    const int xt = blockIdx.x % n_xt;
    const int band = blockIdx.x / n_xt;
    const int b = blockIdx.y;
    const int y0 = band * TR;
    const int g0 = xt * XW;
    const int xb = g0 * 32;
    const int tid = threadIdx.x;

    if constexpr (ASMEM)
        for (int i = tid; i < nmz * nks * 32; i += NTHREADS) a_s[i] = ablk[i];
    for (int i = tid; i < nmz * 16; i += NTHREADS) {
        const int t = mz0 * 16 + i;
        sn_s[i] = t < T ? sn_n[t] : 0.f;
        rtn_s[i] = t < T ? rtn[t] : 0.f;
    }
    for (int w = tid; w < nks * 8; w += NTHREADS) {
        const int dy = w / nw4;
        koff_s[w] = dy < nh ? dy * pitch + 4 * (w - dy * nw4) : 0;
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
    const int gq = lane >> 2;  // the fragments' groupID
    const int tq = lane & 3;   // and thread-in-group
    const int Wv = W - nw + 1;
    const int nrv = min(TR, Hs - y0);  // the block's valid rows and words
    const int nwv = min(XW, NW - g0);
    for (int item = warp; item < nrv * nwv; item += NWARPS) {
        const int r = item / nwv;
        const int gw = item - r * nwv;
        const int y = y0 + r;
        const int g = g0 + gw;
        const int xw = gw * 32;  // band column of the word's first window

        // Σp, Σp² of this lane's own window column xw + lane, real pixels only
        uint32_t sp = 0, s2p = 0;
        {
            const int xl = xw + lane;
            const int sh = (xl & 3) * 8;
            for (int dy = 0; dy < nh; ++dy) {
                const uint32_t* rw =
                    reinterpret_cast<const uint32_t*>(img_s + (r + dy) * pitch) + (xl >> 2);
                uint32_t lo = rw[0];
                for (int q = 0; q < nw4; ++q) {
                    const uint32_t hi = rw[q + 1];
                    const uint32_t p4 = __funnelshift_r(lo, hi, sh);
                    lo = hi;
                    const int valid = nw - 4 * q;
                    const uint32_t pm =
                        valid >= 4 ? p4 : (p4 & ((1u << (8 * valid)) - 1u));
                    sp = __dp4a(pm, 0x01010101u, sp);
                    s2p = __dp4a(pm, pm, s2p);
                }
            }
        }
        // the column's f32 terms, as the test above defines them; q = NaN
        // outside the keep domain
        const int x = xb + xw + lane;
        bool row_ok;
        float spf, qv;
        if constexpr (MODE == WIDE) {
            // sp < 2^24 converts exactly; s2p (< 2^31) rounds, as in ncc_candidates
            spf = __int2float_rn(static_cast<int>(sp));
            const float norm2p = __fsub_rn(__int2float_rn(static_cast<int>(s2p)),
                                           __fdiv_rn(__fmul_rn(spf, spf),
                                                     __int2float_rn(nh * nw)));
            const long long var = static_cast<long long>(nh * nw) * s2p
                                  - static_cast<long long>(sp) * sp;
            row_ok = sp > 0 && var > 0 && x >= 1 && x < Wv && y >= 1;
            qv = __fsqrt_rn(fmaxf(__fadd_rn(norm2p, wt.err), 0.f));
        } else {
            // every value is an exact integer < 2^24 (n·65025 < 2^24 picks
            // this instance), so the int -> f32 conversions are exact
            spf = static_cast<float>(static_cast<int>(sp));
            const float s2pf = static_cast<float>(static_cast<int>(s2p));
            const float norm2p = __fmaf_rn(-__fmul_rn(spf, spf), inv_n, s2pf);
            row_ok = spf > 0.f && norm2p > -8.f && x >= 1 && x < Wv && y >= 1;
            qv = __fsqrt_rn(fmaxf(__fsub_rn(norm2p, 8.f), 0.f));
        }
        qv = row_ok ? qv : __int_as_float(0x7fffffff);
        // the terms of the 8 columns this lane's C elements sit in:
        // column 8·nt + 2·tq + e of the word
        float spc[NT][2], qc[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                spc[nt][e] = __shfl_sync(0xffffffffu, spf, 8 * nt + 2 * tq + e);
                qc[nt][e] = __shfl_sync(0xffffffffu, qv, 8 * nt + 2 * tq + e);
            }

        // band word holding window column xw + gq (N-tile nt adds 8·nt bytes)
        const unsigned char* bcol = img_s + r * pitch + ((xw + gq) & ~3);
        const int bsh = (gq & 3) * 8;  // (xw + 8·nt + gq) & 3 == gq & 3
        // B for KH k-steps at a time: built once an item where nks <= KH
        // (every narrow needle of the main path) and kept for every chunk
        uint32_t bf[KH][NT][2];
        for (int m0 = 0; m0 < nmz; m0 += MT) {
            const int mts = min(MT, nmz - m0);  // this chunk's M-tiles, 1..MT
            // acc on the tensor cores: C[mt][nt] = A[mt] · B[nt] over the k-steps
            int acc[MT][NT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
            for (int k0 = 0; k0 < nks; k0 += KH) {
                if (m0 == 0 || nks > KH) {
#pragma unroll
                    for (int s = 0; s < KH; ++s) {
                        if (k0 + s >= nks) break;
                        const int o0 = koff_s[8 * (k0 + s) + tq];
                        const int o1 = koff_s[8 * (k0 + s) + tq + 4];
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt) {
                            const uint32_t* p0 =
                                reinterpret_cast<const uint32_t*>(bcol + 8 * nt + o0);
                            const uint32_t* p1 =
                                reinterpret_cast<const uint32_t*>(bcol + 8 * nt + o1);
                            bf[s][nt][0] = __funnelshift_r(p0[0], p0[1], bsh);
                            bf[s][nt][1] = __funnelshift_r(p1[0], p1[1], bsh);
                        }
                    }
                }
#pragma unroll
                for (int s = 0; s < KH; ++s) {
                    if (k0 + s >= nks) break;
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        if (mt >= mts) break;  // whole warp
                        const int ai = ((m0 + mt) * nks + k0 + s) * 32 + lane;
                        const uint4 av = ASMEM ? a_s[ai] : __ldg(ablk + ai);
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt)
                            mma_u8(acc[mt][nt], av, bf[s][nt][0], bf[s][nt][1]);
                    }
                }
            }

#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                if (mt >= mts) break;  // whole warp
                const int tl = (m0 + mt) * 16 + gq;  // this lane's block rows tl, tl + 8
                const float sn_lo = sn_s[tl], rtn_lo = rtn_s[tl];
                const float sn_hi = sn_s[tl + 8], rtn_hi = rtn_s[tl + 8];
                uint32_t w_lo = 0, w_hi = 0;
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int c = 8 * nt + 2 * tq + e;
                        if (keep_test<MODE>(acc[mt][nt][e], sn_lo, rtn_lo, spc[nt][e],
                                            qc[nt][e], thr_eps, inv_n, wt))
                            w_lo |= 1u << c;
                        if (keep_test<MODE>(acc[mt][nt][2 + e], sn_hi, rtn_hi, spc[nt][e],
                                            qc[nt][e], thr_eps, inv_n, wt))
                            w_hi |= 1u << c;
                    }
                w_lo |= __shfl_xor_sync(0xffffffffu, w_lo, 1);
                w_lo |= __shfl_xor_sync(0xffffffffu, w_lo, 2);
                w_hi |= __shfl_xor_sync(0xffffffffu, w_hi, 1);
                w_hi |= __shfl_xor_sync(0xffffffffu, w_hi, 2);
                // lane tq = 0 writes needle row tl's word, tq = 1 row tl + 8's
                const int t = mz0 * 16 + tl + 8 * tq;
                if (tq < 2 && t < T) {
                    const uint32_t m = tq ? w_hi : w_lo;
                    const size_t row = (static_cast<size_t>(b) * T + t) * Hs + y;
                    mask[row * NW + g] = static_cast<int32_t>(m);
                    if (m) atomicAdd(&rcnt[row], __popc(m));
                }
            }
        }
    }
}

}  // namespace

// imgs u8 [B, H, W]; afrag: the needles [T, nh, nw] packed in fragment order
// by ops/ncc_kernels.py::pack_needle_fragments, uint4 [ceil(T/16), nks, 32]
// with nks = ceil(nh·ceil(nw/4) / 8); sn_n, rtn f32 [T]; mask int32 [B, T,
// H-nh+1, NW] (every word written); rcnt int32 [B, T, H-nh+1], zeroed by the
// caller. wide = 0: the narrow test (sn_n = Σn/n, rtn = √norm² or +inf, inv_n
// = f32(1/n)); wide = 1: the wide test (sn_n = f32(Σn), rtn = the needle's
// side of den or NaN, inv_n = 1/f32(n), and err, c_den, slack). Returns
// cudaGetLastError(), or cudaErrorInvalidValue where one block's page band
// alone exceeds the shared memory (a needle taller than ~850 rows).
extern "C" int focr_ncc_sweep(const void* imgs, int B, int H, int W,
                              const void* afrag, int T, int nh, int nw,
                              const void* sn_n, const void* rtn,
                              float thr_eps, float inv_n,
                              void* mask, void* rcnt, void* stream,
                              int wide, float err, float c_den, float slack)
{
    const int Hs = H - nh + 1;
    const int NW = (W - nw + 1 + 31) / 32;
    const int nw4 = (nw + 3) / 4;
    const int nks = (nh * nw4 + 7) / 8;
    const int pitch = XW * 32 + 4 * nw4;  // covers x + dx and the funnel's next word
    const int n_bands = (Hs + TR - 1) / TR;
    const int n_xt = (NW + XW - 1) / XW;
    const int n_mt = (T + 15) / 16;
    const int nmz = n_mt < MTZ ? n_mt : MTZ;  // M-tiles of the largest block
    // the shared memory: A's fragments where they fit beside the rest
    const size_t band = static_cast<size_t>(nmz) * 16 * 4 * 2
                        + static_cast<size_t>(nks) * 8 * 4
                        + static_cast<size_t>(TR + nh - 1) * pitch;
    const size_t a_bytes = static_cast<size_t>(nmz) * nks * 32 * 16;
    if (band > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const bool a_smem = band + a_bytes <= SMEM_MAX;
    const size_t smem = band + (a_smem ? a_bytes : 0);
    auto kernel = wide
        ? (a_smem ? focr_ncc_sweep_kernel<WIDE, true> : focr_ncc_sweep_kernel<WIDE, false>)
        : (a_smem ? focr_ncc_sweep_kernel<NARROW, true> : focr_ncc_sweep_kernel<NARROW, false>);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(n_bands * n_xt, B, (n_mt + MTZ - 1) / MTZ);
    kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(imgs), H, W,
        static_cast<const uint4*>(afrag), T, nh, nw, nks,
        static_cast<const float*>(sn_n), static_cast<const float*>(rtn),
        thr_eps, inv_n,
        static_cast<int32_t*>(mask), static_cast<int32_t*>(rcnt),
        Hs, NW, n_xt, pitch, WideTest{err, c_den, slack});
    return static_cast<int>(cudaGetLastError());
}
