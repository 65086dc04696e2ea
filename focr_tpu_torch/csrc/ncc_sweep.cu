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
// The wide tier serves what the test above does not: needles with
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
// + 16 cover every rounding, so the set is still a superset. Each tier is a
// template instance (MODE).
//
// What bounds it on the H100. The canonical ncc wave (8 pages cropped to 766
// rows × 626 columns, 74 needles of 13×8 and 222 of 13×9) needs ~15.7 G u8
// multiply-adds a page: 31 G int8 operations, 0.016 ms at the 1,979 TOP/s of
// the int8 tensor cores; the mask plane it writes is ~17.4 MB a page, 0.005
// ms at 3.35 TB/s. So the correlation bounds it and belongs on the tensor
// cores (as the TPU kernel's jnp.dot on the MXU, pallas_ncc.py:197-201), on
// wgmma, the only way to their full rate. Padded as this design pads it
// (needles to 128, rows to 4-byte words, k-steps to 32 bytes) it is ~28 G
// multiply-adds, ~0.028 ms. Beside it the threshold test needs ~6.3
// instructions for each of the ~147 M (needle, window) pairs a page it
// tests: ~0.028 ms of the CUDA cores' issue rate alone, a floor of any
// design that tests every pair; the windows' A registers, sums and terms
// add ~30% to it. Measured (NVIDIA H100 80GB HBM3, 700 W): 0.131 ms/page,
// the CUDA cores issuing at about half their rate; doubling the tensor work
// adds only ~16%, so the instruction stream and the warpgroup's
// synchronisation at each wgmma, not the tensor cores, set the pace.
//
// The wgmma instance (focr_ncc_sweep_kernel; every shape of the main path):
//
//   acc is an implicit GEMM, wgmma.mma_async.m64n128k32.s32.u8.u8 (exact):
//   M = a tile of 64 consecutive windows of one window row, N = 128 needles
//   (a sub-chunk of the block's needles), K = the needle's pixels as 4-byte
//   words (dy, q), each needle row padded to nw4 = ceil(nw/4) words, the
//   total to a multiple of 8 words (32 bytes, one k-step): 4 k-steps for 13×8, 5 for 13×9. Those and -t 20's 11 have
//   straight-line instances (ptxas serialises wgmmas with a branch between
//   them, or with their accumulators read while another group runs); one
//   general instance a tier takes any other count up to KA.
//   A (the windows) is built in registers from the page band in shared
//   memory: register i of k-step s of lane 4g+tq in warp w holds window
//   16w + g + 8(i&1) and k-word 8s + tq + 4(i>>1), one __funnelshift_r of
//   two band words at the byte offset a per-item table gives (windows and
//   rows are not 4-aligned). No im2col tile is written.
//   B (the needles) is packed once a needle bank on the host
//   (ops/ncc_kernels.py::pack_needle_tiles) in wgmma's canonical K-major
//   layout without swizzle — core matrices of 8 needles × 16 bytes, the two
//   of a k-step 128 bytes apart, the next 8 needles 256 apart, 32·N bytes a
//   (sub-chunk, k-step) — and copied into shared memory once a block with
//   16-byte cp.async. A's padding k-words meet B's zero bytes, so they add
//   nothing to acc.
//
//   Σp and Σp² are per window: the four lanes of a quad hold every k-word of
//   their two windows in A's registers already, so each masks them to the
//   needle's real pixels (a per-k-word byte mask), sums them on __dp4a and
//   two xor-shuffles finish the sums. The window's f32 terms then come from
//   the test above, once a window, while the first wgmma runs.
//
//   Epilogue, a group of 64 needles at a time: C puts window 16w + g +
//   8(r>>1) against needle 8j + 2tq + (r&1) in d[4j + r]. Each pair's keep
//   bit is the sign of R − num (for finite values, set exactly when num > R:
//   neither is ever −0), shifted into a byte per r by one funnel shift; a
//   window outside the domain carries q = 0 and its bits are masked after,
//   and a needle that never keeps (zero variance, or past T) carries sn =
//   +inf and rtn = 0, so num = −inf and no NaN reaches a kept bit. An 8×8 bit
//   transpose over the lanes of one tq (three xor-shuffles) turns the four
//   bytes into two 16-bit halves of mask words, one a needle, staged in
//   shared memory; after a column chunk the block writes each needle's run of
//   words with consecutive threads on consecutive addresses, and adds the
//   row counts (exact integers) in shared memory, written once an item.
//
//   Block: one warpgroup, persistent (as many as the SMs hold): B and the
//   terms of up to 256 needles (a larger group spreads over grid.z) staged
//   once, then items of (page, ROWS = 4 window rows), each walked in column
//   chunks of COLS = 128 windows. A chunk's band — its page rows as the
//   aligned 4-byte words from each row's first byte on (the crop's rows are
//   626 bytes: not 16-byte aligned for TMA) — is copied by 4-byte cp.async
//   into one of two buffers while the chunk before it runs. Each sub-chunk's
//   wgmma is waited for before its epilogue; three blocks a SM overlap one
//   another's tensor work, epilogues and staging. ROWS, COLS and N are the
//   fastest of `tools/torch_cli_profile.py sweep-tiles`, which rebuilds this
//   file at other values; a block of 256 needles fits shared memory at every
//   shape the instances take (every_block_fits), so the launcher needs only
//   the shape.
//
// The mma instance (focr_ncc_sweep_mma_kernel; PR 5's design, for the shapes
// the wgmma instance cannot take: more k-steps than its registers hold, KA):
// acc on mma.sync.m16n8k32.row.col.s32.u8.u8.s32 with the roles swapped —
// M = 16 needles packed in A-fragment order (pack_needle_fragments), N = 8
// window columns built in registers from the band. A warp item is one window row × one 32-column mask word, every needle
// of the block in chunks of MT = 2 M-tiles; the C fragment's bits meet with
// two xor-shuffles; Σp, Σp² on __dp4a per column; row counts by atomics, so
// the caller zeroes rcnt. At most MTZ = 16 M-tiles a block (the rest on
// grid.z); A's fragments in shared memory where they fit, else read from
// device memory; a band that alone exceeds shared memory is refused.

#include <cstdint>
#include <mutex>
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
focr_ncc_sweep_mma_kernel(const uint8_t* __restrict__ imgs, int H, int W,
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


// PR 5's launcher of the mma instance (plan: ops/ncc_kernels.py::mma_plan)
int launch_mma(const void* imgs, int B, int H, int W, const void* afrag, int T, int nh, int nw,
               int nks, const void* sn_n, const void* rtn, float thr_eps, float inv_n,
               void* mask, void* rcnt, cudaStream_t stream, int wide, const WideTest& wt,
               int Hs, int NW)
{
    const int nw4 = (nw + 3) / 4;
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
        ? (a_smem ? focr_ncc_sweep_mma_kernel<WIDE, true> : focr_ncc_sweep_mma_kernel<WIDE, false>)
        : (a_smem ? focr_ncc_sweep_mma_kernel<NARROW, true>
                  : focr_ncc_sweep_mma_kernel<NARROW, false>);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(n_bands * n_xt, B, (n_mt + MTZ - 1) / MTZ);
    kernel<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const uint8_t*>(imgs), H, W,
        static_cast<const uint4*>(afrag), T, nh, nw, nks,
        static_cast<const float*>(sn_n), static_cast<const float*>(rtn),
        thr_eps, inv_n,
        static_cast<int32_t*>(mask), static_cast<int32_t*>(rcnt),
        Hs, NW, n_xt, pitch, wt);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wgmma instance (every shape of the main path; see the header).

constexpr int WG_THREADS = 128;       // one warpgroup a block
constexpr int TILE = 64;              // consecutive windows of one row a tile: wgmma's M
constexpr int WG_N = 128;             // needles a wgmma (its N): a sub-chunk of the block's
constexpr int NBMAX = 256;            // needles a block at most; the rest on grid.z
constexpr int ROWS = 4;               // window rows an item
constexpr int COLS = 128;             // windows a column chunk
constexpr int KA_NARROW = 8;          // k-steps of A a tile holds in registers, by instance
constexpr int KA_WIDE = 12;
constexpr int WPC = COLS / 32;        // mask words a chunk row
constexpr int NSTR = ROWS * WPC + 1;  // staged words a needle (odd: no bank conflicts)
static_assert(COLS % TILE == 0, "a column chunk is whole tiles");

// The shared memory of a block of nb needles with nks k-steps of nh x nw4
// words, as the kernel lays it out: B's sub-chunks, the needles' terms, the
// k-word table of each window row, two buffers of the band, the staged mask
// words and the row counts.
constexpr size_t wg_smem(int nks, int nh, int nw4, int nb)
{
    return static_cast<size_t>((nb + WG_N - 1) / WG_N) * nks * WG_N * 32 + 8 * nb
           + 64 * ROWS * nks + 8 * static_cast<size_t>(ROWS + nh - 1) * (COLS / 4 + nw4 + 2)
           + 4 * static_cast<size_t>(nb) * NSTR + 4 * nb * ROWS;
}

// A block of NBMAX needles fits at every shape the instances take: KA_WIDE
// k-steps bound B, and at each needle height the widest rows they hold
// bound the band.
constexpr bool every_block_fits()
{
    for (int nh = 1; nh <= 8 * KA_WIDE; ++nh)
        if (wg_smem(KA_WIDE, nh, 8 * KA_WIDE / nh, NBMAX) > SMEM_MAX) return false;
    return true;
}
static_assert(every_block_fits(), "a block of NBMAX needles must fit shared memory");

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps a register's value where it is across the asynchronous wgmma
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r) :: "memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// B's shared-memory descriptor: K-major, no swizzle. A core matrix is 8
// needles x 16 bytes (128 contiguous bytes); the two core matrices of a
// k-step's 32 bytes lie LBO = 128 apart, consecutive groups of 8 needles SBO
// = 256 apart (cute/arch/mma_sm90_desc.hpp's bit fields: start address >> 4
// at bit 0, LBO >> 4 at 16, SBO >> 4 at 32, layout type 0 at 62).
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr)
{
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16)
           | (static_cast<uint64_t>(256 >> 4) << 32);
}

// d (+)= A · B for one k-step: A 64 windows x 32 bytes from registers, B
// WG_N = 128 needles x 32 bytes from shared memory; u8 x u8 summed exactly
// into s32 (cute/arch/mma_sm90_gmma.hpp: SM90_64x128x32_S32U8U8_RS_TN)
__device__ __forceinline__ void wgmma_u8(int* d, const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate)
{
    static_assert(WG_N == 128, "the asm below is m64n128k32");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
          "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
          "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// k-steps 0 .. NK-1 of one sub-chunk into d, straight-line: a branch between
// the wgmmas of one commit group makes ptxas serialize them
template <int NK, int KA>
__device__ __forceinline__ void chain(int* d, const uint32_t (&a)[KA][4], uint32_t base)
{
#pragma unroll
    for (int s = 0; s < NK; ++s) wgmma_u8(d, a[s], b_desc(base + s * WG_N * 32), s > 0);
}

template <int NK, int KA>
__device__ __forceinline__ void chain_of(int nks, int* d, const uint32_t (&a)[KA][4], uint32_t base)
{
    if constexpr (NK > 1) {
        if (nks < NK) return chain_of<NK - 1, KA>(nks, d, a, base);
    }
    chain<NK, KA>(d, a, base);
}

// every k-step of sub-chunk c into d, as one commit group (NKS > 0: the
// instance's k-steps; 0: nks of them, up to KA)
template <int KA, int NKS>
__device__ __forceinline__ void issue(int* d, const uint32_t (&a)[KA][4], int nks, uint32_t bs_addr,
                                      int c)
{
#pragma unroll
    for (int i = 0; i < WG_N / 2; ++i) pin(d[i]);
    wg_fence();
    if constexpr (NKS > 0)
        chain<NKS, KA>(d, a, bs_addr + c * NKS * WG_N * 32);
    else
        chain_of<KA, KA>(nks, d, a, bs_addr + c * nks * WG_N * 32);
    wg_commit();
}

// cp.async: copies to shared memory that no register waits on
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The band of a column chunk into dst: page rows y0 .. y0 + brows - 1 of page
// b, each as the pw aligned words from the one holding its byte (y, xb) on,
// so the row's first byte sits at byte (o & 3) of its first word. A word
// past the tensor is zero (a partial last word is filled from the bytes that
// exist); bytes past a row's end are the next row's, which only windows
// outside the test's domain read.
__device__ __forceinline__ void stage_band(uint32_t dst, const uint8_t* imgs, long long nbytes,
                                           int b, int H, int W, int y0, int xb, int brows, int pw)
{
    int rr = threadIdx.x / pw, wi = threadIdx.x - rr * pw;  // (row, word) of element i
    for (int i = threadIdx.x; i < brows * pw; i += WG_THREADS) {
        const long long o = (static_cast<long long>(b) * H + y0 + rr) * W + xb;
        const long long at = (o & ~3LL) + 4LL * wi;
        const long long left = nbytes - at;
        const int n = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
        cp_async4(dst + 4 * i, imgs + (n ? at : 0), n);
        for (wi += WG_THREADS; wi >= pw; wi -= pw) ++rr;
    }
}

// one (needle, window) pair's keep bit, shifted in at bit 0 of bits: the sign
// of R − num, set exactly when num > R (neither is NaN nor −0 where the bit
// is kept; see the header)
template <int MODE>
__device__ __forceinline__ uint32_t keep_bit(uint32_t bits, int acc, float sn, float rtn,
                                             float spf, float q, float thr_eps, float inv_n,
                                             const WideTest& wt)
{
    float diff;
    if constexpr (MODE == WIDE) {
        const float num = __fsub_rn(__uint2float_rn(static_cast<uint32_t>(acc)),
                                    __fmul_rn(__fmul_rn(sn, spf), inv_n));
        const float den = __fmul_rn(__fmul_rn(rtn, q), wt.c_den);
        diff = __fsub_rn(__fsub_rn(__fmul_rn(thr_eps, den), wt.slack), num);
    } else {
        const float num = __fmaf_rn(-sn, spf, static_cast<float>(acc));
        diff = __fsub_rn(__fmaf_rn(thr_eps, __fmul_rn(rtn, q), -48.f), num);
    }
    return __funnelshift_l(__float_as_uint(diff), bits, 1);
}

// The keep bits of the 64 needles n_base .. n_base+63 of the block (d: their
// 32 accumulators of the sub-chunk) for the thread's two windows, staged in
// shared memory as 16-bit halves of the mask words. C: lane 4g+tq of warp w
// holds d[4j + r] = (window 16w + g + 8(r>>1), needle 8j + 2tq + (r&1)).
// Each r gathers its 8 j's bits in a byte (bit j), the four bytes make one
// word, and an 8x8 bit transpose over the lanes of one tq (xor-shuffles 4,
// 8, 16) leaves lane (g', tq) bit 8r + g for needle group j = g': two 16-bit
// halves (windows 16w .. 16w+15), one a needle.
template <int MODE>
__device__ __forceinline__ void epilogue(const int* d, int n_base, int nbv,
                                         const float* __restrict__ terms_s, const float (&spf)[2],
                                         const float (&qv)[2], uint32_t vmask, float thr_eps,
                                         float inv_n, const WideTest& wt, uint16_t* stage,
                                         int gq, int tq)
{
    const int nj = min(8, (nbv - n_base + 7) >> 3);  // groups of 8 needles that hold one
    uint32_t by[4] = {0u, 0u, 0u, 0u};
    const auto group_j = [&](int j) {
        const float4 tm = *reinterpret_cast<const float4*>(terms_s + 2 * (n_base + 8 * j + 2 * tq));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float sn = (r & 1) ? tm.z : tm.x, rtn = (r & 1) ? tm.w : tm.y;
            by[r] = keep_bit<MODE>(by[r], d[4 * j + r], sn, rtn, spf[r >> 1], qv[r >> 1],
                                   thr_eps, inv_n, wt);
        }
    };
    if (nj == 8) {  // a full group: no branch between the loads and the arithmetic
#pragma unroll
        for (int j = 7; j >= 0; --j) group_j(j);
    } else {
#pragma unroll
        for (int j = 7; j >= 0; --j)
            if (j < nj) group_j(j);
    }
    uint32_t t = __byte_perm(__byte_perm(by[0], by[1], 0x0040), __byte_perm(by[2], by[3], 0x0040),
                             0x5410);  // bit 8r + j
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const uint32_t m = k == 0 ? 0x55555555u : (k == 1 ? 0x33333333u : 0x0F0F0F0Fu);
        const bool upper = (gq >> k) & 1;
        const uint32_t out = upper ? ((t & m) << (1 << k)) : ((t >> (1 << k)) & m);
        t = (t & (upper ? ~m : m)) | __shfl_xor_sync(0xffffffffu, out, 4 << k);
    }
    // lane (g', tq): needles n_base + 8g' + 2tq + e, bits 8(e + 2h) + g
    const int n0 = n_base + 8 * gq + 2 * tq;
    if (n0 < nbv) stage[2 * n0 * NSTR] = static_cast<uint16_t>(__byte_perm(t, 0, 0x4420) & vmask);
    if (n0 + 1 < nbv)
        stage[2 * (n0 + 1) * NSTR] = static_cast<uint16_t>(__byte_perm(t, 0, 0x4431) & vmask);
}

// KA: the k-steps A holds; NKS: the needles' k-steps where the instance is
// compiled for them (straight-line A and wgmma chains), 0 for any up to KA
template <int MODE, int KA, int NKS>
__global__ void __launch_bounds__(WG_THREADS, MODE == NARROW ? 3 : 2)
focr_ncc_sweep_kernel(const uint8_t* __restrict__ imgs, long long img_bytes, int H, int W,
                      const uint4* __restrict__ bpack, int T, int nh, int nw, int nks_rt,
                      const float* __restrict__ sn_n, const float* __restrict__ rtn,
                      float thr_eps, float inv_n,
                      int32_t* __restrict__ mask, int32_t* __restrict__ rcnt,
                      int B, int Hs, int NW, int nb, WideTest wt)
{
    extern __shared__ __align__(128) unsigned char smem[];
    const int nks = NKS > 0 ? NKS : nks_rt;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int nw4 = (nw + 3) >> 2;
    const int t0 = blockIdx.z * nb;                // the block's first needle
    const int nbv = min(nb, T - t0);               // and its needles
    const int nsub = (nbv + WG_N - 1) / WG_N;      // its sub-chunks
    const int pw = COLS / 4 + nw4 + 2;             // band words a row
    const int brows = ROWS + nh - 1;
    const int Wv = W - nw + 1;
    // the block's items: (page b, window rows y0 .. y0 + ROWS - 1), every
    // gridDim.x-th of B·ceil(Hs/ROWS), each in column chunks
    const int n_yb = (Hs + ROWS - 1) / ROWS;
    const int n_items = B * n_yb;
    const int nchunks = (NW + WPC - 1) / WPC;
    int it = blockIdx.x, b = it / n_yb, y0 = (it - b * n_yb) * ROWS, nrv = min(ROWS, Hs - y0);

    // bs: the block's sub-chunks of B, [c][s][32·WG_N] as packed by the host;
    // terms_s: (sn, rtn) a needle, +inf and 0 for one that never keeps;
    // kt_s[r][w]: for tile row r, k-word w's byte offset in the band (its
    // row's, that row's first byte's place in its word, 4q) and its byte mask
    // (the needle's real pixels); band_s: two buffers of a chunk's band
    // (stage_band), the next chunk's copied while this one's tiles run;
    // stage: the chunk's mask words a needle (16-bit halves written by the
    // epilogue); cnt_s: row counts
    unsigned char* bs = smem;
    float* terms_s = reinterpret_cast<float*>(smem + static_cast<size_t>(nsub) * nks * WG_N * 32);
    int2* kt_s = reinterpret_cast<int2*>(terms_s + 2 * nb);
    uint32_t* band_s = reinterpret_cast<uint32_t*>(kt_s + ROWS * nks * 8);
    uint32_t* stage = band_s + 2 * brows * pw;
    int* cnt_s = reinterpret_cast<int*>(stage + nb * NSTR);
    const uint32_t bs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
    const uint32_t band_addr = static_cast<uint32_t>(__cvta_generic_to_shared(band_s));

    {
        const uint4* src = bpack + static_cast<size_t>(t0 / WG_N) * nks * (WG_N * 2);
        for (int i = tid; i < nsub * nks * (WG_N * 2); i += WG_THREADS)
            cp_async16(bs_addr + 16 * i, src + i);
    }
    stage_band(band_addr, imgs, img_bytes, b, H, W, y0, 0, brows, pw);
    cp_commit();
    for (int i = tid; i < nb; i += WG_THREADS) {
        const float r = i < nbv ? rtn[t0 + i] : 0.f;
        const bool ok = i < nbv && fabsf(r) <= __int_as_float(0x7f7fffff);  // finite
        terms_s[2 * i] = ok ? sn_n[t0 + i] : __int_as_float(0x7f800000);
        terms_s[2 * i + 1] = ok ? r : 0.f;
    }
    // the item's k-word table: a row's first byte sits at byte ((b·H + y)·W) & 3
    const auto k_table = [&]() {
        for (int i = tid; i < ROWS * nks * 8; i += WG_THREADS) {
            const int r = i / (nks * 8), w = i - r * (nks * 8);
            const int dy = w / nw4, q = w - dy * nw4;
            const int rr = r + (dy < nh ? dy : 0);
            const int mis = static_cast<int>(((static_cast<long long>(b) * H + y0 + rr) * W) & 3);
            const int valid = nw - 4 * q;
            const int pm = valid >= 4 ? -1 : static_cast<int>((1u << (8 * valid)) - 1u);
            kt_s[i] = make_int2(rr * 4 * pw + mis + (dy < nh ? 4 * q : 0), dy < nh ? pm : 0);
        }
    };
    k_table();
    for (int i = tid; i < nb * ROWS; i += WG_THREADS) cnt_s[i] = 0;

    int acc[WG_N / 2];
#pragma unroll
    for (int i = 0; i < WG_N / 2; ++i) acc[i] = 0;
    uint32_t a[KA][4];
    // every (item, chunk) of the block in turn; the next one's band is copied
    // into the other buffer while this one's tiles run
    for (int ch = 0, k = 0;; ++k) {
        const int g0 = ch * WPC;            // the chunk's first mask word
        const int nwv = min(WPC, NW - g0);  // and its words
        const int ch_n = ch + 1 < nchunks ? ch + 1 : 0;
        const int it_n = ch + 1 < nchunks ? it : it + gridDim.x;
        if (it_n < n_items) {
            const int b_n = it_n / n_yb;
            stage_band(band_addr + 4 * ((k + 1) & 1) * brows * pw, imgs, img_bytes, b_n, H, W,
                       (it_n - b_n * n_yb) * ROWS, ch_n * COLS, brows, pw);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();  // the band is in; the last chunk's stores are done with stage
        const uint32_t* band = band_s + (k & 1) * brows * pw;
        const int ntiles = (nwv + 1) >> 1;
        for (int item = 0; item < nrv * ntiles; ++item) {
            const int r = item / ntiles, tl = item - r * ntiles;
            const int y = y0 + r;
            // A: register i of k-step s holds window 16w + g + 8(i&1) and
            // k-word 8s + tq + 4(i>>1), four bytes of the band from byte
            // offset kt.x + x; the quad's lanes hold every k-word of their two
            // windows, so Σp and Σp² come from the same registers
            const int xl0 = TILE * tl + 16 * warp + gq;  // the thread's windows xl0, xl0 + 8
            const int2* ktr = kt_s + r * nks * 8;
            uint32_t sp[2] = {0u, 0u}, s2p[2] = {0u, 0u};
            int2 kt_r[KA][2];  // loaded together: no load waits on another
#pragma unroll
            for (int s = 0; s < KA; ++s)
                if (NKS > 0 ? s < NKS : s < nks)
#pragma unroll
                    for (int hk = 0; hk < 2; ++hk) kt_r[s][hk] = ktr[8 * s + tq + 4 * hk];
#pragma unroll
            for (int s = 0; s < KA; ++s) {
                if (NKS > 0 ? s < NKS : s < nks) {
#pragma unroll
                    for (int hk = 0; hk < 2; ++hk) {
                        const int2 kt = kt_r[s][hk];
                        const int sh = ((kt.x + xl0) & 3) * 8;
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const uint32_t* p = band + ((kt.x + xl0 + 8 * h) >> 2);
                            const uint32_t v = __funnelshift_r(p[0], p[1], sh);
                            a[s][h + 2 * hk] = v;
                            const uint32_t m = v & static_cast<uint32_t>(kt.y);
                            sp[h] = __dp4a(m, 0x01010101u, sp[h]);
                            s2p[h] = __dp4a(m, m, s2p[h]);
                        }
                    }
                }
            }
            issue<KA, NKS>(acc, a, nks, bs_addr, 0);
            // the windows' terms while the first sub-chunk runs
            float spf[2], qv[2];
            uint32_t vmask = 0u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                sp[h] += __shfl_xor_sync(0xffffffffu, sp[h], 1);
                sp[h] += __shfl_xor_sync(0xffffffffu, sp[h], 2);
                s2p[h] += __shfl_xor_sync(0xffffffffu, s2p[h], 1);
                s2p[h] += __shfl_xor_sync(0xffffffffu, s2p[h], 2);
                const int x = ch * COLS + xl0 + 8 * h;
                bool ok;
                float q;
                if constexpr (MODE == WIDE) {
                    // sp < 2^24 converts exactly; s2p (< 2^31) rounds, as in ncc_candidates
                    spf[h] = __int2float_rn(static_cast<int>(sp[h]));
                    const float norm2p = __fsub_rn(__int2float_rn(static_cast<int>(s2p[h])),
                                                   __fdiv_rn(__fmul_rn(spf[h], spf[h]),
                                                             __int2float_rn(nh * nw)));
                    const long long var = static_cast<long long>(nh * nw) * s2p[h]
                                          - static_cast<long long>(sp[h]) * sp[h];
                    ok = sp[h] > 0 && var > 0 && x >= 1 && x < Wv && y >= 1;
                    q = __fsqrt_rn(fmaxf(__fadd_rn(norm2p, wt.err), 0.f));
                } else {
                    // every value is an exact integer < 2^24 (n·65025 < 2^24
                    // picks this instance), so the int -> f32 conversions are exact
                    spf[h] = static_cast<float>(static_cast<int>(sp[h]));
                    const float s2pf = static_cast<float>(static_cast<int>(s2p[h]));
                    const float norm2p = __fmaf_rn(-__fmul_rn(spf[h], spf[h]), inv_n, s2pf);
                    ok = spf[h] > 0.f && norm2p > -8.f && x >= 1 && x < Wv && y >= 1;
                    q = __fsqrt_rn(fmaxf(__fsub_rn(norm2p, 8.f), 0.f));
                }
                qv[h] = ok ? q : 0.f;  // a window outside the test's domain: its bits are masked
                vmask |= static_cast<uint32_t>(ok) << (gq + 8 * h);
            }
            vmask |= __shfl_xor_sync(0xffffffffu, vmask, 4);
            vmask |= __shfl_xor_sync(0xffffffffu, vmask, 8);
            vmask |= __shfl_xor_sync(0xffffffffu, vmask, 16);
            // the warp's half of mask word 2·tl + (w >> 1), row r, needle 0
            uint16_t* st = reinterpret_cast<uint16_t*>(stage) + 2 * (r * WPC + 2 * tl + (warp >> 1))
                           + (warp & 1);
            // each sub-chunk's wgmma, then its epilogue; other blocks on the SM
            // fill the tensor cores meanwhile
            for (int c = 0; c < nsub; ++c) {
                if (c > 0) issue<KA, NKS>(acc, a, nks, bs_addr, c);
                wg_wait<0>();
#pragma unroll
                for (int i = 0; i < WG_N / 2; ++i) pin(acc[i]);
#pragma unroll
                for (int gi = 0; gi < WG_N / 64; ++gi)
                    if (WG_N * c + 64 * gi < nbv)
                        epilogue<MODE>(acc + 32 * gi, WG_N * c + 64 * gi, nbv, terms_s, spf, qv,
                                       vmask, thr_eps, inv_n, wt, st, gq, tq);
            }
            // every wgmma of the tile has read its A: the registers may change
#pragma unroll
            for (int s = 0; s < KA; ++s)
                if (NKS > 0 ? s < NKS : s < nks) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) pin(a[s][i]);
                }
        }
        __syncthreads();  // every tile of the chunk is done with its band, stage and table
        // the chunk's words leave coalesced: consecutive threads, consecutive
        // words of one needle's row; the row counts are exact integer sums
        constexpr int PER = ROWS * WPC;  // staged words a needle that hold mask words
        for (int i = tid; i < nbv * PER; i += WG_THREADS) {
            // unsigned, so that each division by a power of two is one shift
            // (tools/torch_k1_probes.py store-signed times the signed ones)
            const unsigned u = static_cast<unsigned>(i), j = u % PER;
            const int n = u / PER, r = j / WPC, wd = j % WPC;
            if (r < nrv && wd < nwv) {
                const uint32_t v = stage[n * NSTR + j];
                mask[((static_cast<size_t>(b) * T + t0 + n) * Hs + y0 + r) * NW + g0 + wd] =
                    static_cast<int32_t>(v);
                if (v) atomicAdd(&cnt_s[n * ROWS + r], __popc(v));
            }
        }
        if (ch_n == 0) {  // the item is done: its row counts, then the next item
            __syncthreads();
            for (int i = tid; i < nbv * ROWS; i += WG_THREADS) {
                const int n = i / ROWS, r = i - n * ROWS;
                if (r < nrv) rcnt[(static_cast<size_t>(b) * T + t0 + n) * Hs + y0 + r] = cnt_s[i];
                cnt_s[i] = 0;
            }
            if (it_n >= n_items) break;
            it = it_n;
            b = it / n_yb;
            y0 = (it - b * n_yb) * ROWS;
            nrv = min(ROWS, Hs - y0);
            k_table();
        }
        ch = ch_n;
    }
}

// Blocks of a kernel that the card holds at once, by (device, kernel, shared
// memory): the attribute and the occupancy queries cost microseconds, and a
// path launches a few shapes over and over.
struct Resident {
    int dev;
    const void* fn;
    size_t smem;
    int blocks;
};
std::mutex resident_mu;
Resident resident[64];
int n_resident = 0;

cudaError_t resident_blocks(const void* fn, size_t smem, int* blocks)
{
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(resident_mu);
    for (int i = 0; i < n_resident; ++i)
        if (resident[i].dev == dev && resident[i].fn == fn && resident[i].smem == smem) {
            *blocks = resident[i].blocks;
            return cudaSuccess;
        }
    // every shape's shared memory is at most SMEM_MAX (every_block_fits)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_MAX));
    int n_sm = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, WG_THREADS, smem);
    if (e != cudaSuccess) return e;
    *blocks = n_sm * per_sm;
    if (n_resident < 64) resident[n_resident++] = Resident{dev, fn, smem, *blocks};
    return cudaSuccess;
}

}  // namespace

// imgs u8 [B, H, W] (4-byte aligned for the wgmma instance); packed: the
// needles [T, nh, nw] as the instance takes them (ops/ncc_kernels.py::
// pack_needles): instance 0 (wgmma) u8 [ceil(T/128), nks, 32·128], B's
// sub-chunks in their shared-memory layout (pack_needle_tiles); instance 1
// (mma) uint4 [ceil(T/16), nks, 32] in fragment order
// (pack_needle_fragments); nks = ceil(nh·ceil(nw/4) / 8). sn_n, rtn f32 [T];
// mask int32 [B, T, H-nh+1, NW] (every word written); rcnt int32 [B, T,
// H-nh+1] (the wgmma instance writes every count, the mma instance adds to
// counts the caller zeroed). wide = 0: the narrow test (sn_n = Σn/n, rtn =
// √norm² or +inf, inv_n = f32(1/n)); wide = 1: the wide test (sn_n = f32(Σn),
// rtn = the needle's side of den or NaN, inv_n = 1/f32(n), and err, c_den,
// slack). instance: ops/ncc_kernels.py::sweep_plan's. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an instance the shape
// cannot take (the wgmma one past KA k-steps or on unaligned tensors; the
// mma one when its band alone exceeds shared memory).
extern "C" int focr_ncc_sweep(const void* imgs, int B, int H, int W,
                              const void* packed, int T, int nh, int nw,
                              const void* sn_n, const void* rtn,
                              float thr_eps, float inv_n,
                              void* mask, void* rcnt, void* stream,
                              int wide, float err, float c_den, float slack, int instance)
{
    const int Hs = H - nh + 1;
    const int NW = (W - nw + 1 + 31) / 32;
    const int nw4 = (nw + 3) / 4;
    const int nks = (nh * nw4 + 7) / 8;
    const WideTest wt{err, c_den, slack};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (instance == 1) return launch_mma(imgs, B, H, W, packed, T, nh, nw, nks, sn_n, rtn,
                                         thr_eps, inv_n, mask, rcnt, st, wide, wt, Hs, NW);
    if (instance != 0 || nks > (wide ? KA_WIDE : KA_NARROW)
        || (reinterpret_cast<uintptr_t>(imgs) & 3) || (reinterpret_cast<uintptr_t>(packed) & 15))
        return static_cast<int>(cudaErrorInvalidValue);
    // up to NBMAX needles a block, in whole sub-chunks
    const int nb_t = (T + WG_N - 1) / WG_N * WG_N;
    const int nb = nb_t < NBMAX ? nb_t : NBMAX;
    const size_t smem = wg_smem(nks, nh, nw4, nb);
    // straight-line instances for the main path's k-steps (13x8, 13x9; 21x13
    // at -t 20), a general one for the rest
    auto kernel = wide ? (nks == 11 ? focr_ncc_sweep_kernel<WIDE, 11, 11>
                                    : focr_ncc_sweep_kernel<WIDE, KA_WIDE, 0>)
                  : nks == 4 ? focr_ncc_sweep_kernel<NARROW, 4, 4>
                  : nks == 5 ? focr_ncc_sweep_kernel<NARROW, 5, 5>
                             : focr_ncc_sweep_kernel<NARROW, KA_NARROW, 0>;
    // persistent blocks: as many as the SMs hold at once, each walking its
    // items (B and the needles' terms are staged once a block)
    int held = 0;
    const cudaError_t e = resident_blocks(reinterpret_cast<const void*>(kernel), smem, &held);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_items = B * ((Hs + ROWS - 1) / ROWS);
    const int n_blocks = held < n_items ? held : n_items;
    if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(n_blocks, 1, (T + nb - 1) / nb);
    kernel<<<grid, WG_THREADS, smem, st>>>(
        static_cast<const uint8_t*>(imgs), static_cast<long long>(B) * H * W, H, W,
        static_cast<const uint4*>(packed), T, nh, nw, nks,
        static_cast<const float*>(sn_n), static_cast<const float*>(rtn), thr_eps, inv_n,
        static_cast<int32_t*>(mask), static_cast<int32_t*>(rcnt), B, Hs, NW, nb, wt);
    return static_cast<int>(cudaGetLastError());
}
