// K5: the proportional focr decoder's greedy cursor scan (prop_scan), for
// NVIDIA Hopper (sm_90a).
//
// Replaces focr_tpu/models/focr_prop.py::make_prop_forward (:49-160, a
// lax.scan on the TPU): for every line strip, repeat until the cursor passes
// the strip's width w or n_steps is reached
//
//     s    = ox + pos;  t64 = floor(s*64 + 0.5);  k = t64 >> 6;  p = t64 & 63
//     g    = first argmin_g  (colsq_cum[g,p,thi] - colsq_cum[g,p,tlo])
//                            - 2 * sum_{y,c} win[y,c] * T[g,p,y,c]
//     ids[line, step] = g;  pos += adv[g]
//
// where win is the strip's columns [k - base, k - base + wbank), 0 outside
// [0, w), and tlo = clip(base - k, 0, wbank), thi = clip(w - k + base, 0,
// wbank) bound the template columns that lie on the canvas (the reference
// clips ink at the canvas edge, main.rs:96-106). Steps past the end write
// 255. The first minimum wins ties (Rust min_by_key, main.rs:159).
//
// Exactness: the cursor ops are IEEE f32, unfused and in the oracle's order
// (__fadd_rn/__fmul_rn; the build passes --fmad=false): a cursor one ulp off
// changes t64 at a phase boundary and derails the rest of the line. Every
// thread of a line's block runs the same chain on the same values, so all
// hold the same cursor without a broadcast. The dot is an integer sum of K =
// h * wbank products of at most 255 * 255, and the score is int32, exact while
// 3 * K * 65025 < 2^31 (the host checks it).
//
// What bounds it on the H100: the steps of a line are sequential. The
// canonical 16-page batch is 816 strips whose lines take at most 152 steps;
// each step is 67 glyphs × 228 multiply-adds, and the kernel moves ~0.4 MB a
// page (chip_smoke.py's bound: 0.00015 ms a page, by bytes). So what sets its
// time is the latency of the longest line's chain of steps, and of each
// step's loads: the previous design (lanes over glyphs, each lane reading its
// own glyph's template a byte at a time, 32 lanes on 32 cache lines, and 4
// warps a block) waited on ~700 dependent L2 byte loads a step.
//
// The design: one block per line, one warp per 32-glyph group (at most 4
// warps; a warp takes every 4th group past that), lanes over pixels. The
// host lays the templates out as [64 phases, G, KWP] 4-byte words
// (ops/prop_kernels.py::template_words, once a bank): each template row
// padded to ceil(wbank/4) words so that no word straddles two rows, the words of one
// (g, p) contiguous and padded with zeros to a multiple of 32. Each step the
// block builds the window in the same word layout in shared memory (a byte
// load a pixel from the L1-resident strip, 0 off the canvas and in the row
// padding: the strip's rows need not be 4-aligned and windows hang past
// either end); then lane l of a warp reads word c+l of each of its 32 glyphs'
// templates at the line's phase — 32 coalesced 128-byte loads a chunk, all
// independent — and keeps 32 partial __dp4a sums, one per glyph. A
// reduce-scatter over the lanes (16 + 8 + 4 + 2 + 1 xor-shuffles) leaves lane
// l with glyph g0+l's exact dot; each lane scores its glyph, a (score, g)
// xor-shuffle reduction finds the warp's first minimum, and the warps' minima
// meet in shared memory, where every thread picks the same (score, g) pair.
// Two barriers a step keep the window and the minima consistent.
//
// Left for a later PR: several lines a block sharing the templates of one
// phase in shared memory, the int8 tensor cores for the dot (a 32-glyph ×
// K × 1 product per step is too thin for them alone), and keeping a line's
// next step's template loads in flight across the barrier.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXW = 4;  // warps a line at most
constexpr int END_ID = 255;

// one level of the reduce-scatter below: lanes whose bit D is set keep the
// upper D items of v[0..2D), the others the lower D, each adding its xor
// partner's copy of them into v[0..D)
template <int D>
__device__ __forceinline__ void reduce_scatter_level(uint32_t (&v)[32], int lane)
{
    const bool up = lane & D;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const uint32_t send = up ? v[j] : v[j + D];
        const uint32_t keep = up ? v[j + D] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, D);
    }
}

// v[j] of lane l holds its partial sum for item j; afterwards v[0] of lane l
// holds the sum over the lanes for item l (the levels are templates so that
// every index into v is a constant and v stays in registers)
__device__ __forceinline__ void reduce_scatter32(uint32_t (&v)[32], int lane)
{
    reduce_scatter_level<16>(v, lane);
    reduce_scatter_level<8>(v, lane);
    reduce_scatter_level<4>(v, lane);
    reduce_scatter_level<2>(v, lane);
    reduce_scatter_level<1>(v, lane);
}

__global__ void __launch_bounds__(MAXW * 32)
focr_prop_scan_kernel(const uint8_t* __restrict__ strips, int h, int crop_w,
                 const uint32_t* __restrict__ tw, int kwp,
                 const int32_t* __restrict__ colsq, const float* __restrict__ adv,
                 int G, int wbank, int base, float ox, int n_steps,
                 uint8_t* __restrict__ ids)
{
    extern __shared__ uint32_t win_s[];  // the step's window, kwp words
    __shared__ int cand_s[MAXW];
    __shared__ int cand_g[MAXW];
    __shared__ float adv_s[END_ID];  // G < 255
    const int line = blockIdx.x;
    const int nwarps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const uint8_t* s = strips + static_cast<size_t>(line) * h * crop_w;
    uint8_t* out = ids + static_cast<size_t>(line) * n_steps;
    const int wb4 = (wbank + 3) >> 2;  // words a template row
    const int kw = h * wb4;
    const float w = static_cast<float>(crop_w);  // exact: crop_w < 2^24
    for (int g = threadIdx.x; g < G; g += blockDim.x) adv_s[g] = adv[g];
    __syncthreads();

    float pos = 0.f;
    int step = 0;
    for (; step < n_steps && pos < w; ++step) {
        const float sx = __fadd_rn(ox, pos);
        // sx >= 0 (ox, pos >= 0): floor(x + 0.5) rounds ties away from zero,
        // as FreeType's 26.6 conversion does
        const int t64 = static_cast<int>(floorf(__fadd_rn(__fmul_rn(sx, 64.f), 0.5f)));
        const int k = t64 >> 6;
        const int p = t64 & 63;
        const int tlo = min(max(base - k, 0), wbank);
        const int thi = min(max(crop_w - k + base, 0), wbank);
        const int x0 = k - base;
        // the window in the templates' word layout: byte j of word (y, q) is
        // column c = 4q + j of row y, 0 past wbank and off the canvas
        // (loads at clamped addresses, so all four are in flight at once)
        for (int m = threadIdx.x; m < kwp; m += blockDim.x) {
            const int y = min(m / wb4, h - 1);
            const int c0 = 4 * (m - (m / wb4) * wb4);
            uint32_t v = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = c0 + j;
                const uint32_t px = s[y * crop_w + min(max(x0 + c, 0), crop_w - 1)];
                if (m < kw && c < wbank && c >= tlo && c < thi) v |= px << (8 * j);
            }
            win_s[m] = v;
        }
        __syncthreads();

        int best_s = INT_MAX;
        int best_g = G;
        for (int g0 = warp * 32; g0 < G; g0 += nwarps * 32) {
            const int gn = min(32, G - g0);
            const int g = g0 + lane;
            const int32_t* cc =
                colsq + (static_cast<size_t>(min(g, G - 1)) * 64 + p) * (wbank + 1);
            const int tsq = cc[thi] - cc[tlo];
            // word c + lane of the 32 glyphs g0.. at phase p
            const uint32_t* tp = tw + (static_cast<size_t>(p) * G + g0) * kwp + lane;
            uint32_t part[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) part[j] = 0;
            for (int c = 0; c < kwp; c += 32) {
                const uint32_t wv = win_s[c + lane];
                // every load first (glyphs past G read the last glyph's words,
                // whose sums no lane keeps), then the dot products
                uint32_t tv[32];
#pragma unroll
                for (int j = 0; j < 32; ++j)
                    tv[j] = tp[static_cast<size_t>(min(j, gn - 1)) * kwp + c];
#pragma unroll
                for (int j = 0; j < 32; ++j) part[j] = __dp4a(wv, tv[j], part[j]);
            }
            reduce_scatter32(part, lane);
            const int score = tsq - 2 * static_cast<int>(part[0]);
            if (g < G && score < best_s) {  // g ascends within a lane: strict < keeps the first
                best_s = score;
                best_g = g;
            }
        }
#pragma unroll
        for (int d = 16; d; d >>= 1) {
            const int os = __shfl_xor_sync(0xffffffffu, best_s, d);
            const int og = __shfl_xor_sync(0xffffffffu, best_g, d);
            if (os < best_s || (os == best_s && og < best_g)) {
                best_s = os;
                best_g = og;
            }
        }
        if (lane == 0) {
            cand_s[warp] = best_s;
            cand_g[warp] = best_g;
        }
        __syncthreads();
        best_s = cand_s[0];
        best_g = cand_g[0];
        for (int i = 1; i < nwarps; ++i) {
            if (cand_s[i] < best_s || (cand_s[i] == best_s && cand_g[i] < best_g)) {
                best_s = cand_s[i];
                best_g = cand_g[i];
            }
        }
        if (threadIdx.x == 0) out[step] = static_cast<uint8_t>(best_g);
        pos = __fadd_rn(pos, adv_s[best_g]);
    }
    for (int i = step + threadIdx.x; i < n_steps; i += blockDim.x) out[i] = END_ID;
}

}  // namespace

// strips u8 [L, h, crop_w] (inverted); tw: the templates [G, 64, h, wbank]
// as 4-byte words [64, G, kwp] (ops/prop_kernels.py::template_words; kwp a
// multiple of 32); colsq int32 [G, 64, wbank+1]; adv f32 [G] -> ids u8
// [L, n_steps]. The host guarantees G < 255 and 3 * h * wbank * 65025 <
// 2^31. Returns cudaGetLastError().
extern "C" int focr_prop_scan(const void* strips, int L, int h, int crop_w,
                              const void* tw, int kwp, const void* colsq, const void* adv,
                              int G, int wbank, int base, float ox, int n_steps,
                              void* ids, void* stream)
{
    if (kwp % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int warps = min((G + 31) / 32, MAXW);
    focr_prop_scan_kernel<<<static_cast<unsigned>(L), warps * 32, static_cast<size_t>(kwp) * 4,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(strips), h, crop_w, static_cast<const uint32_t*>(tw), kwp,
        static_cast<const int32_t*>(colsq), static_cast<const float*>(adv), G, wbank, base, ox,
        n_steps, static_cast<uint8_t*>(ids));
    return static_cast<int>(cudaGetLastError());
}
