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
// changes t64 at a phase boundary and derails the rest of the line. The dot
// is an integer sum of K = h * wbank products of at most 255 * 255, and the
// score is int32, exact while 3 * K * 65025 < 2^31 (the host checks it).
//
// Design: one warp per line, looping over the steps inside the kernel with no
// host round trip. Each step the warp stages its window (K bytes, zero-filled
// off the strip) in shared memory; lanes stride the glyphs, each reading the
// window as a broadcast and its own glyph's template at the line's phase only
// (focr_tpu correlates all 64 phases and then picks one: 64x the work). Each
// lane keeps its best (score, g) with a strict <, and a xor-shuffle reduction
// on the pairs gives every lane the lowest g among equal scores.
//
// What bounds it on the H100: the steps of a line are sequential, so the
// kernel is latency-bound. The canonical 16-page batch is 816 lines of at most
// 170 steps of 67 x 228 multiply-adds (~2 G in all, far below the card's
// integer rate); the 978 KB bank stays in L2. Shared-memory tiling of the
// templates, __dp4a and tensor cores are left to a later change.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NWARPS = 4;
constexpr int END_ID = 255;

__global__ void __launch_bounds__(NWARPS * 32)
prop_scan_kernel(const uint8_t* __restrict__ strips, int L, int h, int crop_w,
                 const uint8_t* __restrict__ tmpl, const int32_t* __restrict__ colsq,
                 const float* __restrict__ adv, int G, int wbank, int base, float ox,
                 int n_steps, int win_stride, uint8_t* __restrict__ ids)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int line = blockIdx.x * NWARPS + warp;
    if (line >= L) return;  // whole warp; the block never synchronises
    unsigned char* win = smem + warp * win_stride;
    const uint8_t* s = strips + static_cast<size_t>(line) * h * crop_w;
    uint8_t* out = ids + static_cast<size_t>(line) * n_steps;
    const int K = h * wbank;
    const float w = static_cast<float>(crop_w);  // exact: crop_w < 2^24

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
        __syncwarp();  // the previous step's readers are done with win
        for (int i = lane; i < K; i += 32) {
            const int y = i / wbank;
            const int c = i - y * wbank;
            win[i] = (c >= tlo && c < thi) ? s[y * crop_w + x0 + c] : 0;
        }
        __syncwarp();

        int best_s = INT_MAX;
        int best_g = G;
        for (int g = lane; g < G; g += 32) {
            const size_t gp = static_cast<size_t>(g) * 64 + p;
            const uint8_t* t = tmpl + gp * K;
            int acc = 0;
#pragma unroll 4
            for (int i = 0; i < K; ++i) acc += static_cast<int>(win[i]) * static_cast<int>(t[i]);
            const int32_t* cc = colsq + gp * (wbank + 1);
            const int score = (cc[thi] - cc[tlo]) - 2 * acc;
            if (score < best_s) {  // g ascends within a lane: strict < keeps the first
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
        if (lane == 0) out[step] = static_cast<uint8_t>(best_g);
        pos = __fadd_rn(pos, adv[best_g]);
    }
    for (int i = step + lane; i < n_steps; i += 32) out[i] = END_ID;
}

}  // namespace

// strips u8 [L, h, crop_w] (inverted), tmpl u8 [G, 64, h, wbank], colsq int32
// [G, 64, wbank+1], adv f32 [G] -> ids u8 [L, n_steps]. The host guarantees
// G < 255 and 3 * h * wbank * 65025 < 2^31. Returns cudaGetLastError().
extern "C" int focr_prop_scan(const void* strips, int L, int h, int crop_w,
                              const void* tmpl, const void* colsq, const void* adv,
                              int G, int wbank, int base, float ox, int n_steps,
                              void* ids, void* stream)
{
    const int win_stride = (h * wbank + 15) / 16 * 16;  // <= 11008 bytes a warp
    const unsigned blocks = static_cast<unsigned>((L + NWARPS - 1) / NWARPS);
    prop_scan_kernel<<<blocks, NWARPS * 32, static_cast<size_t>(NWARPS) * win_stride,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(strips), L, h, crop_w, static_cast<const uint8_t*>(tmpl),
        static_cast<const int32_t*>(colsq), static_cast<const float*>(adv), G, wbank, base, ox,
        n_steps, win_stride, static_cast<uint8_t*>(ids));
    return static_cast<int>(cudaGetLastError());
}
