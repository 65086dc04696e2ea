// K4: the focr grid decoder's strip step (ssd_argmin), for NVIDIA Hopper (sm_90a).
//
// Replaces focr_tpu/models/focr.py::make_strip_forward (:60-80, XLA on the
// TPU, with focr_tpu/ops/ssd.py): for every line strip, invert it
// (255 - x, main.rs:150), flag it white when every byte is 255
// (main.rs:208-211), and for every cell c of the static cursor grid pick
//
//     argmin_g  tsq[c,g] - 2 * sum_{y,x} (255 - strip[y, wx0[c] + x]) * T[c,g,y,x]
//
// with the first minimum winning ties (Rust min_by_key, main.rs:159).
// Columns at or past crop_w count as 0, as extract_windows' zero pad does.
//
// Exactness: the dot is an integer sum of n = h * win_w products of at most
// 255 * 255, accumulated in int32 while n * 65025 < 2^31 and in int64 beyond
// (the host picks the instance); the metric is int64. The TPU needed bf16
// matmuls split into nibbles to stay exact; integer multiply-adds need none.
//
// Design: one block per strip, one warp per cell (warps stride the cells),
// lanes stride the glyphs. Every lane of a warp reads the same window byte
// at the same time (a broadcast) and its own glyph's template byte; each lane
// keeps its best (metric, g) with a strict <, and a shuffle reduction on the
// (metric, g) pairs picks the lowest g among equal metrics. `white` is a
// block-wide OR over the strip's bytes.
//
// What bounds it on the H100: the canonical page is ~28 M u8 multiply-adds
// (51 rows x 78 cells x 67 glyphs x 108 pixels), so the kernel is bound by
// its load and integer-issue latency, not by bytes (the 564 KB template bank
// stays in L2). Shared-memory tiling of the templates and tensor cores are
// left to a later change.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NWARPS = 8;

template <typename Acc>
__global__ void __launch_bounds__(NWARPS * 32)
ssd_argmin_kernel(const uint8_t* __restrict__ strips, int h, int crop_w,
                  const uint8_t* __restrict__ tmpl, const int64_t* __restrict__ tsq,
                  const int32_t* __restrict__ wx0, int C, int G, int win_w,
                  int32_t* __restrict__ ids, bool* __restrict__ white)
{
    const long long strip = blockIdx.x;
    const uint8_t* s = strips + strip * h * crop_w;

    int ink = 0;
    for (int i = threadIdx.x; i < h * crop_w; i += blockDim.x) ink |= s[i] != 255;
    ink = __syncthreads_or(ink);
    if (threadIdx.x == 0) white[strip] = !ink;

    const int lane = threadIdx.x & 31;
    const int n = h * win_w;
    for (int c = threadIdx.x >> 5; c < C; c += NWARPS) {
        const int x0 = wx0[c];
        // window columns that lie inside the strip; the rest count as 0
        const int xlo = x0 < 0 ? -x0 : 0;
        const int xhi = min(win_w, crop_w - x0);
        const uint8_t* tc = tmpl + static_cast<long long>(c) * G * n;
        long long best_m = LLONG_MAX;
        int best_g = G;
        for (int g = lane; g < G; g += 32) {
            const uint8_t* t = tc + static_cast<long long>(g) * n;
            Acc acc = 0;
            for (int y = 0; y < h; ++y) {
                const uint8_t* srow = s + y * crop_w + x0;
                const uint8_t* trow = t + y * win_w;
                for (int x = xlo; x < xhi; ++x)
                    acc += static_cast<Acc>(255 - srow[x]) * static_cast<Acc>(trow[x]);
            }
            const long long m = tsq[static_cast<long long>(c) * G + g] - 2 * static_cast<long long>(acc);
            if (m < best_m) {  // g ascends within a lane: strict < keeps the first
                best_m = m;
                best_g = g;
            }
        }
#pragma unroll
        for (int d = 16; d; d >>= 1) {
            const long long om = __shfl_xor_sync(0xffffffffu, best_m, d);
            const int og = __shfl_xor_sync(0xffffffffu, best_g, d);
            if (om < best_m || (om == best_m && og < best_g)) {
                best_m = om;
                best_g = og;
            }
        }
        if (lane == 0) ids[strip * C + c] = best_g;
    }
}

}  // namespace

// strips u8 [n_strips, h, crop_w] (not inverted), tmpl u8 [C, G, h, win_w],
// tsq int64 [C, G], wx0 int32 [C] -> ids int32 [n_strips, C], white bool
// [n_strips]. Returns cudaGetLastError().
extern "C" int focr_ssd_argmin(const void* strips, long long n_strips, int h, int crop_w,
                               const void* tmpl, const void* tsq, const void* wx0,
                               int C, int G, int win_w, void* ids, void* white, void* stream)
{
    const bool wide = static_cast<long long>(h) * win_w * 65025LL >= (1LL << 31);
    auto kernel = wide ? ssd_argmin_kernel<long long> : ssd_argmin_kernel<int>;
    kernel<<<static_cast<unsigned>(n_strips), NWARPS * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(strips), h, crop_w, static_cast<const uint8_t*>(tmpl),
        static_cast<const int64_t*>(tsq), static_cast<const int32_t*>(wx0), C, G, win_w,
        static_cast<int32_t*>(ids), static_cast<bool*>(white));
    return static_cast<int>(cudaGetLastError());
}
