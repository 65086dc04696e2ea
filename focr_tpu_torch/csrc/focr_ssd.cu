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
// Two instances; the shape picks one (the host mirrors the choice in
// ops/ssd_kernels.py::ssd_plan):
//
//   mma   — every window with n = h * win_w < 33026 (n * 65025 < 2^31, so
//           the u8 dot is exact in s32) whose block of 16 strips fits in
//           shared memory: the dot on the int8 tensor cores;
//   int64 — everything else: the CUDA-core kernel, int64 dot.
//
// The mma instance computes, for each cell, the product of A, the inverted
// windows of 16 strips, and B, the cell's templates, with
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 (exact: u8 x u8 summed in s32).
//
//   M = 16 strips (a block's). K = the window's pixels as 4-byte words
//   (dy, q), each window row padded to nw4 = ceil(win_w/4) words, the total
//   to a multiple of 8 words (32 bytes, one k-step): 5 k-steps for the
//   canonical 12x9 window, 2 for 3x9. N = 8 glyphs an n-tile, G padded to a
//   multiple of 8 (67 -> 72, nine n-tiles).
//   B is packed once a bank on the host in fragment order
//   (ops/ssd_kernels.py::pack_template_fragments: a uint2 a lane for each
//   (cell, n-tile, k-step)), with zero bytes past win_w, past h and past G,
//   so whatever window bytes meet them add nothing.
//   A is built in registers: the block stages its 16 strips, inverted, in
//   shared memory with rows of `pitch` bytes that are zero past crop_w (the
//   columns past the strip's edge read as 0, as the plain version's pad);
//   lane 4g+tq's register i holds strip g + 8(i & 1) and k-word
//   8s + tq + 4(i >> 1), one __funnelshift_r of two shared words at byte
//   offset (dy * pitch + 4q) from a per-block table plus the cell's start
//   column (windows start at any byte).
//   C: lane 4g+tq holds strips g and g+8 against glyphs 8nt + 2tq and
//   8nt + 2tq + 1 of each n-tile. metric = tsq - 2 * acc in int64; each lane
//   keeps a strict-< minimum over its glyphs in ascending order (padded
//   glyphs never enter), and two xor-shuffles (1, 2) across the quad finish
//   it by (metric, g), so the lowest glyph wins a tie.
//
// Block: one M-tile of 16 strips and 16 cells, a warp a cell (the cells
// spread over grid.y: the canonical h = 12 launch has 250 blocks), each
// cell's A fragments for up to KH = 5 k-steps built once and held for every
// n-tile (a larger window rebuilds them for each n-tile and each KH k-steps).
// A block stages only the columns its 16 cells read (about a fifth of a
// canonical strip), in 16-byte loads, SU in flight a thread; the blocks of
// grid.y 0 stage whole rows and give the white flags.
//
// What bounds it on the H100: the canonical page is ~28.8 M u8 multiply-adds
// (51 rows x 78 cells x 67 glyphs x 108 pixels), ~0.03 us at the int8
// tensor-core rate, and its strips and bank are ~0.4 MB; so at these sizes
// the kernel is bound by latency (staging a block's strips, the template
// fragments' loads from L2 for each n-tile), not by either roofline term.
//
// K4p, the partial first-minimum of a glyph shard (focr_tpu/parallel/
// decode.py:71-73, the argmin and take_along_axis on a shard's metric): the
// same two kernels with ``val`` not null also write the minimum each keeps in
// registers, int64 [n_strips, C], beside its glyph. The unsharded launch
// passes null and writes nothing more than before.
//
// K6, the first-minimum combine over glyph shards (decode.py:74-79, the
// offset to the bank's glyph numbers, two all_gathers, an argmin over shards
// and a take_along_axis): from every shard's partial (val, id), the ids
// local to the shard's slice, the id of the smallest val, plus the number of
// the slice's first glyph, the lowest shard on ties; with the shards in
// ascending glyph ranges that is the global first minimum, and a padded copy
// of glyph 0 (a later shard, glyph 0's value) never wins. It moves 12 bytes a
// shard and 4 bytes out for each cell and does no arithmetic to speak of:
// bound by bytes, and at a page's 3978 cells by its launch. One thread an
// output, n_g strided loads, each coalesced across the warp.
//
// The int64 instance (the port's first K4): one block per strip, one warp
// per cell, lanes over the glyphs, every lane reading the same window byte
// (a broadcast) and its own glyph's template byte, a (metric, g) shuffle
// reduction, a block-wide OR for the white flag.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MS = 16;       // strips a block of the mma instance: one M-tile
constexpr int NWARPS = 16;   // warps of an mma block
constexpr int KH = 5;        // k-steps of A fragments held in registers
constexpr int SU = 4;        // staging loads a thread keeps in flight
constexpr int WARPS64 = 8;   // warps of an int64 block
constexpr int COMBINE_THREADS = 256;  // threads of a K6 block
constexpr size_t SMEM_MAX = 232448 - 1024;  // shared memory a block may use on the H100

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint4& a, uint2 b)
{
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// 4 window bytes from the staged rows: byte offset p of the row, shifted by sh
__device__ __forceinline__ uint32_t window_word(const unsigned char* p, int sh)
{
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
    return __funnelshift_r(w[0], w[1], sh);
}

__device__ __forceinline__ void keep_min(long long& best, int& bg, long long m, int g)
{
    if (m < best) {  // glyphs ascend within a lane: strict < keeps the first
        best = m;
        bg = g;
    }
}

__device__ __forceinline__ void quad_min(long long& best, int& bg)
{
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
        const long long om = __shfl_xor_sync(0xffffffffu, best, d);
        const int og = __shfl_xor_sync(0xffffffffu, bg, d);
        if (om < best || (om == best && og < bg)) {
            best = om;
            bg = og;
        }
    }
}

__global__ void __launch_bounds__(NWARPS * 32)
focr_ssd_argmin_mma(const uint8_t* __restrict__ strips, long long n_strips, int h, int crop_w,
               const uint2* __restrict__ bfrag, const int64_t* __restrict__ tsq,
               const int32_t* __restrict__ wx0, int C, int G, int win_w, int nks, int pitch,
               int32_t* __restrict__ ids, bool* __restrict__ white,
               long long* __restrict__ val)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned int s_ink;  // bit m: strip m of the block has a byte != 255
    __shared__ int s_xa, s_xe;      // the columns the block stages: [s_xa, s_xe)
    int* koff_s = reinterpret_cast<int*>(smem);  // [nks * 8] k-word offsets
    unsigned char* st = smem + nks * 8 * 4;      // [MS * h rows][pitch], inverted
    const int tid = threadIdx.x;
    const int nthreads = NWARPS * 32;
    const long long m0 = static_cast<long long>(blockIdx.x) * MS;
    const int ms = static_cast<int>(min(static_cast<long long>(MS), n_strips - m0));
    const int nw4 = (win_w + 3) >> 2;

    if (tid == 0) s_ink = 0;
    if (tid < 32) {
        // the columns the block's cells read, from the first 16-byte piece;
        // the blocks of grid.y 0 stage whole rows, since the white flag looks
        // at every byte of a strip
        const int c = blockIdx.y * NWARPS + tid;
        const bool mine = tid < NWARPS && c < C;
        const int x = mine ? min(max(static_cast<int>(wx0[c]), 0), crop_w) : 0;
        const int lo = __reduce_min_sync(0xffffffffu, mine ? x : INT_MAX);
        const int hi = __reduce_max_sync(0xffffffffu, x);
        if (tid == 0) {
            s_xa = blockIdx.y ? lo & ~15 : 0;
            s_xe = blockIdx.y ? min(crop_w, (hi & ~3) + 4 * nw4 + 4) : crop_w;
        }
    }
    for (int w = tid; w < nks * 8; w += nthreads) {
        const int dy = w / nw4;
        koff_s[w] = dy < h ? dy * pitch + 4 * (w - dy * nw4) : 0;
    }
    // zero each row past crop_w (read by windows that hang past the edge)
    for (int i = tid; i < MS * h * (pitch - crop_w); i += nthreads) {
        const int r = i / (pitch - crop_w);
        st[r * pitch + crop_w + (i - r * (pitch - crop_w))] = 0;
    }
    __syncthreads();
    // stage columns [xa, xe) of the block's ms * h strip rows, inverted, in
    // 16-byte pieces: an aligned piece inside the row is one 16-byte load
    // (SU in flight a thread), any other piece is read a byte at a time up
    // to crop_w
    const int xa = s_xa, nv = (s_xe - xa + 15) >> 4;
    const uint8_t* src = strips + m0 * h * crop_w;
    const int items = ms * h * nv;
    unsigned int ink = 0;
    for (int k0 = tid; k0 < items; k0 += SU * nthreads) {
        uint4 v[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
            const int k = k0 + u * nthreads;
            const int r = k / nv, x = xa + 16 * (k - r * nv);
            const uint8_t* p = src + r * crop_w + x;
            const bool whole = k < items && x + 16 <= crop_w
                               && !(reinterpret_cast<uintptr_t>(p) & 15);
            v[u] = whole ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
            const int k = k0 + u * nthreads;
            if (k >= items) break;
            const int r = k / nv, x = xa + 16 * (k - r * nv);
            const uint8_t* p = src + r * crop_w + x;
            unsigned char* d = st + r * pitch + x;
            if (x + 16 <= crop_w && !(reinterpret_cast<uintptr_t>(p) & 15)) {
                uint32_t* dw = reinterpret_cast<uint32_t*>(d);  // x: a multiple of 16
                dw[0] = ~v[u].x;
                dw[1] = ~v[u].y;
                dw[2] = ~v[u].z;
                dw[3] = ~v[u].w;
                if ((v[u].x & v[u].y & v[u].z & v[u].w) != 0xffffffffu) ink |= 1u << (r / h);
            } else {
                for (int j = 0; j < 16 && x + j < crop_w; ++j) {
                    const uint32_t b = p[j];
                    d[j] = static_cast<unsigned char>(255u - b);
                    if (b != 255u) ink |= 1u << (r / h);
                }
            }
        }
    }
    ink = __reduce_or_sync(0xffffffffu, ink);
    if ((tid & 31) == 0 && ink) atomicOr(&s_ink, ink);
    __syncthreads();
    if (blockIdx.y == 0 && tid < ms) white[m0 + tid] = !((s_ink >> tid) & 1u);

    const int lane = tid & 31;
    const int gq = lane >> 2;  // the fragments' groupID: strips gq, gq + 8
    const int tq = lane & 3;   // and thread-in-group
    const int NT = (G + 7) >> 3;
    for (int c = blockIdx.y * NWARPS + (tid >> 5); c < C; c += NWARPS * gridDim.y) {
        const int x0 = min(max(static_cast<int>(wx0[c]), 0), crop_w);  // past crop_w: zeros
        const int sh = (x0 & 3) * 8;
        const unsigned char* rlo = st + gq * h * pitch + (x0 & ~3);
        const unsigned char* rhi = rlo + 8 * h * pitch;
        const uint2* bc = bfrag + static_cast<size_t>(c) * NT * nks * 32 + lane;
        const int64_t* tc = tsq + static_cast<long long>(c) * G;
        long long best_lo = LLONG_MAX, best_hi = LLONG_MAX;
        int g_lo = G, g_hi = G;
        uint4 af[KH];
        for (int nt = 0; nt < NT; ++nt) {
            int acc[4] = {0, 0, 0, 0};
            for (int k0 = 0; k0 < nks; k0 += KH) {
                if (nt == 0 || nks > KH) {
#pragma unroll
                    for (int s = 0; s < KH; ++s) {
                        if (k0 + s >= nks) break;
                        const int o0 = koff_s[8 * (k0 + s) + tq];
                        const int o1 = koff_s[8 * (k0 + s) + tq + 4];
                        af[s] = make_uint4(window_word(rlo + o0, sh), window_word(rhi + o0, sh),
                                           window_word(rlo + o1, sh), window_word(rhi + o1, sh));
                    }
                }
#pragma unroll
                for (int s = 0; s < KH; ++s) {
                    if (k0 + s >= nks) break;
                    mma_u8(acc, af[s], __ldg(bc + (static_cast<size_t>(nt) * nks + k0 + s) * 32));
                }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int g = 8 * nt + 2 * tq + e;
                if (g < G) {
                    const long long t = tc[g];
                    keep_min(best_lo, g_lo, t - 2 * static_cast<long long>(acc[e]), g);
                    keep_min(best_hi, g_hi, t - 2 * static_cast<long long>(acc[2 + e]), g);
                }
            }
        }
        quad_min(best_lo, g_lo);
        quad_min(best_hi, g_hi);
        if (tq == 0) {
            if (gq < ms) ids[(m0 + gq) * C + c] = g_lo;
            if (gq + 8 < ms) ids[(m0 + gq + 8) * C + c] = g_hi;
            if (val) {  // K4p: the minimum itself, for the combine over glyph shards
                if (gq < ms) val[(m0 + gq) * C + c] = best_lo;
                if (gq + 8 < ms) val[(m0 + gq + 8) * C + c] = best_hi;
            }
        }
    }
}

__global__ void __launch_bounds__(WARPS64 * 32)
focr_ssd_argmin_int64(const uint8_t* __restrict__ strips, int h, int crop_w,
                 const uint8_t* __restrict__ tmpl, const int64_t* __restrict__ tsq,
                 const int32_t* __restrict__ wx0, int C, int G, int win_w,
                 int32_t* __restrict__ ids, bool* __restrict__ white,
                 long long* __restrict__ val)
{
    const long long strip = blockIdx.x;
    const uint8_t* s = strips + strip * h * crop_w;

    int ink = 0;
    for (int i = threadIdx.x; i < h * crop_w; i += blockDim.x) ink |= s[i] != 255;
    ink = __syncthreads_or(ink);
    if (threadIdx.x == 0) white[strip] = !ink;

    const int lane = threadIdx.x & 31;
    const int n = h * win_w;
    for (int c = threadIdx.x >> 5; c < C; c += WARPS64) {
        const int x0 = wx0[c];
        // window columns that lie inside the strip; the rest count as 0
        const int xlo = x0 < 0 ? -x0 : 0;
        const int xhi = min(win_w, crop_w - x0);
        const uint8_t* tc = tmpl + static_cast<long long>(c) * G * n;
        long long best_m = LLONG_MAX;
        int best_g = G;
        for (int g = lane; g < G; g += 32) {
            const uint8_t* t = tc + static_cast<long long>(g) * n;
            long long acc = 0;
            for (int y = 0; y < h; ++y) {
                const uint8_t* srow = s + y * crop_w + x0;
                const uint8_t* trow = t + y * win_w;
                for (int x = xlo; x < xhi; ++x)
                    acc += static_cast<long long>(255 - srow[x]) * trow[x];
            }
            keep_min(best_m, best_g, tsq[static_cast<long long>(c) * G + g] - 2 * acc, g);
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
        if (lane == 0) {
            ids[strip * C + c] = best_g;
            if (val) val[strip * C + c] = best_m;
        }
    }
}

// K6: one thread an output; shards ascend and a strict < keeps the first, so
// the lowest shard wins a tie. Shard s holds glyphs s * shard_glyphs and up:
// its slice-local id becomes the bank's here.
__global__ void __launch_bounds__(COMBINE_THREADS)
focr_ssd_combine_kernel(const long long* __restrict__ vals, const int32_t* __restrict__ ids,
                        int n_g, long long n, int shard_glyphs, int32_t* __restrict__ out)
{
    const long long i = static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
    if (i >= n) return;
    long long best = vals[i];
    int bg = ids[i];
    for (int s = 1; s < n_g; ++s) {
        const long long v = vals[s * n + i];
        if (v < best) {
            best = v;
            bg = ids[s * n + i] + s * shard_glyphs;
        }
    }
    out[i] = bg;
}

}  // namespace

// strips u8 [n_strips, h, crop_w] (not inverted), tmpl u8 [C, G, h, win_w],
// bfrag: tmpl packed by ops/ssd_kernels.py::pack_template_fragments, uint2
// [C, ceil(G/8), nks, 32] with nks = ceil(h * ceil(win_w/4) / 8) (read by the
// mma instance only), tsq int64 [C, G], wx0 int32 [C] (>= 0) -> ids int32
// [n_strips, C], white bool [n_strips]; with ``val`` not null (K4p) also val
// int64 [n_strips, C], the metric tsq - 2 * corr at that id. Returns
// cudaGetLastError().
extern "C" int focr_ssd_argmin(const void* strips, long long n_strips, int h, int crop_w,
                               const void* tmpl, const void* bfrag, const void* tsq,
                               const void* wx0, int C, int G, int win_w, void* ids, void* white,
                               void* val, void* stream)
{
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nw4 = (win_w + 3) / 4;
    const int nks = (h * nw4 + 7) / 8;
    const int pitch = (crop_w + 4 * nw4 + 4 + 3) & ~3;  // covers x0 + 4q + 7 for x0 <= crop_w
    const size_t smem = static_cast<size_t>(nks) * 8 * 4 + static_cast<size_t>(MS) * h * pitch;
    if (static_cast<long long>(h) * win_w * 65025LL < (1LL << 31) && smem <= SMEM_MAX) {
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                focr_ssd_argmin_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        // blocks: an M-tile of strips x NWARPS cells (a cell a warp)
        const dim3 grid(static_cast<unsigned>((n_strips + MS - 1) / MS), (C + NWARPS - 1) / NWARPS);
        focr_ssd_argmin_mma<<<grid, NWARPS * 32, smem, st>>>(
            static_cast<const uint8_t*>(strips), n_strips, h, crop_w,
            static_cast<const uint2*>(bfrag), static_cast<const int64_t*>(tsq),
            static_cast<const int32_t*>(wx0), C, G, win_w, nks, pitch,
            static_cast<int32_t*>(ids), static_cast<bool*>(white), static_cast<long long*>(val));
    } else {
        focr_ssd_argmin_int64<<<static_cast<unsigned>(n_strips), WARPS64 * 32, 0, st>>>(
            static_cast<const uint8_t*>(strips), h, crop_w, static_cast<const uint8_t*>(tmpl),
            static_cast<const int64_t*>(tsq), static_cast<const int32_t*>(wx0), C, G, win_w,
            static_cast<int32_t*>(ids), static_cast<bool*>(white), static_cast<long long*>(val));
    }
    return static_cast<int>(cudaGetLastError());
}

// K6: vals int64 [n_g, n] and ids int32 [n_g, n] (shard s's partial minimum
// and its glyph, local to the shard's slice of shard_glyphs glyphs) -> out
// int32 [n]: the id, plus s * shard_glyphs, of the smallest val, the lowest
// shard on ties. Returns cudaGetLastError().
extern "C" int focr_ssd_combine(const void* vals, const void* ids, int n_g, long long n,
                                int shard_glyphs, void* out, void* stream)
{
    const unsigned blocks = static_cast<unsigned>((n + COMBINE_THREADS - 1) / COMBINE_THREADS);
    focr_ssd_combine_kernel<<<blocks, COMBINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(vals), static_cast<const int32_t*>(ids), n_g, n,
        shard_glyphs, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
