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
// decode.py:71-74: the argmin and take_along_axis on a shard's metric, and
// the shard's glyph offset): the same two kernels with PARTIAL = true. The
// K4 instance (PARTIAL = false) is the code described above, unchanged; the
// mma instance's K4p block is k4p_block. A shard's launch is small (a slot's
// block of 8 pages at h = 12 is 25 M-tiles x 5 cell groups = 125 blocks,
// under one wave of 132 SMs), so its time is one block's chain of waits; the
// design cuts the links of that chain:
//
//   * One packed int64 key a cell,
//         key = ((metric + KEY_BIAS) << KEY_SHIFT) | gid,
//     gid = the bank's glyph number (slice-local + the shard's first glyph
//     g0). check_window bounds n <= 74565, so the metric lies in
//     (-2^34, 2^33) and the key in [0, 2^63); the host checks gid < 2^28
//     once a shard. The smallest key is the smallest metric and, among
//     equal ones, the lowest glyph: the lanes and the quad take plain 64-bit
//     minima, and K6 needs no other field (ops/ssd_kernels.py::pack_key
//     holds the same constants). The mma instance runs only where
//     2 * n * 65025 < 2^31 (16 strips of a wider window do not fit in shared
//     memory), so a lane keeps its (metric, glyph) minimum in 32 bits, with
//     a strict < over its ascending glyphs, and packs it once.
//   * Shared memory holds the block's column window, not whole rows: rows of
//     `pitch` = the widest window of any block (the host computes it from
//     wx0 and the cells a block, ops/ssd_kernels.py::partial_pitch), column
//     x staged at x - xa; ~28 KB a block at h = 12 (K4: ~121 KB).
//   * No barrier before the staging: every warp loads the block's window
//     starts itself (first), then issues the loads of its cell's first PT
//     steps (B fragments and tsq values; a step: an n-tile of up to KH
//     k-steps, so at 2 or 4 glyph shards of the canonical bank all of them)
//     and stages while they arrive; the zero fill past the staged columns
//     touches no staged byte, so it runs alongside.
//   * White flags only where they are read: the wrapper passes white = null
//     for every shard but the first. There, the y-blocks of an M-tile share
//     its strips (strip m to block m mod gridDim.y), each reading its
//     strips' whole rows, so no block reads five times the bytes of the
//     others (as K4's grid.y 0 does) and none waits on another.
//   * The cells (warps) a block takes are the launch's (the wrapper's
//     PARTIAL_WARPS, from a sweep), at most PMAXW.
//
// K6, the first-minimum combine over glyph shards (decode.py:75-79, two
// all_gathers, an argmin over shards and a take_along_axis): from every
// shard's keys, read where they sit through up to MAX_SHARDS pointers, the
// smallest key's glyph. The keys' order is the reference's rule (shards hold
// ascending glyph ranges, so the lowest shard wins a tie, and a padded copy
// of glyph 0 in a later shard never beats glyph 0). It moves 8 bytes a shard
// in and 4 bytes out for each cell and does no arithmetic to speak of:
// bound by bytes, and at a block's cells by its launch. One thread an
// output, the shards' loads in flight together, each coalesced. Over more
// than MAX_SHARDS shards a fold pass goes first: the same loads, a group of
// up to MAX_SHARDS consecutive shards a grid row, each group's smallest key
// written whole (int64, not unpacked), up to FOLD_PTRS pointers a launch;
// the host folds (ops/ssd_kernels.py::fold_plan) until at most MAX_SHARDS
// keys remain, then the pass above takes them. The smallest of the groups'
// smallest keys is the smallest key, so the fold keeps the tie-break.
//
// The int64 instance (the port's first K4): one block per strip, one warp
// per cell, lanes over the glyphs, every lane reading the same window byte
// (a broadcast) and its own glyph's template byte, a (metric, g) shuffle
// reduction (K4p: a minimum of keys), a block-wide OR for the white flag.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MS = 16;       // strips a block of the mma instance: one M-tile
constexpr int NWARPS = 16;   // warps of a K4 mma block
constexpr int PMAXW = 16;    // most warps of a K4p mma block
constexpr int KH = 5;        // k-steps of A fragments held in registers
constexpr int PT = 5;        // K4p: steps (n-tiles of up to KH k-steps) loaded at once
constexpr int SU = 4;        // staging loads a thread keeps in flight
constexpr int WARPS64 = 8;   // warps of an int64 block
constexpr int COMBINE_THREADS = 256;  // threads of a K6 block
constexpr int MAX_SHARDS = 8;         // key pointers K6 (its last pass) takes
constexpr int FOLD_PTRS = 64;         // key pointers a K6 fold launch takes: 8 groups of 8
constexpr int KEY_SHIFT = 28;         // key = ((metric + KEY_BIAS) << KEY_SHIFT) | gid
constexpr long long KEY_BIAS = 1LL << 34;
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

__device__ __forceinline__ long long pack_key(long long metric, int gid)
{
    return static_cast<long long>((static_cast<unsigned long long>(metric + KEY_BIAS) << KEY_SHIFT)
                                  | static_cast<unsigned long long>(gid));
}

__device__ __forceinline__ long long min64(long long a, long long b) { return b < a ? b : a; }

// K4p: a read-only load that stays where it is written (the compiler would
// sink a plain one to its first use, after the block's barrier)
__device__ __forceinline__ uint2 ld_early(const uint2* p)
{
    uint2 v;
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
    return v;
}

__device__ __forceinline__ long long ld_early(const long long* p)
{
    long long v;
    asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ int ld_early(const int* p)
{
    int v;
    asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// K4p: for steps j0 .. j0 + PT - 1 of one cell's walk (step j: n-tile
// j / nkc, k-steps from KH * (j % nkc)), the B fragments and the two tsq
// values of lane tq's glyphs, all loads issued together
__device__ __forceinline__ void load_steps(const uint2* bc, const int64_t* tc, int j0, int steps,
                                           int nkc, int nks, int G, int tq, uint2 (&b)[PT][KH],
                                           long long (&t)[PT][2])
{
#pragma unroll
    for (int i = 0; i < PT; ++i) {
        const int j = j0 + i;
        const int nt = j / nkc, k0 = (j - nt * nkc) * KH;
#pragma unroll
        for (int s = 0; s < KH; ++s)
            b[i][s] = j < steps && k0 + s < nks
                          ? ld_early(bc + (static_cast<size_t>(nt) * nks + k0 + s) * 32)
                          : make_uint2(0, 0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int g = 8 * nt + 2 * tq + e;
            t[i][e] = j < steps && g < G ? ld_early(reinterpret_cast<const long long*>(tc) + g) : 0;
        }
    }
}

// K4p, one block: strips m0 .. m0 + 15 against the cells blockIdx.y *
// nwarps .. + nwarps - 1 (a warp a cell), of one glyph shard
__device__ __forceinline__ void k4p_block(const uint8_t* __restrict__ strips, long long n_strips,
                                          int h, int crop_w, const uint2* __restrict__ bfrag,
                                          const int64_t* __restrict__ tsq,
                                          const int32_t* __restrict__ wx0, int C, int G,
                                          int win_w, int nks, int pitch,
                                          bool* __restrict__ white, long long* __restrict__ key,
                                          int g0)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned int s_ink[PMAXW];        // a warp's ink bits (bit m: strip m)
    int* koff_s = reinterpret_cast<int*>(smem);  // [nks * 8] k-word offsets
    unsigned char* st = smem + nks * 8 * 4;      // [MS * h rows][pitch], inverted
    const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads >> 5;
    const int warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2;  // the fragments' groupID: strips gq, gq + 8
    const int tq = lane & 3;   // and thread-in-group
    const long long m0 = static_cast<long long>(blockIdx.x) * MS;
    const int ms = static_cast<int>(min(static_cast<long long>(MS), n_strips - m0));
    const int nw4 = (win_w + 3) >> 2;
    const int NT = (G + 7) >> 3;
    const int nkc = (nks + KH - 1) / KH;  // chunks of KH k-steps an n-tile
    const int steps = NT * nkc;
    const int c = blockIdx.y * nwarps + warp;  // this warp's cell

    // first the block's cells' window starts (lane l: cell blockIdx.y *
    // nwarps + l), then every load of this warp's cell's first PT steps: all
    // in flight while the block stages its strips
    const int cl = blockIdx.y * nwarps + lane;
    const bool mine = lane < nwarps && cl < C;
    const int xl = mine ? min(max(ld_early(wx0 + cl), 0), crop_w) : 0;
    const int cc = min(c, C - 1);  // a warp past the last cell loads the last one's, unused
    const uint2* bc = bfrag + static_cast<size_t>(cc) * NT * nks * 32 + lane;
    const int64_t* tc = tsq + static_cast<long long>(cc) * G;
    uint2 bq[PT][KH];
    long long tqv[PT][2];
    load_steps(bc, tc, 0, steps, nkc, nks, G, tq, bq, tqv);

    // the columns the block stages, [xa, xe): from its first cell's 16-byte
    // piece to 4 bytes past its last cell's window words (every warp
    // computes them: no barrier)
    const int xa = __reduce_min_sync(0xffffffffu, mine ? xl : INT_MAX) & ~15;
    const int xe = min(crop_w, (__reduce_max_sync(0xffffffffu, xl) & ~3) + 4 * nw4 + 4);
    const int x0 = __shfl_sync(0xffffffffu, xl, warp);  // this warp's cell's start
    for (int w = tid; w < nks * 8; w += nthreads) {
        const int dy = w / nw4;
        koff_s[w] = dy < h ? dy * pitch + 4 * (w - dy * nw4) : 0;
    }
    // stage columns [xa, xs) of the block's ms * h strip rows, inverted, at
    // x - xa, in 16-byte pieces (SU loads in flight a thread; a piece that is
    // not a whole aligned one is read a byte at a time), every byte below
    // crop_w; the rest of each row, from min(xs, crop_w), is zero (windows
    // that hang past crop_w read it). The two touch no byte in common, so
    // no barrier parts them.
    const int nv = (xe - xa + 15) >> 4;
    const int zs = min(xa + 16 * nv, crop_w) - xa;
    for (int i = tid; i < MS * h * (pitch - zs); i += nthreads) {
        const int r = i / (pitch - zs);
        st[r * pitch + zs + (i - r * (pitch - zs))] = 0;
    }
    const uint8_t* src = strips + m0 * h * crop_w;
    const int items = ms * h * nv;
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
            unsigned char* d = st + r * pitch + x - xa;
            if (x + 16 <= crop_w && !(reinterpret_cast<uintptr_t>(p) & 15)) {
                uint32_t* dw = reinterpret_cast<uint32_t*>(d);  // x - xa: a multiple of 16
                dw[0] = ~v[u].x;
                dw[1] = ~v[u].y;
                dw[2] = ~v[u].z;
                dw[3] = ~v[u].w;
            } else {
                for (int j = 0; j < 16 && x + j < crop_w; ++j)
                    d[j] = static_cast<unsigned char>(255u - p[j]);
            }
        }
    }
    // white flags, where asked for: the y-blocks of an M-tile share its
    // strips (strip m to block m mod gridDim.y), each reading its strips'
    // whole rows for ink, so no block waits on another
    const int gy = gridDim.y, my = blockIdx.y;
    const int nr = (crop_w + 15) >> 4;  // pieces a row
    const int wn = white && my < ms ? (ms - my + gy - 1) / gy : 0;  // this block's strips
    unsigned int ink = 0;
    for (int k0 = tid; k0 < wn * h * nr; k0 += SU * nthreads) {
        uint4 v[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
            const int k = k0 + u * nthreads;
            const int i = k / (h * nr), j = k - i * (h * nr);  // strip my + i * gy, row piece j
            const int x = 16 * (j % nr);
            const uint8_t* p = src + ((my + i * gy) * h + j / nr) * crop_w + x;
            const bool whole = k < wn * h * nr && x + 16 <= crop_w
                               && !(reinterpret_cast<uintptr_t>(p) & 15);
            v[u] = whole ? *reinterpret_cast<const uint4*>(p) : make_uint4(~0u, ~0u, ~0u, ~0u);
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
            const int k = k0 + u * nthreads;
            if (k >= wn * h * nr) break;
            const int i = k / (h * nr), j = k - i * (h * nr);
            const int m = my + i * gy, x = 16 * (j % nr);
            const uint8_t* p = src + (m * h + j / nr) * crop_w + x;
            bool inked = (v[u].x & v[u].y & v[u].z & v[u].w) != 0xffffffffu;
            if (!(x + 16 <= crop_w && !(reinterpret_cast<uintptr_t>(p) & 15)))
                for (int b = 0; b < 16 && x + b < crop_w; ++b) inked |= p[b] != 255u;
            if (inked) ink |= 1u << m;
        }
    }
    ink = __reduce_or_sync(0xffffffffu, ink);
    if (lane == 0) s_ink[warp] = ink;
    __syncthreads();
    for (int i = tid; i < wn; i += nthreads) {
        const int m = my + i * gy;
        unsigned int any = 0;
        for (int w = 0; w < nwarps; ++w) any |= s_ink[w];
        white[m0 + m] = !((any >> m) & 1u);
    }
    if (c >= C) return;  // a whole warp: no barrier follows

    const int sh = (x0 & 3) * 8;
    const unsigned char* rlo = st + gq * h * pitch + (x0 & ~3) - xa;
    const unsigned char* rhi = rlo + 8 * h * pitch;
    // each lane's first minimum over its glyphs (they ascend in a lane: a
    // strict < keeps the first) in 32 bits, packed into a key at the end: the
    // host takes this instance only where 2 * n * 65025 < 2^31 (16 strips of
    // a wider window would not fit in shared memory anyway)
    int m_lo = INT_MAX, m_hi = INT_MAX, g_lo = G, g_hi = G;
    uint4 af[KH];
    int acc[4] = {0, 0, 0, 0};
    for (int j0 = 0; j0 < steps; j0 += PT) {
        if (j0)  // the next PT steps' loads, in flight together
            load_steps(bc, tc, j0, steps, nkc, nks, G, tq, bq, tqv);
#pragma unroll
        for (int i = 0; i < PT; ++i) {
            const int j = j0 + i;
            if (j >= steps) break;
            const int nt = j / nkc, k0 = (j - nt * nkc) * KH;
            if (j == 0 || nkc > 1) {
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
                mma_u8(acc, af[s], bq[i][s]);
            }
            if (k0 + KH >= nks) {  // the n-tile's last chunk: its glyphs' metrics
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int g = 8 * nt + 2 * tq + e;
                    if (g >= G) continue;
                    const int t = static_cast<int>(tqv[i][e]);
                    const int lo = t - 2 * acc[e], hi = t - 2 * acc[2 + e];
                    if (lo < m_lo) {
                        m_lo = lo;
                        g_lo = g;
                    }
                    if (hi < m_hi) {
                        m_hi = hi;
                        g_hi = g;
                    }
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[q] = 0;
            }
        }
    }
    long long best_lo = g_lo < G ? pack_key(m_lo, g0 + g_lo) : LLONG_MAX;
    long long best_hi = g_hi < G ? pack_key(m_hi, g0 + g_hi) : LLONG_MAX;
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {  // the quad: keys are unique, a plain minimum
        best_lo = min64(best_lo, __shfl_xor_sync(0xffffffffu, best_lo, d));
        best_hi = min64(best_hi, __shfl_xor_sync(0xffffffffu, best_hi, d));
    }
    if (tq == 0) {
        if (gq < ms) key[(m0 + gq) * C + c] = best_lo;
        if (gq + 8 < ms) key[(m0 + gq + 8) * C + c] = best_hi;
    }
}

// K4 (PARTIAL = false: the kernel described at the top, unchanged) and K4p
// (PARTIAL = true: k4p_block)
template <bool PARTIAL>
__global__ void __launch_bounds__(NWARPS * 32)
focr_ssd_argmin_mma(const uint8_t* __restrict__ strips, long long n_strips, int h, int crop_w,
               const uint2* __restrict__ bfrag, const int64_t* __restrict__ tsq,
               const int32_t* __restrict__ wx0, int C, int G, int win_w, int nks, int pitch,
               int32_t* __restrict__ ids, bool* __restrict__ white,
               long long* __restrict__ key, int g0)
{
    if constexpr (PARTIAL) {
        k4p_block(strips, n_strips, h, crop_w, bfrag, tsq, wx0, C, G, win_w, nks, pitch, white,
                  key, g0);
    } else {
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
                            af[s] = make_uint4(
                                window_word(rlo + o0, sh), window_word(rhi + o0, sh),
                                window_word(rlo + o1, sh), window_word(rhi + o1, sh));
                        }
                    }
#pragma unroll
                    for (int s = 0; s < KH; ++s) {
                        if (k0 + s >= nks) break;
                        mma_u8(acc, af[s],
                               __ldg(bc + (static_cast<size_t>(nt) * nks + k0 + s) * 32));
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
            }
        }
    }
}

template <bool PARTIAL>
__global__ void __launch_bounds__(WARPS64 * 32)
focr_ssd_argmin_int64(const uint8_t* __restrict__ strips, int h, int crop_w,
                 const uint8_t* __restrict__ tmpl, const int64_t* __restrict__ tsq,
                 const int32_t* __restrict__ wx0, int C, int G, int win_w,
                 int32_t* __restrict__ ids, bool* __restrict__ white,
                 long long* __restrict__ key, int g0)
{
    const long long strip = blockIdx.x;
    const uint8_t* s = strips + strip * h * crop_w;

    if (!PARTIAL || white) {  // K4p: only the first shard gives white flags
        int ink = 0;
        for (int i = threadIdx.x; i < h * crop_w; i += blockDim.x) ink |= s[i] != 255;
        ink = __syncthreads_or(ink);
        if (threadIdx.x == 0) white[strip] = !ink;
    }

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
            const long long m = tsq[static_cast<long long>(c) * G + g] - 2 * acc;
            if constexpr (PARTIAL)
                best_m = min64(best_m, pack_key(m, g0 + g));
            else
                keep_min(best_m, best_g, m, g);
        }
        if constexpr (PARTIAL) {
#pragma unroll
            for (int d = 16; d; d >>= 1)
                best_m = min64(best_m, __shfl_xor_sync(0xffffffffu, best_m, d));
            if (lane == 0) key[strip * C + c] = best_m;
            continue;
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

// K6's arguments: one pointer a shard, by value
struct ShardKeys {
    const long long* key[MAX_SHARDS];
};

// K6: one thread an output; the smallest key is the first minimum over the
// shards, its low bits the bank's glyph
__global__ void __launch_bounds__(COMBINE_THREADS)
focr_ssd_combine_kernel(const ShardKeys keys, int n_g, long long n, int32_t* __restrict__ out)
{
    const long long i = static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
    if (i >= n) return;
    long long best = __ldg(keys.key[0] + i);
#pragma unroll
    for (int s = 1; s < MAX_SHARDS; ++s)
        if (s < n_g) best = min64(best, __ldg(keys.key[s] + i));
    out[i] = static_cast<int32_t>(best & ((1LL << KEY_SHIFT) - 1));
}

// K6's fold pass: up to FOLD_PTRS pointers, by value and read in place
struct FoldKeys {
    const long long* key[FOLD_PTRS];
};

// one thread an output of a group (blockIdx.y: keys y * MAX_SHARDS on, up to
// MAX_SHARDS of them) -> the group's smallest key, whole
__global__ void __launch_bounds__(COMBINE_THREADS)
focr_ssd_fold_kernel(const __grid_constant__ FoldKeys keys, int n_k, long long n,
                     long long* __restrict__ out)
{
    const long long i = static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
    if (i >= n) return;
    const int base = blockIdx.y * MAX_SHARDS;
    const int m = min(n_k - base, MAX_SHARDS);
    long long best = __ldg(keys.key[base] + i);
#pragma unroll
    for (int s = 1; s < MAX_SHARDS; ++s)
        if (s < m) best = min64(best, __ldg(keys.key[base + s] + i));
    out[static_cast<long long>(blockIdx.y) * n + i] = best;
}

}  // namespace

// strips u8 [n_strips, h, crop_w] (not inverted), tmpl u8 [C, G, h, win_w],
// bfrag: tmpl packed by ops/ssd_kernels.py::pack_template_fragments, uint2
// [C, ceil(G/8), nks, 32] with nks = ceil(h * ceil(win_w/4) / 8) (read by the
// mma instance only), tsq int64 [C, G], wx0 int32 [C] (>= 0) -> ids int32
// [n_strips, C], white bool [n_strips]. Returns cudaGetLastError().
extern "C" int focr_ssd_argmin(const void* strips, long long n_strips, int h, int crop_w,
                               const void* tmpl, const void* bfrag, const void* tsq,
                               const void* wx0, int C, int G, int win_w, void* ids, void* white,
                               void* stream)
{
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nw4 = (win_w + 3) / 4;
    const int nks = (h * nw4 + 7) / 8;
    const int pitch = (crop_w + 4 * nw4 + 4 + 3) & ~3;  // covers x0 + 4q + 7 for x0 <= crop_w
    const size_t smem = static_cast<size_t>(nks) * 8 * 4 + static_cast<size_t>(MS) * h * pitch;
    if (static_cast<long long>(h) * win_w * 65025LL < (1LL << 31) && smem <= SMEM_MAX) {
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                focr_ssd_argmin_mma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        // blocks: an M-tile of strips x NWARPS cells (a cell a warp)
        const dim3 grid(static_cast<unsigned>((n_strips + MS - 1) / MS), (C + NWARPS - 1) / NWARPS);
        focr_ssd_argmin_mma<false><<<grid, NWARPS * 32, smem, st>>>(
            static_cast<const uint8_t*>(strips), n_strips, h, crop_w,
            static_cast<const uint2*>(bfrag), static_cast<const int64_t*>(tsq),
            static_cast<const int32_t*>(wx0), C, G, win_w, nks, pitch,
            static_cast<int32_t*>(ids), static_cast<bool*>(white), nullptr, 0);
    } else {
        focr_ssd_argmin_int64<false><<<static_cast<unsigned>(n_strips), WARPS64 * 32, 0, st>>>(
            static_cast<const uint8_t*>(strips), h, crop_w, static_cast<const uint8_t*>(tmpl),
            static_cast<const int64_t*>(tsq), static_cast<const int32_t*>(wx0), C, G, win_w,
            static_cast<int32_t*>(ids), static_cast<bool*>(white), nullptr, 0);
    }
    return static_cast<int>(cudaGetLastError());
}

// A glyph shard's bank as K4p takes it, checked once by the wrapper
// (ops/ssd_kernels.py::shard_bank; its _ShardArgs mirrors this struct):
// tmpl u8 [C, G, h, win_w], bfrag (the mma instance's, else null), tsq int64
// [C, G], wx0 int32 [C] (>= 0); g0 = the bank's number of the shard's first
// glyph.
struct FocrSsdShard {
    const void* tmpl;
    const void* bfrag;
    const void* tsq;
    const void* wx0;
    int h, crop_w, C, G, win_w, g0;
};

// K4p: strips u8 [n_strips, h, crop_w] -> key int64 [n_strips, C] (the
// packed key of each cell's first minimum over the shard's glyphs) and, when
// white is not null, white bool [n_strips]. pitch: the staged row pitch
// (ops/ssd_kernels.py::partial_pitch for these warps), 0 for the int64
// instance; warps: the cells of an mma block, 1..PMAXW. Returns
// cudaGetLastError().
extern "C" int focr_ssd_partial(const void* strips, long long n_strips, const FocrSsdShard* sh,
                                int warps, int pitch, void* key, void* white, void* stream)
{
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nks = (sh->h * ((sh->win_w + 3) / 4) + 7) / 8;
    if (pitch > 0) {
        if (warps < 1 || warps > PMAXW) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = static_cast<size_t>(nks) * 8 * 4
                            + static_cast<size_t>(MS) * sh->h * pitch;
        if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                focr_ssd_argmin_mma<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        const dim3 grid(static_cast<unsigned>((n_strips + MS - 1) / MS),
                        (sh->C + warps - 1) / warps);
        focr_ssd_argmin_mma<true><<<grid, warps * 32, smem, st>>>(
            static_cast<const uint8_t*>(strips), n_strips, sh->h, sh->crop_w,
            static_cast<const uint2*>(sh->bfrag), static_cast<const int64_t*>(sh->tsq),
            static_cast<const int32_t*>(sh->wx0), sh->C, sh->G, sh->win_w, nks, pitch, nullptr,
            static_cast<bool*>(white), static_cast<long long*>(key), sh->g0);
    } else {
        focr_ssd_argmin_int64<true><<<static_cast<unsigned>(n_strips), WARPS64 * 32, 0, st>>>(
            static_cast<const uint8_t*>(strips), sh->h, sh->crop_w,
            static_cast<const uint8_t*>(sh->tmpl), static_cast<const int64_t*>(sh->tsq),
            static_cast<const int32_t*>(sh->wx0), sh->C, sh->G, sh->win_w, nullptr,
            static_cast<bool*>(white), static_cast<long long*>(key), sh->g0);
    }
    return static_cast<int>(cudaGetLastError());
}

// K6: keys[s] int64 [n] (shard s's K4p keys, on one card), 1 <= n_g <=
// MAX_SHARDS -> out int32 [n]: the glyph of the smallest key. Returns
// cudaGetLastError().
extern "C" int focr_ssd_combine(const void* const* keys, int n_g, long long n, void* out,
                                void* stream)
{
    if (n_g < 1 || n_g > MAX_SHARDS) return static_cast<int>(cudaErrorInvalidValue);
    ShardKeys k{};
    for (int s = 0; s < n_g; ++s) k.key[s] = static_cast<const long long*>(keys[s]);
    const unsigned blocks = static_cast<unsigned>((n + COMBINE_THREADS - 1) / COMBINE_THREADS);
    focr_ssd_combine_kernel<<<blocks, COMBINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        k, n_g, n, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

// K6's fold pass: keys[k] int64 [n] (shards' K4p keys or an earlier fold's
// rows, on one card), 1 <= n_k <= FOLD_PTRS -> out int64 [ceil(n_k /
// MAX_SHARDS), n]: row j the smallest of keys j * MAX_SHARDS .. j *
// MAX_SHARDS + MAX_SHARDS - 1. Returns cudaGetLastError().
extern "C" int focr_ssd_fold(const void* const* keys, int n_k, long long n, void* out,
                             void* stream)
{
    if (n_k < 1 || n_k > FOLD_PTRS) return static_cast<int>(cudaErrorInvalidValue);
    FoldKeys k{};
    for (int s = 0; s < n_k; ++s) k.key[s] = static_cast<const long long*>(keys[s]);
    const dim3 grid(static_cast<unsigned>((n + COMBINE_THREADS - 1) / COMBINE_THREADS),
                    (n_k + MAX_SHARDS - 1) / MAX_SHARDS);
    focr_ssd_fold_kernel<<<grid, COMBINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        k, n_k, n, static_cast<long long*>(out));
    return static_cast<int>(cudaGetLastError());
}
