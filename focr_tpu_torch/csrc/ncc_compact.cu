// K2: candidate compaction, for NVIDIA Hopper (sm_90a): a count kernel and an
// emit kernel.
//
// Replaces the device half of focr_tpu/ops/pallas_ncc.py::_compact_hits
// (:436-628, XLA): the set bits of the sweep's mask plane, as needle-local
// positions y·W1 + x, in (page, needle, y, x) scan order — the reference's
// emit order (ncc.cpp:98-100, needles iterated offsets-outer) — with each
// page's offset into them, the candidates of every (page, needle) and of
// every page.
//
// The TPU needed a hierarchical rank (block totals, scatter-max, quadded
// row gathers, triangular-matmul prefix sums) because it has no hardware
// gather or scatter, and a fixed candidate cap with an overflow redo. Here the
// output is sized by the exact count, in two launches with one host wait
// between them (the caller's, to size the output):
//
//   count — the exclusive prefix of the sweep's row counts over every mask
//           row, pages included (each row's offset in the output), in one
//           pass: a single-pass scan with decoupled look-back (Merrill and
//           Garland). Blocks take chunks of CHUNK rows in the order they
//           start (a ticket), so the chunks before a block's are already
//           running; a block publishes its chunk's total, then adds up its
//           predecessors' published totals back to the first one that
//           already holds its full prefix, one warp reading 32 of them at a
//           time, and publishes its own. The last
//           block to finish reads the offsets at the (page, needle) starts
//           and writes off, hcnt and nz from their differences into the
//           small buffer the host fetches.
//   emit  — a warp per 32 mask rows: one coalesced load of their counts and
//           a ballot skip the rows without candidates; for each other row,
//           the lanes read 32 words at a time, a warp scan of their popcounts
//           places each word's bits, and each lane writes its word's set bits
//           in ascending x.
//
// What bounds it on the H100: bytes. count reads the row counts once and
// writes an int64 offset per row (a canonical 8-page wave's larger group:
// 8 × 222 × 614 rows, 4.4 MB read, 8.7 MB written, ~4 µs at 3.35 TB/s);
// emit reads the row counts again and only the mask rows that hold
// candidates. The TPU-era cost was the wrapper's two torch.cumsum, a
// subtraction and two sums around a kernel that gave every mask row a warp
// (136 K blocks a group, most of which found a zero count and left).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CT = 1024;           // threads of a count block
constexpr int CPT = 8;             // rows a count thread holds
constexpr int CHUNK = CT * CPT;    // rows a count block scans
constexpr int EWARPS = 8;          // warps of an emit block
constexpr unsigned long long AGG = 1ull << 62;   // look-back word: chunk total
constexpr unsigned long long INCL = 2ull << 62;  // look-back word: prefix incl. chunk
constexpr unsigned long long VAL = (1ull << 62) - 1;

__device__ __forceinline__ long long warp_sum(long long v)
{
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    return v;
}

__device__ __forceinline__ long long warp_incl_scan(long long v, int lane)
{
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const long long u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
    }
    return v;
}

// look[k]: 0 until chunk k publishes; then AGG | its total, then INCL | the
// sum of every row count up to the end of chunk k. tickets[0] hands out the
// chunks, tickets[1] counts finished blocks. Both zeroed by the caller.
__global__ void __launch_bounds__(CT)
focr_ncc_count_kernel(const int32_t* __restrict__ rcnt, long long rows, int segs, int Hs, int T,
                 int B, int64_t* __restrict__ row_off, int64_t* __restrict__ off,
                 int32_t* __restrict__ hcnt, int32_t* __restrict__ nz,
                 unsigned long long* __restrict__ look, unsigned int* __restrict__ tickets)
{
    __shared__ unsigned int s_id;
    __shared__ bool s_last;
    __shared__ long long s_tot[CT / 32];
    __shared__ long long s_base[CT / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_id = atomicAdd(&tickets[0], 1u);
    __syncthreads();
    const long long id = s_id;

    // each warp: 32 consecutive rows a step, CPT steps (coalesced loads)
    const long long r0 = id * CHUNK + static_cast<long long>(warp) * (32 * CPT) + lane;
    int v[CPT];
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const long long r = r0 + 32 * i;
        v[i] = r < rows ? rcnt[r] : 0;
        sum += v[i];
    }
    sum = warp_sum(sum);
    if (lane == 0) s_tot[warp] = sum;
    __syncthreads();
    if (warp == 0) {
        const long long t = s_tot[lane];
        const long long incl = warp_incl_scan(t, lane);
        const long long agg = __shfl_sync(0xffffffffu, incl, 31);
        if (lane == 0)
            atomicExch(&look[id], (id ? AGG : INCL) | static_cast<unsigned long long>(agg));
        // the look-back, 32 predecessors at a time: lane l reads chunk j - l
        // (before chunk 0: an inclusive 0); the nearest chunk that holds its
        // full prefix ends the walk, and the values from there on are summed
        long long prefix = 0;
        for (long long j = id - 1; id;) {
            const long long k = j - lane;
            unsigned long long w = INCL;
            if (k >= 0)
                do {
                    w = *reinterpret_cast<volatile unsigned long long*>(&look[k]);
                } while (!(w >> 62));
            const unsigned full = __ballot_sync(0xffffffffu, (w >> 62) == (INCL >> 62));
            const int stop = full ? __ffs(full) - 1 : 32;
            prefix += warp_sum(lane <= stop ? static_cast<long long>(w & VAL) : 0);
            if (full) break;
            j -= 32;
        }
        if (lane == 0 && id)
            atomicExch(&look[id], INCL | static_cast<unsigned long long>(prefix + agg));
        s_base[lane] = prefix + incl - t;
    }
    __syncthreads();

    long long base = s_base[warp];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const long long x = warp_incl_scan(v[i], lane);
        const long long r = r0 + 32 * i;
        if (r < rows) row_off[r] = base + x - v[i];
        base += __shfl_sync(0xffffffffu, x, 31);
    }

    // the last block to finish: off, hcnt, nz from the offsets at the starts
    // of the (page, needle) segments of Hs rows
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&tickets[1], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // every block's offsets, read past L1
    const long long* done = reinterpret_cast<const long long*>(row_off);
    const long long total = static_cast<long long>(
        *reinterpret_cast<volatile unsigned long long*>(&look[gridDim.x - 1]) & VAL);
    for (int s = tid; s < segs; s += CT) {
        const long long a = __ldcg(&done[static_cast<long long>(s) * Hs]);
        const long long b = s + 1 < segs ? __ldcg(&done[static_cast<long long>(s + 1) * Hs])
                                         : total;
        hcnt[s] = static_cast<int32_t>(b - a);
    }
    for (int b = tid; b <= B; b += CT) {
        const long long o = b < B ? __ldcg(&done[static_cast<long long>(b) * T * Hs]) : total;
        off[b] = o;
        if (b < B) {
            const long long e = b + 1 < B
                ? __ldcg(&done[static_cast<long long>(b + 1) * T * Hs]) : total;
            nz[b] = static_cast<int32_t>(e - o);
        }
    }
}

__global__ void __launch_bounds__(EWARPS * 32)
focr_ncc_emit_kernel(const int32_t* __restrict__ mask, const int32_t* __restrict__ rcnt,
                const int64_t* __restrict__ row_off, int32_t* __restrict__ pos,
                long long rows, int Hs, int NW)
{
    const int lane = threadIdx.x & 31;
    const long long r0 = (static_cast<long long>(blockIdx.x) * EWARPS + (threadIdx.x >> 5)) * 32;
    if (r0 >= rows) return;  // whole warp
    const long long mine = r0 + lane;
    unsigned live = __ballot_sync(0xffffffffu, mine < rows && rcnt[mine] != 0);
    const int W1 = NW * 32;
    while (live) {  // uniform across the warp
        const long long row = r0 + __ffs(live) - 1;
        live &= live - 1;
        const int y = static_cast<int>(row % Hs);
        const int32_t* words = mask + row * NW;
        int32_t* out = pos + row_off[row];
        int base = 0;
        for (int g0 = 0; g0 < NW; g0 += 32) {
            const int g = g0 + lane;
            uint32_t w = g < NW ? static_cast<uint32_t>(words[g]) : 0u;
            const int c = __popc(w);
            int incl = c;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int u = __shfl_up_sync(0xffffffffu, incl, d);
                if (lane >= d) incl += u;
            }
            int o = base + incl - c;
            while (w) {
                const int bit = __ffs(w) - 1;
                out[o++] = y * W1 + g * 32 + bit;
                w &= w - 1;
            }
            base += __shfl_sync(0xffffffffu, incl, 31);
        }
    }
}

}  // namespace

// rcnt int32 [B, T, Hs] -> row_off int64 [B·T·Hs] (the exclusive prefix over
// every row, pages included), off int64 [B+1], hcnt int32 [B, T], nz int32
// [B]. look uint64 [ceil(rows / CHUNK)] and tickets uint32 [2] must be zero.
// Returns cudaGetLastError().
extern "C" int focr_ncc_compact_count(const void* rcnt, int B, int T, int Hs, void* row_off,
                                      void* off, void* hcnt, void* nz, void* look,
                                      void* tickets, void* stream)
{
    const long long rows = static_cast<long long>(B) * T * Hs;
    const long long blocks = (rows + CHUNK - 1) / CHUNK;
    focr_ncc_count_kernel<<<static_cast<unsigned>(blocks), CT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rcnt), rows, B * T, Hs, T, B,
        static_cast<int64_t*>(row_off), static_cast<int64_t*>(off),
        static_cast<int32_t*>(hcnt), static_cast<int32_t*>(nz),
        static_cast<unsigned long long*>(look), static_cast<unsigned int*>(tickets));
    return static_cast<int>(cudaGetLastError());
}

// mask int32 [rows, NW], rcnt int32 [rows], row_off int64 [rows] (from
// focr_ncc_compact_count); pos int32 sized by the total. Row index =
// (page·T + needle)·Hs + y. Returns cudaGetLastError().
extern "C" int focr_ncc_compact(const void* mask, const void* rcnt, const void* row_off,
                                void* pos, long long rows, int Hs, int NW, void* stream)
{
    const long long blocks = (rows + 32 * EWARPS - 1) / (32 * EWARPS);
    focr_ncc_emit_kernel<<<static_cast<unsigned>(blocks), EWARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(mask), static_cast<const int32_t*>(rcnt),
        static_cast<const int64_t*>(row_off), static_cast<int32_t*>(pos), rows, Hs, NW);
    return static_cast<int>(cudaGetLastError());
}
