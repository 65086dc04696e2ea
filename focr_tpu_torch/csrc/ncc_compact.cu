// K2: candidate compaction, for NVIDIA Hopper (sm_90a).
//
// Replaces the device half of focr_tpu/ops/pallas_ncc.py::_compact_hits
// (:436-628, XLA): the set bits of the sweep's mask plane, as needle-local
// positions y·W1 + x, in (page, needle, y, x) scan order — the reference's
// emit order (ncc.cpp:98-100, needles iterated offsets-outer).
//
// The TPU needed a hierarchical rank (block totals, scatter-max, quadded
// row gathers, triangular-matmul prefix sums) because it has no hardware
// gather or scatter, and a fixed candidate cap with an overflow redo. Here
// the wrapper takes an exclusive cumsum of the sweep's row counts (the
// global output offset of every mask row) and sizes the output by the exact
// total, and this kernel gives each mask row one warp: lanes read 32 words
// at a time, a warp scan of their popcounts places each word's bits, and
// each lane writes its word's set bits in ascending x.
//
// What bounds it on the H100: the mask plane's bytes — about 19 MB an
// uncropped canonical page (296 needles × 780 rows × 21 words × 4 B). Rows
// whose count is zero are skipped without reading their words, so dense
// text reads only the rows that hold candidates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NWARPS = 8;

__global__ void __launch_bounds__(NWARPS * 32)
ncc_compact_kernel(const int32_t* __restrict__ mask, const int32_t* __restrict__ rcnt,
                   const int64_t* __restrict__ row_off, int32_t* __restrict__ pos,
                   long long rows, int Hs, int NW)
{
    const long long row = static_cast<long long>(blockIdx.x) * NWARPS + (threadIdx.x >> 5);
    if (row >= rows) return;  // whole warp
    if (rcnt[row] == 0) return;  // whole warp
    const int lane = threadIdx.x & 31;
    const int y = static_cast<int>(row % Hs);
    const int W1 = NW * 32;
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
            const int v = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += v;
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

}  // namespace

// mask int32 [rows, NW], rcnt int32 [rows], row_off int64 [rows] (the
// exclusive prefix of rcnt over all rows, pages included); pos int32 sized
// by the total. Row index = (page·T + needle)·Hs + y. Returns
// cudaGetLastError().
extern "C" int focr_ncc_compact(const void* mask, const void* rcnt, const void* row_off,
                                void* pos, long long rows, int Hs, int NW, void* stream)
{
    const long long blocks = (rows + NWARPS - 1) / NWARPS;
    ncc_compact_kernel<<<static_cast<unsigned>(blocks), NWARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(mask), static_cast<const int32_t*>(rcnt),
        static_cast<const int64_t*>(row_off), static_cast<int32_t*>(pos), rows, Hs, NW);
    return static_cast<int>(cudaGetLastError());
}
