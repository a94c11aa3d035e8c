// K6: every pair of points within a radius, as CSR rows with distances.
//
// Replaces squidpy_tpu/ops/knn.py `radius_neighbors` (line 408): there XLA
// computes a (2048, n) float32 block of difference-form squared distances a
// row tile, each block is copied to the host, and a Python loop over its rows
// keeps the columns with d2 <= r2. That is O(n^2) work and n^2 * 4 bytes of
// device-to-host copies: about 4 TB at 1M cells.
//
// Bound on the card: bytes. The output is nnz * 8 bytes (an int32 column and
// a float32 distance an edge) plus the (n + 1) int64 row offsets, and the
// coordinates are read once. The tests are few: a point meets the points of
// the 3^min(d,3) grid cells around its own, about 56 at the main path's shape
// (1M cells, ~10 um apart, r = 25), each 3d float operations, so ~2e8
// operations in all, microseconds at the float32 rate.
//
// Design: the wrapper (squidpy_torch/ops/radius.py) bins the finite points
// into a uniform grid on their first min(d, 3) axes, whose side is a little
// above r (so every pair the float32 test accepts lies in adjacent cells),
// and sorts them by cell. Here one thread takes one sorted point, in two
// passes: the count pass writes each row's number of neighbours, the wrapper
// scans the counts into the row offsets, and the fill pass computes the same
// tests again and writes each accepted column and distance at its row's
// offset. The three cells of one grid row along x are consecutive in the
// sort, so a point reads 3^(G-1) contiguous ranges of candidates, and the
// threads of a warp, which hold points of one or two cells, read the same
// ranges: the candidates come from L1 as broadcasts. d2 is the difference
// form in axis order, each subtraction, multiply and add rounded on its own
// (`__fsub_rn`, `__fmul_rn`, `__fadd_rn`, which no contraction can fuse),
// the test is `d2 <= r2` with the same float32 r2, and a distance is
// `sqrtf(d2)`, correctly rounded (no fast math): every output is bitwise
// equal to the plain torch version. A row's columns come in the order its
// cells were visited; the wrapper sorts each row's columns ascending.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// kD = d for d <= 3, the point's coordinates held in registers; 0 for any d,
// read from memory on every test
template <int kD>
__device__ __forceinline__ float sq_dist(const float* __restrict__ pts, int d, const float (&p)[kD > 0 ? kD : 1],
                                         const float* __restrict__ own, int64_t s) {
    float d2 = 0.0f;
    if constexpr (kD > 0) {
        const float* q = pts + s * kD;
#pragma unroll
        for (int a = 0; a < kD; ++a) {
            const float diff = __fsub_rn(p[a], __ldg(q + a));
            const float sq = __fmul_rn(diff, diff);
            d2 = a == 0 ? sq : __fadd_rn(d2, sq);
        }
    } else {
        const float* q = pts + s * d;
        for (int a = 0; a < d; ++a) {
            const float diff = __fsub_rn(__ldg(own + a), __ldg(q + a));
            d2 = __fadd_rn(d2, __fmul_rn(diff, diff));  // 0 + sq == sq: the same sum as the plain version
        }
    }
    return d2;
}

// One thread a sorted point t: its row is orig[t], its cell (cells[3t],
// cells[3t + 1], cells[3t + 2]) in a grid of nx x ny x nz cells whose points
// are pts[cell_start[c] : cell_start[c + 1]] (cell c = (z * ny + y) * nx + x).
// kFill = false writes counts[row]; kFill = true writes the row's columns and
// distances from out_idx[indptr[row]] on.
template <int kD, bool kFill>
__global__ void __launch_bounds__(kThreads) radius_kernel(const float* __restrict__ pts, int d,
                                                          const int32_t* __restrict__ orig,
                                                          const int32_t* __restrict__ cells,
                                                          const int64_t* __restrict__ cell_start, int64_t m, int nx,
                                                          int ny, int nz, float r2, int32_t* __restrict__ counts,
                                                          const int64_t* __restrict__ indptr,
                                                          int32_t* __restrict__ out_idx,
                                                          float* __restrict__ out_dist) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (t >= m) return;
    const int32_t row = __ldg(orig + t);
    const int cx = __ldg(cells + 3 * t), cy = __ldg(cells + 3 * t + 1), cz = __ldg(cells + 3 * t + 2);
    float p[kD > 0 ? kD : 1];
    if constexpr (kD > 0) {
#pragma unroll
        for (int a = 0; a < kD; ++a) p[a] = __ldg(pts + t * kD + a);
    }
    const float* own = pts + t * d;
    int64_t out = 0;
    if constexpr (kFill) out = __ldg(indptr + row);
    int32_t cnt = 0;
    const int x0 = cx > 0 ? cx - 1 : 0, x1 = cx + 1 < nx ? cx + 1 : nx - 1;
    for (int z = cz > 0 ? cz - 1 : 0; z <= cz + 1 && z < nz; ++z) {
        for (int y = cy > 0 ? cy - 1 : 0; y <= cy + 1 && y < ny; ++y) {
            const int64_t base = (static_cast<int64_t>(z) * ny + y) * nx;
            const int64_t s1 = __ldg(cell_start + base + x1 + 1);
            for (int64_t s = __ldg(cell_start + base + x0); s < s1; ++s) {
                if (s == t) continue;
                const float d2 = sq_dist<kD>(pts, d, p, own, s);
                if (d2 <= r2) {
                    if constexpr (kFill) {
                        out_idx[out + cnt] = __ldg(orig + s);
                        out_dist[out + cnt] = sqrtf(d2);
                    }
                    ++cnt;
                }
            }
        }
    }
    if constexpr (!kFill) counts[row] = cnt;
}

template <int kD>
int launch(bool fill, const float* pts, int d, const int32_t* orig, const int32_t* cells, const int64_t* cell_start,
           int64_t m, int nx, int ny, int nz, float r2, int32_t* counts, const int64_t* indptr, int32_t* out_idx,
           float* out_dist, cudaStream_t s) {
    const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
    if (fill)
        radius_kernel<kD, true><<<blocks, kThreads, 0, s>>>(pts, d, orig, cells, cell_start, m, nx, ny, nz, r2, counts,
                                                            indptr, out_idx, out_dist);
    else
        radius_kernel<kD, false><<<blocks, kThreads, 0, s>>>(pts, d, orig, cells, cell_start, m, nx, ny, nz, r2,
                                                             counts, indptr, out_idx, out_dist);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `pts`: (m, d) float32 points sorted by cell; `orig`: (m,) their rows;
// `cells`: (m, 3) int32 cell coordinates (0 past the gridded axes);
// `cell_start`: (nx * ny * nz + 1,) int64 offsets of each cell's points.
// fill = 0 writes `counts` (n,) int32 (rows of non-finite points are left as
// they are); fill = 1 writes `out_idx`/`out_dist` from `indptr` (n + 1,) on.
SQT_EXPORT int sqt_radius_pairs(const float* pts, int d, const int32_t* orig, const int32_t* cells,
                                const int64_t* cell_start, int64_t m, int nx, int ny, int nz, float r2,
                                int32_t* counts, const int64_t* indptr, int32_t* out_idx, float* out_dist, int fill,
                                void* stream) {
    if (m == 0) return 0;
    if (d < 0 || nx < 1 || ny < 1 || nz < 1 || (m + kThreads - 1) / kThreads > 0x7FFFFFFF)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool f = fill != 0;
    switch (d) {
        case 1: return launch<1>(f, pts, d, orig, cells, cell_start, m, nx, ny, nz, r2, counts, indptr, out_idx,
                                 out_dist, s);
        case 2: return launch<2>(f, pts, d, orig, cells, cell_start, m, nx, ny, nz, r2, counts, indptr, out_idx,
                                 out_dist, s);
        case 3: return launch<3>(f, pts, d, orig, cells, cell_start, m, nx, ny, nz, r2, counts, indptr, out_idx,
                                 out_dist, s);
        default: return launch<0>(f, pts, d, orig, cells, cell_start, m, nx, ny, nz, r2, counts, indptr, out_idx,
                                  out_dist, s);
    }
}
