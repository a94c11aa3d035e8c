// K5b: permuted numerators of Moran's I and Geary's C.
//
// Replaces the XLA code of squidpy_tpu/ops/autocorr.py `moran_perm_scores`
// (line 272) and `geary_perm_scores` (line 348). For every permutation p and
// gene g, over the rows i of the centred gene block z (n, g), u = W z (n, g)
// and the row sums r (n,) of W:
//   mode 1 (moran): out[p, g] = sum_i z[i, g] * u[p(i), g]
//   mode 2 (geary): out[p, g] = sum_i z[i, g] * (z[i, g] * r[p(i)] - 2 u[p(i), g])
// Geary's permutation-invariant third term is added by the caller.
// Permutation p's index of row i is perms[p * sp + i * si], so both the
// (P, n) table of the sort shuffles and the (n, P) table K4 writes are read
// in place.
//
// Bound on the card: the least traffic is z, u and the permutation table
// once (4.5 GB at 1M x 512 x 100 permutations, ~1.3 ms at 3.35 TB/s) against
// 2 (Moran) or 5 (Geary) flops per (p, i, g), 1.0e11 / 2.6e11 flops, ~1.5 /
// 3.8 ms at 67 TFLOP/s. This simple kernel gathers a u row segment for every
// (p, i): about n * g * 4 bytes per permutation from device memory (u does
// not fit the 50 MB L2), ~2 GB per permutation at 1M x 512. Reusing a
// gathered u row across permutations is a later design's work.
//
// Design:
// - a block is 32 genes (one warp's lanes: each gathered u row segment is a
//   coalesced 128-byte read) by 8 warps, each thread holding 4 permutations;
//   z[i, g] is read once per row and reused for the thread's permutations;
// - a fixed number of row groups, each walking many rows, keeps the
//   (groups, P, g) double partials small (groups <= 64); each thread owns its
//   (p, g) sums, accumulated in double from float32 terms rounded one by one
//   (as the plain torch version rounds them), and a second pass sums the
//   partials in row-group order: no atomics, the same result every run.

#include "common.cuh"

namespace {

constexpr int kGenes = 32;
constexpr int kWarps = 8;
constexpr int kPermsPerThread = 4;
constexpr int kPermsPerBlock = kWarps * kPermsPerThread;

__global__ void perm_autocorr_kernel(int mode, const float* __restrict__ z, const float* __restrict__ u,
                                     const float* __restrict__ r, int n, int g, const int32_t* __restrict__ perms,
                                     int n_perms, long long sp, long long si, int rows_per_group,
                                     double* __restrict__ partial) {
    const int gene = blockIdx.y * kGenes + threadIdx.x;
    const int p0 = blockIdx.z * kPermsPerBlock + threadIdx.y * kPermsPerThread;
    if (gene >= g || p0 >= n_perms) return;
    const int np = min(kPermsPerThread, n_perms - p0);
    const int i0 = blockIdx.x * rows_per_group;
    const int i1 = min(n, i0 + rows_per_group);
    double acc[kPermsPerThread] = {0.0, 0.0, 0.0, 0.0};
    for (int i = i0; i < i1; ++i) {
        const float zi = z[static_cast<size_t>(i) * g + gene];
#pragma unroll
        for (int q = 0; q < kPermsPerThread; ++q) {
            if (q >= np) break;
            const size_t j = static_cast<size_t>(perms[(p0 + q) * sp + i * si]);
            const float uj = u[j * g + gene];
            float t;
            if (mode == 1) {
                t = __fmul_rn(zi, uj);
            } else {
                t = __fmul_rn(zi, __fsub_rn(__fmul_rn(zi, r[j]), __fmul_rn(2.f, uj)));
            }
            acc[q] += static_cast<double>(t);
        }
    }
    for (int q = 0; q < np; ++q) {
        partial[(static_cast<size_t>(blockIdx.x) * n_perms + p0 + q) * g + gene] = acc[q];
    }
}

__global__ void sum_partials_kernel(const double* __restrict__ partial, int groups, size_t per_group,
                                    float* __restrict__ out) {
    const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= per_group) return;
    double s = 0.0;
    for (int b = 0; b < groups; ++b) s += partial[b * per_group + e];
    out[e] = static_cast<float>(s);
}

}  // namespace

// z, u (n, g) float32; r (n,) float32 for Geary, else null; perms int32 with
// element strides (sp, si) per permutation and row; partial is (groups,
// n_perms, g) float64 scratch; out (n_perms, g) float32.
SQT_EXPORT int sqt_perm_autocorr(int mode, const float* z, const float* u, const float* r, int n, int g,
                                 const int32_t* perms, int n_perms, long long sp, long long si, int groups,
                                 double* partial, float* out, void* stream) {
    if (n <= 0 || g <= 0 || n_perms <= 0 || groups <= 0 || (mode != 1 && mode != 2) || (mode == 2 && !r)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows_per_group = (n + groups - 1) / groups;
    const dim3 grid(groups, (g + kGenes - 1) / kGenes, (n_perms + kPermsPerBlock - 1) / kPermsPerBlock);
    perm_autocorr_kernel<<<grid, dim3(kGenes, kWarps), 0, s>>>(mode, z, u, r, n, g, perms, n_perms, sp, si,
                                                              rows_per_group, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t per_group = static_cast<size_t>(n_perms) * g;
    sum_partials_kernel<<<static_cast<unsigned>((per_group + 255) / 256), 256, 0, s>>>(partial, groups, per_group,
                                                                                     out);
    return static_cast<int>(cudaGetLastError());
}
