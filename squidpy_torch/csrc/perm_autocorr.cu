// K5b: permuted numerators of Moran's I and Geary's C.
//
// Replaces the XLA code of squidpy_tpu/ops/autocorr.py `moran_perm_scores`
// (line 272) and `geary_perm_scores` (line 348). For every permutation p and
// gene g, over the rows i of the centred gene block z (n, g), u = W z (n, g)
// and the row sums r (n,) of W:
//   mode 1 (moran): out[p, g] = sum_i z[i, g] * u[p(i), g]
//   mode 2 (geary): out[p, g] = sum_i z[i, g] * (z[i, g] * r[p(i)] - 2 u[p(i), g])
// Geary's permutation-invariant third term is added by the caller, and so is
// the bf16 rounding of the numerator that the JAX package applies at
// n >= 2^19: this kernel returns the float32 sums unrounded.
// Permutation p's index of row i is perms[p * sp + i * si], so both the
// (P, n) table of the sort shuffles and the (n, P) table K4 writes are read
// in place.
//
// Operands are float32, or bf16 (z, u and r alike) at n >= 2^19 as in the
// JAX package. A product of two bf16 values is exact in float32.
//
// Bound on the card: the least traffic is z, u and the permutation table
// once (at 1M x 512 bf16 x 100 permutations: 2 GB of operands and 0.4 GB of
// positions, ~0.7 ms at 3.35 TB/s) against 2 (Moran) or 5 (Geary) flops per
// (p, i, g): 1.0e11 / 2.6e11 flops, ~1.5 / 3.8 ms at 67 TFLOP/s.
//
// Design (the gathers of u rows by permuted index are the whole cost):
// - the wrapper repacks z and u once per call into gene-tile-major order
//   (tiles, n, 16), so that one row's 16 genes are one record: 32 bytes in
//   bf16 (from 2^19 rows), 64 in float32 (below 2^19 rows, so a tile is at
//   most 32 MB in either dtype). The launches walk the tiles one after
//   another, so the gathers of a launch hit one tile, which the 50 MB L2
//   mostly holds;
// - a record is gathered by LPR = bytes / 16 neighbouring lanes, 16 bytes
//   each, so one warp-wide load moves 32 / LPR whole records and every L2
//   sector it touches is used once: the warp's lanes are 32 / LPR
//   permutations of one row;
// - each warp walks runs of 16 rows. A run's positions and z records are
//   staged in shared memory with cp.async in a ring of three runs, so the
//   gathers of one run never wait on a device-memory load of its positions:
//   a plain loop of index load then dependent gather spent about half its
//   time on that latency. With K4's (n, P) positions a run's indices are
//   coalesced reads;
// - Geary's r[p(i)] is the same for every gene tile: the first tile's launch
//   gathers it and writes it into a float32 table laid out as the positions,
//   which the later tiles read beside them (a coalesced read that no gather
//   waits on);
// - each lane adds its products in float32 over a run, folds the run into
//   double sums, and the block sums its warps in a fixed order into a
//   (groups, P, g) double partial; a second pass sums the partials in
//   row-group order. No float atomics: the same bits every run.

#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kGenes = 16;  // genes of a record (one gene tile)
constexpr int kRun = 16;   // rows per staged run
constexpr int kStages = 3;  // runs in flight per warp

using bf16_bits = uint16_t;

// 16-byte vectors of a record: 4 in float32, 2 in bf16
template <typename T>
constexpr int kLpr = kGenes * static_cast<int>(sizeof(T)) / 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16_bits x) { return __uint_as_float(static_cast<uint32_t>(x) << 16); }

// The values of a 16-byte vector, as float32.
template <typename T>
__device__ __forceinline__ void unpack(uint4 v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = __uint_as_float(w[k]);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            out[2 * k] = __uint_as_float(w[k] << 16);  // little endian: element 2k is the low half
            out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
// every group but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

// Bytes of shared memory one warp stages: kStages runs of z records and
// positions.
template <typename T>
__host__ __device__ constexpr int warp_stage_bytes() {
    return kStages * kRun * (kLpr<T> * 16 + (32 / kLpr<T>) * 4);
}

// One gene tile: zt, ut are this tile's (n, 16) records; for Geary r (n,)
// and rg, the float32 table of r[p(i)] with the
// strides (rsp, rsi): the first tile (first_tile) gathers r and fills rg,
// the later ones read rg.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    perm_tile_kernel(int mode, const T* __restrict__ zt, const T* __restrict__ ut, const T* __restrict__ r,
                     float* __restrict__ rg, long long rsp, long long rsi, int first_tile, int n,
                     const int32_t* __restrict__ perms, int n_perms, long long sp, long long si, int rows_per_group,
                     int gene0, int gp, double* __restrict__ partial) {
    constexpr int LPR = kLpr<T>;
    constexpr int kLaneGenes = kGenes / LPR;
    constexpr int kPerms = 32 / LPR;  // permutations of a warp
    extern __shared__ __align__(16) unsigned char smem[];
    const bool geary = mode == 2;

    const int lane = threadIdx.x;
    const int warp = threadIdx.y;
    const int part = lane % LPR;  // this lane's 16 bytes of the record
    const int pl = lane / LPR;
    const int pbase = blockIdx.x * kPerms;
    const int p = pbase + pl;
    const bool active = p < n_perms;
    const int i0 = blockIdx.y * rows_per_group;
    const int i1 = min(n, i0 + rows_per_group);
    const uint4* urec = reinterpret_cast<const uint4*>(ut);
    const uint4* zrec = reinterpret_cast<const uint4*>(zt);
    // this warp's ring: (kStages, kRun, LPR) z vectors and (kStages, kRun, kPerms) positions
    uint4* zs = reinterpret_cast<uint4*>(smem + warp * warp_stage_bytes<T>());
    int32_t* js = reinterpret_cast<int32_t*>(zs + kStages * kRun * LPR);

    // this warp's runs: i0 + (warp + q * kWarps) * kRun, q = 0, 1, ...
    const int stride = kWarps * kRun;
    auto stage = [&](int base, int slot) {
        if (base < i1) {
#pragma unroll
            for (int c = lane; c < kRun * LPR; c += 32) {
                const int i = base + c / LPR;
                if (i < i1) cp_async16(zs + slot * kRun * LPR + c, zrec + static_cast<size_t>(i) * LPR + c % LPR);
            }
#pragma unroll
            for (int c = lane; c < kRun * kPerms; c += 32) {
                const long long i = base + c / kPerms;
                const int pp = pbase + c % kPerms;
                if (i < i1 && pp < n_perms) cp_async4(js + slot * kRun * kPerms + c, perms + pp * sp + i * si);
            }
        }
        cp_async_commit();  // an empty group past the end keeps the ring's count
    };

    double dsum[kLaneGenes];
#pragma unroll
    for (int k = 0; k < kLaneGenes; ++k) dsum[k] = 0.0;
    int base = i0 + warp * kRun;
    stage(base, 0);
    stage(base + stride, 1);
    for (int q = 0; base < i1; base += stride, ++q) {
        cp_async_wait_prior();
        __syncwarp();
        stage(base + 2 * stride, (q + 2) % kStages);
        const int slot = q % kStages;
        const uint4* zrun = zs + slot * kRun * LPR;
        const int32_t* jrun = js + slot * kRun * kPerms;
        const int rows = min(kRun, i1 - base);
        float acc[kLaneGenes];
#pragma unroll
        for (int k = 0; k < kLaneGenes; ++k) acc[k] = 0.f;
        if (active) {
#pragma unroll 8
            for (int rr = 0; rr < rows; ++rr) {
                const size_t j = static_cast<size_t>(jrun[rr * kPerms + pl]);
                float uf[kLaneGenes], zf[kLaneGenes];
                unpack<T>(__ldg(urec + j * LPR + part), uf);
                unpack<T>(zrun[rr * LPR + part], zf);
                if (!geary) {
#pragma unroll
                    for (int k = 0; k < kLaneGenes; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(zf[k], uf[k]));
                } else {
                    float* rgp = rg + p * rsp + static_cast<long long>(base + rr) * rsi;
                    float rj;
                    if (first_tile) {
                        rj = to_float(r[j]);
                        if (part == 0) *rgp = rj;
                    } else {
                        rj = __ldcs(rgp);
                    }
#pragma unroll
                    for (int k = 0; k < kLaneGenes; ++k) {
                        const float t = __fsub_rn(__fmul_rn(zf[k], rj), __fmul_rn(2.f, uf[k]));
                        acc[k] = __fadd_rn(acc[k], __fmul_rn(zf[k], t));
                    }
                }
            }
        }
#pragma unroll
        for (int k = 0; k < kLaneGenes; ++k) dsum[k] += static_cast<double>(acc[k]);
        __syncwarp();  // every lane is done with this slot before it is staged again
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    // the block's warps, summed in warp order, through the staging space
    double* sums = reinterpret_cast<double*>(smem);  // (kWarps, kLaneGenes, 32)
#pragma unroll
    for (int k = 0; k < kLaneGenes; ++k) sums[(warp * kLaneGenes + k) * 32 + lane] = dsum[k];
    __syncthreads();
    for (int e = warp * 32 + lane; e < kLaneGenes * 32; e += kWarps * 32) {
        const int k = e / 32;
        const int l = e % 32;
        double s = 0.0;
        for (int w = 0; w < kWarps; ++w) s += sums[(w * kLaneGenes + k) * 32 + l];
        const int pe = pbase + l / LPR;
        if (pe < n_perms) {
            partial[(static_cast<size_t>(blockIdx.y) * n_perms + pe) * gp + gene0 + (l % LPR) * kLaneGenes + k] = s;
        }
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

template <typename T>
int launch(int mode, const void* zt, const void* ut, const void* r, float* rg, long long rsp, long long rsi, int n,
           int tiles, const int32_t* perms, int n_perms, long long sp, long long si, int groups, double* partial,
           cudaStream_t s) {
    constexpr int LPR = kLpr<T>;
    const size_t staged = static_cast<size_t>(kWarps) * warp_stage_bytes<T>();
    const size_t sums = static_cast<size_t>(kWarps) * (kGenes / LPR) * 32 * sizeof(double);
    const size_t smem = staged > sums ? staged : sums;
    cudaError_t err = sqt_allow_smem(perm_tile_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows_per_group = (n + groups - 1) / groups;
    const dim3 grid((n_perms + 32 / LPR - 1) / (32 / LPR), groups);
    const int gp = tiles * kGenes;
    // one launch per gene tile, in order, so that one tile of u is resident in L2 at a time
    for (int t = 0; t < tiles; ++t) {
        const size_t off = static_cast<size_t>(t) * n * kGenes;
        perm_tile_kernel<T><<<grid, dim3(32, kWarps), smem, s>>>(
            mode, static_cast<const T*>(zt) + off, static_cast<const T*>(ut) + off, static_cast<const T*>(r), rg, rsp,
            rsi, t == 0, n, perms, n_perms, sp, si, rows_per_group, t * kGenes, gp, partial);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // namespace

// z, u: (tiles, n, 16) gene tiles of float32 (dtype 0) or bf16 (dtype 1);
// r (n,) of the same dtype for Geary, else null, and rg a float32 table with
// element strides (rsp, rsi) that receives r[p(i)]; perms int32 with element
// strides (sp, si) per permutation and row; partial is (groups, n_perms,
// tiles * 16) float64 scratch; out (n_perms, tiles * 16) float32.
SQT_EXPORT int sqt_perm_autocorr(int mode, int dtype, const void* z, const void* u, const void* r,
                                 float* rg, long long rsp, long long rsi, int n, int tiles, const int32_t* perms,
                                 int n_perms, long long sp, long long si, int groups, double* partial, float* out,
                                 void* stream) {
    if (n <= 0 || tiles <= 0 || n_perms <= 0 || groups <= 0 || (mode != 1 && mode != 2) ||
        (mode == 2 && (!r || !rg))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int code;
    if (dtype == 0) {
        code = launch<float>(mode, z, u, r, rg, rsp, rsi, n, tiles, perms, n_perms, sp, si, groups, partial, s);
    } else if (dtype == 1) {
        code = launch<bf16_bits>(mode, z, u, r, rg, rsp, rsi, n, tiles, perms, n_perms, sp, si, groups, partial, s);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (code != 0) return code;
    const size_t per_group = static_cast<size_t>(n_perms) * tiles * kGenes;
    sum_partials_kernel<<<static_cast<unsigned>((per_group + 255) / 256), 256, 0, s>>>(partial, groups, per_group,
                                                                                     out);
    return static_cast<int>(cudaGetLastError());
}
