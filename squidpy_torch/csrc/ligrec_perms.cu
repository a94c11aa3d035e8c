// K9: CellPhoneDB permutation counts of ligrec, for a chunk of permutations.
//
// Replaces the XLA scan of squidpy_tpu/ops/ligrec.py `_perm_counts_scan`
// (line 50): for each permutation p of the chunk, the cluster sums of X
// under the shuffled labels, each scaled by the float reciprocal of its
// cluster's size, then counts[i, j] += [g[p, c1[j], rec[i]] +
// g[p, c2[j], lig[i]] > m_sum[i, j]]. The JAX code gets the sums from one
// (chunk*C, n) @ (n, G) one-hot product, C times the adds a cluster sum
// needs.
//
// Rounding of the compare, as the JAX package computes it on the CPU (its
// test suite's platform): XLA fuses the receptor's scaling into the add, so
// the left side is fma(sum[c1, rec], inv[c1], round(sum[c2, lig] * inv[c2]))
// with one rounding; the ligand's product is rounded on its own. The kernel
// calls fma explicitly for that term and nothing else: `--fmad=false` keeps
// every other product and sum a rounded operation. On integral counts the
// sums are exact, and many permutations give the same sums as the observed
// labels, so these ties are common, and only the same rounding gives the
// same counts.
//
// Bound on the card: at the main path's 1M cells x 64 genes, 16 clusters and
// a chunk of P permutations, n*G*P adds (the float route) against X read
// once a chunk and the labels (P*n bytes as uint8); the compare is I*J*P.
// The integral route does 2*n*G*P*16*ceil(C/16) int8 operations on the
// tensor cores (1,979 TOP/s dense) against the same bytes.
//
// Two routes, picked once a call by the wrapper
// (squidpy_torch/ops/ligrec.py `_k9_route`): the integral route where X is
// integral, in [0, 255], and every gene's column total (which bounds every
// cluster sum) is below 2^24 in float32 (2^53 in float64). Every summation
// order then gives the exact integer, so both routes, the plain version and
// JAX's one-hot product agree bit for bit; fractional X takes the float
// route, whose order the plain version walks too.
//
// Design, three kernels behind each entry point, with no float atomics, so a
// call gives the same sums, bit for bit, run after run:
// 1a. float sums: the cells are cut into slabs of `slab` consecutive cells. A warp
//    owns R permutations (4 at 16 clusters; fewer where the tables would
//    not fit) and 32 genes of one slab, and walks the slab's cells in
//    order: 32 labels a permutation in one coalesced load, broadcast by
//    shuffles, and for each cell one 128-byte row of X, loaded once and
//    added into acc[r][label][lane] in the warp's own shared-memory tables
//    (R x C x 32 sums). Each lane owns its gene's column, so no two lanes
//    touch one word, and a label is uniform across the warp, so the table's
//    row is too (no bank conflict). The tables go to a (slab, p, C, G)
//    partial in global memory. The warps of a block take consecutive
//    permutations of the same slab and genes, so they read the same rows of
//    X through L1, and the grid walks the permutations fastest, so a slab of
//    X is read from memory about once a chunk. The wrapper picks R
//    (squidpy_torch/ops/ligrec.py `_k9_layout`); chip_smoke.py's
//    `[diag] k9_layout` line times the other layouts on part e's chunk. The
//    shared-memory pipe sets the pace: a table load, a table store and a
//    label shuffle an update, one warp-wide access a clock an SM.
// 1b. integral sums: `mma_sums_kernel` below, the one-hot product on the
//    tensor cores (m16n8k32, u8 x u8 -> s32) with the one-hot built in
//    registers: no shared-memory table, no shuffle; int32 slab partials.
// 2. combine: one thread an element of (p, C, G) adds the slabs' partials in
//    slab order (the integral route in int64, rounded once).
// 3. compare: one thread an (interaction, cluster pair) counts its
//    exceedances over the chunk in a register and adds them to its own
//    int64 count.
// So the order of every float sum is: within a slab by cell, then across
// slabs by slab; the plain torch version (squidpy_torch/ops/ligrec.py) walks
// the same order and emulates the fma exactly. Labels outside [0, C) add
// nothing.

#include "common.cuh"

namespace {

// A warp's R tables, R consecutive permutations: each cell's row of X is
// loaded once and added into all R tables; the R loads of the tables go out
// before any add, then the R stores (the rows of different tables never
// alias), so their latencies overlap. A label outside [0, C), or a
// permutation past the chunk, adds +0.0 to its table's first row, which
// changes no sum (no sum here is -0.0).
template <typename T, typename L, int R>
__global__ void __launch_bounds__(256) sums_kernel(const T* __restrict__ x, int64_t n, int n_genes,
                                                  const L* __restrict__ labels, int64_t ld, int n_perms, int n_cls,
                                                  int slab, T* __restrict__ partials) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x;
    T* table = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(threadIdx.y) * R * n_cls * 32 + lane;
    const int p0 = (blockIdx.x * blockDim.y + threadIdx.y) * R;
    if (p0 >= n_perms) return;
    const int s = blockIdx.y;
    const int g = blockIdx.z * 32 + lane;
    const bool has_gene = g < n_genes;
    for (int c = 0; c < R * n_cls; ++c) table[c * 32] = T(0);
    const int64_t i0 = static_cast<int64_t>(s) * slab;
    const int64_t i1 = i0 + slab < n ? i0 + slab : n;
    const unsigned ncls = static_cast<unsigned>(n_cls);
    for (int64_t b = i0; b < i1; b += 32) {
        const int cnt = i1 - b < 32 ? static_cast<int>(i1 - b) : 32;
        int32_t my_lab[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
            my_lab[r] = lane < cnt && p0 + r < n_perms
                            ? static_cast<int32_t>(__ldg(labels + static_cast<int64_t>(p0 + r) * ld + b + lane))
                            : -1;
        const T* xb = x + b * n_genes + g;
#pragma unroll 2
        for (int k = 0; k < cnt; ++k) {
            const T v = has_gene ? __ldg(xb + static_cast<int64_t>(k) * n_genes) : T(0);
            int row[R];
            T add[R], old[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int lab = __shfl_sync(0xFFFFFFFFu, my_lab[r], k);
                const bool in = static_cast<unsigned>(lab) < ncls;
                row[r] = (r * n_cls + (in ? lab : 0)) * 32;
                add[r] = in ? v : T(0);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) old[r] = table[row[r]];
#pragma unroll
            for (int r = 0; r < R; ++r) table[row[r]] = old[r] + add[r];
        }
    }
    if (!has_gene) return;
    for (int r = 0; r < R && p0 + r < n_perms; ++r) {
        T* out = partials + ((static_cast<int64_t>(s) * n_perms + p0 + r) * n_cls) * n_genes + g;
        for (int c = 0; c < n_cls; ++c) out[static_cast<int64_t>(c) * n_genes] = table[(r * n_cls + c) * 32];
    }
}

template <typename T>
__global__ void __launch_bounds__(256) combine_kernel(const T* __restrict__ partials, int n_slabs, int64_t per_slab,
                                                     T* __restrict__ sums) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= per_slab) return;
    T tot = partials[e];
    for (int s = 1; s < n_slabs; ++s) tot += partials[static_cast<int64_t>(s) * per_slab + e];
    sums[e] = tot;
}

template <typename T>
__global__ void __launch_bounds__(256) compare_kernel(const T* __restrict__ sums, const T* __restrict__ inv_counts,
                                                     int n_perms, int n_cls, int n_genes,
                                                     const int32_t* __restrict__ rec,
                                                     const int32_t* __restrict__ lig, int n_inter,
                                                     const int32_t* __restrict__ c1, const int32_t* __restrict__ c2,
                                                     int n_pairs, const T* __restrict__ m_sum,
                                                     int64_t* __restrict__ counts) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= static_cast<int64_t>(n_inter) * n_pairs) return;
    const int i = static_cast<int>(e / n_pairs), j = static_cast<int>(e % n_pairs);
    const int ca = __ldg(c1 + j), cb = __ldg(c2 + j);
    const int64_t a = static_cast<int64_t>(ca) * n_genes + __ldg(rec + i);
    const int64_t b = static_cast<int64_t>(cb) * n_genes + __ldg(lig + i);
    const T inv_a = __ldg(inv_counts + ca), inv_b = __ldg(inv_counts + cb);
    const T ms = m_sum[e];
    const int64_t stride = static_cast<int64_t>(n_cls) * n_genes;
    int64_t cnt = 0;
    for (int p = 0; p < n_perms; ++p) {
        const T g_lig = __ldg(sums + p * stride + b) * inv_b;
        const T left = fma(__ldg(sums + p * stride + a), inv_a, g_lig);
        cnt += left > ms ? 1 : 0;
    }
    counts[e] += cnt;
}

// The integral route's sums: u8 X (gene-major, `ld_x` a row, zero past n)
// and u8 labels (`ld` a row) on the tensor cores. One m16n8k32 product adds
// 32 cells into 16 clusters x 8 genes: A is the one-hot of the labels (a
// cluster a row), built in registers by comparing four labels at once
// (__vcmpeq4) with the row's cluster byte, B is X. A warp owns R
// permutations of one slab, 16 clusters (blockIdx.z's cluster tile) and 64
// genes (blockIdx.z's gene tile: 8 n-tiles), and walks the slab 64 cells a
// step: thread (group g, lane-in-group t) loads 16 cells' bytes (t * 16 ...)
// of X for genes g, g + 8, ... and of each permutation's labels, and feeds
// them as the fragments of two k-steps. The cells go to k in the same order
// in A and B, so the products are the cluster sums, exact in int32 (a slab of
// at most 2^23 cells x 255), written to a (slab, p, C, G) int32 partial.
template <int R>
__global__ void __launch_bounds__(256) mma_sums_kernel(const uint8_t* __restrict__ xt, int64_t ld_x, int64_t n,
                                                      int n_genes, const uint8_t* __restrict__ labels, int64_t ld,
                                                      int n_perms, int n_cls, int c_tiles, int slab,
                                                      int32_t* __restrict__ partials) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int grp = lane >> 2, tq = lane & 3;
    const int p0 = (blockIdx.x * (blockDim.x >> 5) + warp) * R;
    if (p0 >= n_perms) return;
    const int s = blockIdx.y;
    const int ct = blockIdx.z % c_tiles, gz = blockIdx.z / c_tiles;
    const uint32_t pat0 = static_cast<uint32_t>(ct * 16 + grp) * 0x01010101u;
    const uint32_t pat1 = static_cast<uint32_t>(ct * 16 + grp + 8) * 0x01010101u;
    const int64_t i0 = static_cast<int64_t>(s) * slab;
    const int64_t i1 = i0 + slab < n ? i0 + slab : n;
    int32_t acc[R][8][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][nt][q] = 0;
    for (int64_t c = i0; c < i1; c += 64) {
        const int64_t cell = c + tq * 16;
        uint4 xv[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int gene = gz * 64 + nt * 8 + grp;
            xv[nt] = gene < n_genes ? __ldg(reinterpret_cast<const uint4*>(xt + gene * ld_x + cell))
                                    : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if (p0 + r >= n_perms) break;
            const uint4 lv = __ldg(reinterpret_cast<const uint4*>(labels + static_cast<int64_t>(p0 + r) * ld + cell));
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
                const uint32_t l0 = ks ? lv.z : lv.x, l1 = ks ? lv.w : lv.y;
                const uint32_t a0 = __vcmpeq4(l0, pat0) & 0x01010101u, a1 = __vcmpeq4(l0, pat1) & 0x01010101u;
                const uint32_t a2 = __vcmpeq4(l1, pat0) & 0x01010101u, a3 = __vcmpeq4(l1, pat1) & 0x01010101u;
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    const uint32_t b0 = ks ? xv[nt].z : xv[nt].x, b1 = ks ? xv[nt].w : xv[nt].y;
                    asm volatile(
                        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                        "{%8, %9}, {%0, %1, %2, %3};\n"
                        : "+r"(acc[r][nt][0]), "+r"(acc[r][nt][1]), "+r"(acc[r][nt][2]), "+r"(acc[r][nt][3])
                        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int p = p0 + r;
        if (p >= n_perms) break;
        int32_t* out = partials + (static_cast<int64_t>(s) * n_perms + p) * n_cls * n_genes;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int cl = ct * 16 + grp + (q >= 2 ? 8 : 0);
                const int g = gz * 64 + nt * 8 + tq * 2 + (q & 1);
                if (cl < n_cls && g < n_genes) out[static_cast<int64_t>(cl) * n_genes + g] = acc[r][nt][q];
            }
    }
}

// The integral route's combine: the slabs' int32 partials added in int64,
// rounded once to x's type (exact below 2^24 in float32, the route's rule).
template <typename T>
__global__ void __launch_bounds__(256) combine_int_kernel(const int32_t* __restrict__ partials, int n_slabs,
                                                         int64_t per_slab, T* __restrict__ sums) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= per_slab) return;
    int64_t tot = 0;
    for (int s = 0; s < n_slabs; ++s) tot += partials[static_cast<int64_t>(s) * per_slab + e];
    sums[e] = static_cast<T>(tot);
}

template <typename T, typename L, int R>
int launch_sums(const void* x, int64_t n, int n_genes, const L* labels, int64_t ld, int n_perms, int n_cls, int warps,
                int slab, int64_t n_slabs, int tiles, void* partials, cudaStream_t s) {
    const size_t smem = static_cast<size_t>(warps) * R * n_cls * 32 * sizeof(T);
    cudaError_t err = sqt_allow_smem(sums_kernel<T, L, R>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_block = warps * R;
    const dim3 grid((n_perms + per_block - 1) / per_block, static_cast<unsigned>(n_slabs), static_cast<unsigned>(tiles));
    sums_kernel<T, L, R><<<grid, dim3(32, warps), smem, s>>>(static_cast<const T*>(x), n, n_genes, labels, ld, n_perms,
                                                             n_cls, slab, static_cast<T*>(partials));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename L>
int launch_float_sums(const void* x, int64_t n, int n_genes, const void* labels, int64_t ld, int n_perms, int n_cls,
                      int warps, int per_warp, int slab, int64_t n_slabs, void* partials, cudaStream_t s) {
    const int tiles = (n_genes + 31) / 32;
    if (n_slabs > 65535 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const L* lab = static_cast<const L*>(labels);
    if (per_warp == 8)
        return launch_sums<T, L, 8>(x, n, n_genes, lab, ld, n_perms, n_cls, warps, slab, n_slabs, tiles, partials, s);
    if (per_warp == 4)
        return launch_sums<T, L, 4>(x, n, n_genes, lab, ld, n_perms, n_cls, warps, slab, n_slabs, tiles, partials, s);
    if (per_warp == 2)
        return launch_sums<T, L, 2>(x, n, n_genes, lab, ld, n_perms, n_cls, warps, slab, n_slabs, tiles, partials, s);
    if (per_warp == 1)
        return launch_sums<T, L, 1>(x, n, n_genes, lab, ld, n_perms, n_cls, warps, slab, n_slabs, tiles, partials, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <int R>
int launch_mma(const uint8_t* xt, int64_t ld_x, int64_t n, int n_genes, const uint8_t* labels, int64_t ld,
               int n_perms, int n_cls, int warps, int slab, int64_t n_slabs, int32_t* partials, cudaStream_t s) {
    const int c_tiles = (n_cls + 15) / 16, g_tiles = (n_genes + 63) / 64;
    const int per_block = warps * R;
    if (n_slabs > 65535 || static_cast<int64_t>(c_tiles) * g_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n_perms + per_block - 1) / per_block, static_cast<unsigned>(n_slabs),
                    static_cast<unsigned>(c_tiles * g_tiles));
    mma_sums_kernel<R><<<grid, 32 * warps, 0, s>>>(xt, ld_x, n, n_genes, labels, ld, n_perms, n_cls, c_tiles, slab,
                                                  partials);
    return static_cast<int>(cudaGetLastError());
}

// The slabs' combine and the compare, after either route's sums.
template <typename T>
int finish(bool integral, const void* partials, int64_t n_slabs, int n_perms, int n_cls, int n_genes,
           const void* inv_counts, const int32_t* rec, const int32_t* lig, int n_inter, const int32_t* c1,
           const int32_t* c2, int n_pairs, const void* m_sum, void* sums, int64_t* counts, cudaStream_t s) {
    const int64_t per_slab = static_cast<int64_t>(n_perms) * n_cls * n_genes;
    const unsigned blocks = static_cast<unsigned>((per_slab + 255) / 256);
    if (integral)
        combine_int_kernel<T><<<blocks, 256, 0, s>>>(static_cast<const int32_t*>(partials), static_cast<int>(n_slabs),
                                                     per_slab, static_cast<T*>(sums));
    else
        combine_kernel<T><<<blocks, 256, 0, s>>>(static_cast<const T*>(partials), static_cast<int>(n_slabs), per_slab,
                                                 static_cast<T*>(sums));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t pairs = static_cast<int64_t>(n_inter) * n_pairs;
    if (pairs == 0) return 0;
    compare_kernel<T><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, s>>>(
        static_cast<const T*>(sums), static_cast<const T*>(inv_counts), n_perms, n_cls, n_genes, rec, lig, n_inter,
        c1, c2, n_pairs, static_cast<const T*>(m_sum), counts);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int float_route(const void* x, int64_t n, int n_genes, const void* labels, int label_bytes, int64_t ld, int n_perms,
                int n_cls, int warps, int per_warp, int slab, int64_t n_slabs, void* partials, cudaStream_t s) {
    if (label_bytes == 1)
        return launch_float_sums<T, uint8_t>(x, n, n_genes, labels, ld, n_perms, n_cls, warps, per_warp, slab, n_slabs,
                                             partials, s);
    if (label_bytes == 4)
        return launch_float_sums<T, int32_t>(x, n, n_genes, labels, ld, n_perms, n_cls, warps, per_warp, slab, n_slabs,
                                             partials, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The float route. `x`: (n, n_genes) float32 (`dtype` 0) or float64 (1),
// row-major; `labels`: (n_perms, ld) uint8 (`label_bytes` 1) or int32 (4),
// columns from n on unread; `inv_counts`: (n_cls,); `m_sum`: (n_inter,
// n_pairs); `partials`: (ceil(n / slab), n_perms, n_cls, n_genes) and `sums`:
// (n_perms, n_cls, n_genes) scratch of x's type; `counts`: (n_inter,
// n_pairs) int64, added to. `warps`: warps a block (1-8); `per_warp`:
// permutations a warp (1, 2, 4 or 8), each with an n_cls x 32 table of
// shared memory.
SQT_EXPORT int sqt_ligrec_perms(const void* x, int64_t n, int n_genes, const void* labels, int label_bytes, int64_t ld,
                                int n_perms, int n_cls, int warps, int per_warp, const void* inv_counts,
                                const int32_t* rec, const int32_t* lig, int n_inter, const int32_t* c1,
                                const int32_t* c2, int n_pairs, const void* m_sum, int slab, void* partials,
                                void* sums, int64_t* counts, int dtype, void* stream) {
    if (n_perms == 0 || n_genes == 0 || n_cls == 0) return 0;
    if (n == 0 || ld < n || slab < 1 || warps < 1 || warps * per_warp > 32) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_slabs = (n + slab - 1) / slab;
    int code;
    if (dtype == 0)
        code = float_route<float>(x, n, n_genes, labels, label_bytes, ld, n_perms, n_cls, warps, per_warp, slab,
                                  n_slabs, partials, s);
    else if (dtype == 1)
        code = float_route<double>(x, n, n_genes, labels, label_bytes, ld, n_perms, n_cls, warps, per_warp, slab,
                                   n_slabs, partials, s);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    if (code != 0) return code;
    if (dtype == 0)
        return finish<float>(false, partials, n_slabs, n_perms, n_cls, n_genes, inv_counts, rec, lig, n_inter, c1, c2,
                             n_pairs, m_sum, sums, counts, s);
    return finish<double>(false, partials, n_slabs, n_perms, n_cls, n_genes, inv_counts, rec, lig, n_inter, c1, c2,
                          n_pairs, m_sum, sums, counts, s);
}

// The integral route. `xt`: (n_genes, ld_x) uint8, x transposed, zero from
// column n to ld_x (a multiple of 16, at least n rounded up to 64);
// `labels`: (n_perms, ld) uint8 (ld a multiple of 16, at least n rounded up
// to 64; labels at and past n_cls add nothing); `partials`: (ceil(n /
// slab), n_perms, n_cls, n_genes) int32 scratch; `slab` a multiple of 64, at
// most 2^23; `warps` a block (1-8) of `per_warp` (1, 2 or 4) permutations;
// the rest as the float route, with `sums` rounded once to `dtype`'s type.
SQT_EXPORT int sqt_ligrec_perms_int(const uint8_t* xt, int64_t ld_x, int64_t n, int n_genes, const uint8_t* labels,
                                    int64_t ld, int n_perms, int n_cls, int warps, int per_warp,
                                    const void* inv_counts, const int32_t* rec, const int32_t* lig, int n_inter,
                                    const int32_t* c1, const int32_t* c2, int n_pairs, const void* m_sum, int slab,
                                    int32_t* partials, void* sums, int64_t* counts, int dtype, void* stream) {
    if (n_perms == 0 || n_genes == 0 || n_cls == 0) return 0;
    const int64_t need = (n + 63) / 64 * 64;
    if (n == 0 || n_cls > 256 || ld_x < need || ld < need || ld_x % 16 || ld % 16 || slab < 64 || slab % 64 ||
        slab > (1 << 23) || warps < 1 || warps > 8 || (dtype != 0 && dtype != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_slabs = (n + slab - 1) / slab;
    int code;
    if (per_warp == 4)
        code = launch_mma<4>(xt, ld_x, n, n_genes, labels, ld, n_perms, n_cls, warps, slab, n_slabs, partials, s);
    else if (per_warp == 2)
        code = launch_mma<2>(xt, ld_x, n, n_genes, labels, ld, n_perms, n_cls, warps, slab, n_slabs, partials, s);
    else if (per_warp == 1)
        code = launch_mma<1>(xt, ld_x, n, n_genes, labels, ld, n_perms, n_cls, warps, slab, n_slabs, partials, s);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    if (code != 0) return code;
    if (dtype == 0)
        return finish<float>(true, partials, n_slabs, n_perms, n_cls, n_genes, inv_counts, rec, lig, n_inter, c1, c2,
                             n_pairs, m_sum, sums, counts, s);
    return finish<double>(true, partials, n_slabs, n_perms, n_cls, n_genes, inv_counts, rec, lig, n_inter, c1, c2,
                          n_pairs, m_sum, sums, counts, s);
}
