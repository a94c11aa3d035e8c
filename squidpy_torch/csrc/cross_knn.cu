// K8: the k nearest data points of each query, for one data set or a batch of them.
//
// Replaces squidpy_tpu/ops/knn.py `_cross_knn_device` (line 364) and
// squidpy_tpu/ops/ripley.py `_batched_nn_device` (line 121): XLA code that
// computes an expanded-form d2 block (MXU matmul) a query tile, selects with
// `top_k` or `argmin`, then recomputes the winners' exact distances. Here,
// for queries (m, d) float32 and S data sets (n, d) float32, it writes each
// query's k nearest points of each set, ascending: distances (S, m, k)
// float32 and indices (S, m, k) int32. Points are ranked by the
// difference-form d2 in axis order, d2 = (q_0 - x_0)^2, then d2 +=
// (q_a - x_a)^2, each operation rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, --fmad=false), ties going to the lowest index: the key of a
// point is (bits of d2) << 32 | index, a NaN d2 taking the bits 0x7fc00000,
// after +inf. A distance is sqrtf(d2), correctly rounded (no fast math).
// The plain torch version selects by the same keys over every point, so
// both agree bit for bit.
//
// Bound on the card: bytes. Ripley's G mode on the main path (1M cells in
// 16 types) asks for 2 neighbours of each of ~947k queries among ~53k
// points: the grid search below tests ~17 points a query there (~14 on the
// envelopes), 3d operations each, so the queries, points and outputs, each
// moved once, weigh more than the tests.
//
// Design: an exact cell-grid search. The wrapper (squidpy_torch/ops/knn.py)
// bins every set's points into one uniform float64 grid on the first
// min(d, 3) axes, about two points of a set a cell, with K6's bounds, bin
// and scatter kernels (csrc/radius_pairs.cu): a counting sort, each set's
// cells after the last set's, each followed by its bucket of points with a
// non-finite gridded coordinate. It bins the queries into the same grid by
// the same kernels (a query outside the box takes the nearest cell), so the
// queries of a warp, taken in cell order, share cells and read the same
// candidates. One thread takes one (query, set): it walks rings of cells
// outward from the query's cell, the cells of a grid row along x being one
// contiguous range of the sort, and after each ring computes a lower bound
// on the float32 d2 of every point in a cell outside the box walked so far
// (the float64 gap from the query to the box along one axis and to the
// grid's extent along the others, each shrunk by a margin, rounded down to
// float32 and squared; see `ring_bound`). It stops once that bound
// is strictly above the d2 of its list's last key (the k-th, or for a k
// that is not a power of two up to 32 the next power's): an unvisited point
// at an equal d2 with a lower index would change the answer. While that d2
// is +inf or NaN, or the list is not full, it cannot stop; once the box
// holds the whole grid it scans the set's bucket of points with no cell,
// whose d2 are +inf or NaN. A query with a non-finite gridded coordinate
// scans every point of the set. The k best keys sit in registers, sorted,
// in a list of the next power of two at most 32 (KC >= k): a key below the
// list's last enters by a branch-free sorted insertion, and the first k of
// the best KC are the best k. A k above 32 keeps its list in a global
// scratch row a query (the slower branch: a binary search, then a shift).
// Blocks run the queries of one set together, so a set's points and cell
// offsets stay in L1/L2; the outputs go to each query's own row.

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "knn_keys.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStagePoints = 1024;  // the brute-force scan's points staged a round
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
    double lo[3];
    double side;
    double margin;  // the gap's shrink, relative to its terms' magnitudes
    int dims[3];
    int g;          // gridded axes: min(d, 3)
    int cells;      // nx * ny * nz; a set's bucket of points with no cell follows them
};

struct Search {
    const float* qpts;       // (m, d) the queries in cell order
    const int* qorig;        // (m,) their rows
    const int* qcell;        // (m,) their cells, `cells` for a non-finite query
    int m;
    const float* pts;        // (S n, d) the points in (set, cell) order
    const int* orig;         // (S n,) their rows of the (S n, d) data
    const int* cell_start;   // (S (cells + 1) + 1,) offsets of each set's cells in the sort
    int n;
    int dim;
    int k;
    int q_blocks;
    unsigned long long* scratch;  // (S, m, k) all ones when k > 32
    unsigned long long* stats;    // null, or [tests, most tests, rings, most rings, scanning queries]
    float* out_d;
    int* out_i;
};

// KC > 0: a sorted register list of KC keys; KC = 0: `k` keys in a global scratch row.
template <int KC>
struct TopK {
    unsigned long long best[KC ? KC : 1];
    unsigned long long* list;
    int k;
    unsigned long long worst;  // the list's last key (KC = 0)

    __device__ __forceinline__ void insert(unsigned long long key) {
        if (KC) {
            if (key < best[(KC ? KC : 1) - 1]) {
                // new[r] = max(old[r - 1], min(old[r], key)): the sorted list with key in, its last out
#pragma unroll
                for (int r = (KC ? KC : 1) - 1; r > 0; --r) {
                    const unsigned long long lo = best[r] < key ? best[r] : key;
                    best[r] = best[r - 1] > lo ? best[r - 1] : lo;
                }
                best[0] = best[0] < key ? best[0] : key;
            }
        } else if (key < worst) {
            int lo = 0, hi = k - 1;  // the first slot whose key is above `key`
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (list[mid] < key) lo = mid + 1; else hi = mid;
            }
            for (int r = k - 1; r > lo; --r) list[r] = list[r - 1];
            list[lo] = key;
            worst = list[k - 1];
        }
    }

    __device__ __forceinline__ void init(unsigned long long* row, int k_) {
#pragma unroll
        for (int r = 0; r < (KC ? KC : 1); ++r) best[r] = ~0ULL;
        list = KC ? nullptr : row;
        k = k_;
        worst = ~0ULL;
    }

    // the bits of the list's last key's d2 (the KC-th key, at or after the
    // k-th: a stopping test against it is exact too, and reading the k-th
    // would index the registers at run time): all ones while the list is short
    __device__ __forceinline__ unsigned last_bits() const {
        return static_cast<unsigned>((KC ? best[(KC ? KC : 1) - 1] : worst) >> 32);
    }

    // the k keys as distances and indices at out_d/out_i + o
    __device__ __forceinline__ void write(float* out_d, int* out_i, size_t o) const;
};

__device__ __forceinline__ void write_key(float* out_d, int* out_i, size_t o, unsigned long long key) {
    out_d[o] = sqrtf(__uint_as_float(static_cast<unsigned>(key >> 32)));
    out_i[o] = static_cast<int>(key & 0xffffffffULL);
}

template <int KC>
__device__ __forceinline__ void TopK<KC>::write(float* out_d, int* out_i, size_t o) const {
    if (KC) {
#pragma unroll
        for (int r = 0; r < (KC ? KC : 1); ++r)
            if (r < k) write_key(out_d, out_i, o + r, best[r]);
    } else {
        for (int r = 0; r < k; ++r) write_key(out_d, out_i, o + r, list[r]);
    }
}

// The query's difference-form d2 to the point `x`: its coordinates `xq` in
// registers for D > 0, else `qp` read through the cache for the runtime `d`.
template <int D>
__device__ __forceinline__ float sq_dist(const float (&xq)[D ? D : 1], const float* qp, const float* x, int d) {
    float diff = __fsub_rn(D ? xq[0] : __ldg(qp), x[0]);
    float d2 = __fmul_rn(diff, diff);
    if (D) {
#pragma unroll
        for (int e = 1; e < (D ? D : 1); ++e) {
            diff = __fsub_rn(xq[e], x[e]);
            d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
        }
    } else {
        for (int e = 1; e < d; ++e) {
            diff = __fsub_rn(__ldg(qp + e), x[e]);
            d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
        }
    }
    return d2;
}

// The brute-force scan, for small inputs, where the grid's fixed cost (a
// read-back of the points' bounds, two counting sorts) outweighs the
// search: one thread a query, the grid over (query blocks, sets); a block
// stages its set's points in shared memory, `stage` at a time, and every
// thread reads each staged point as a broadcast.
template <int D, int KC>
__global__ void __launch_bounds__(kThreads) brute_knn_kernel(
    const float* __restrict__ queries, int m, const float* __restrict__ data, int n, int dim, int k, int stage,
    int q_blocks, unsigned long long* __restrict__ scratch, float* __restrict__ out_d, int* __restrict__ out_i) {
    const int d = D ? D : dim;
    extern __shared__ __align__(16) float tile[];  // (stage, d)
    const int qb = blockIdx.x % q_blocks;
    const int set = blockIdx.x / q_blocks;
    const int q = qb * kThreads + threadIdx.x;
    const bool valid = q < m;
    const float* qp = queries + static_cast<size_t>(valid ? q : 0) * d;
    const float* base = data + static_cast<size_t>(set) * n * d;
    float xq[D ? D : 1];
#pragma unroll
    for (int x = 0; x < (D ? D : 1); ++x) xq[x] = D ? qp[x] : 0.f;
    TopK<KC> top;
    top.init(scratch + (static_cast<size_t>(set) * m + (valid ? q : 0)) * k, k);

    for (int t0 = 0; t0 < n; t0 += stage) {
        const int cnt = n - t0 < stage ? n - t0 : stage;
        __syncthreads();  // every thread is done with the last staged points
        for (int e = threadIdx.x; e < cnt * d; e += kThreads) tile[e] = base[static_cast<size_t>(t0) * d + e];
        __syncthreads();
        if (!valid) continue;
        for (int j = 0; j < cnt; ++j) top.insert(make_key(sq_dist<D>(xq, qp, tile + j * d, d), t0 + j));
    }
    if (valid) top.write(out_d, out_i, (static_cast<size_t>(set) * m + q) * k);
}

// A float64 gap rounded down to float32 (0 below 0), squared in float32.
__device__ __forceinline__ float square_below(double gap) {
    const float low = gap > 0.0 ? __double2float_rd(gap) : 0.0f;
    return __fmul_rn(low, low);
}

// The query's offsets from the grid's corner, `qa`, and for each gridded
// axis the square of its distance to the grid's extent [0, dims * side],
// `outside` (see `ring_bound`).
__device__ __forceinline__ void query_extent(const float* qp, const Grid& gr, double (&qa)[3], float (&outside)[3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        qa[a] = 0.0;
        outside[a] = 0.0f;
        if (a >= gr.g) continue;
        qa[a] = __dsub_rn(static_cast<double>(__ldg(qp + a)), gr.lo[a]);
        const double top = __dmul_rn(static_cast<double>(gr.dims[a]), gr.side);
        const double below = __dsub_rn(-qa[a], __dmul_rn(gr.margin, fabs(qa[a])));
        const double above = __dsub_rn(__dsub_rn(qa[a], top), __dmul_rn(gr.margin, __dadd_rn(fabs(qa[a]), top)));
        outside[a] = square_below(below > above ? below : above);
    }
}

// A lower bound on the float32 d2 from the query to any point in a cell
// outside the box lo..hi (inclusive): false when the box holds every cell.
// The same arithmetic as squidpy_torch/ops/radius.py `_ring_bound`: a point
// beyond the box on axis a is at least that side's float64 gap away along
// a, shrunk by margin * (|qa| + |boundary|), and inside the grid's extent
// on the other axes; each gap rounded down to float32 and squared, the
// squares summed in axis order in float32, the least sum over the box's
// sides that have cells beyond them.
__device__ __forceinline__ bool ring_bound(const double (&qa)[3], const float (&outside)[3], const Grid& gr,
                                           const int (&lo)[3], const int (&hi)[3], float* bound) {
    float best = INFINITY;
    bool open = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        if (a >= gr.g) break;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
            if (side == 0 ? lo[a] == 0 : hi[a] == gr.dims[a] - 1) continue;  // no cells beyond
            const double b = __dmul_rn(static_cast<double>(side == 0 ? lo[a] : hi[a] + 1), gr.side);
            const double gap = __dsub_rn(side == 0 ? __dsub_rn(qa[a], b) : __dsub_rn(b, qa[a]),
                                         __dmul_rn(gr.margin, __dadd_rn(fabs(qa[a]), fabs(b))));
            const float own = square_below(gap);
            float total = a == 0 ? own : outside[0];
#pragma unroll
            for (int e = 1; e < 3; ++e)
                if (e < gr.g) total = __fadd_rn(total, e == a ? own : outside[e]);
            best = total < best ? total : best;
            open = true;
        }
    }
    *bound = best;
    return open;
}

// D = 0: the dimension is the runtime `dim`, the query's coordinates read through the cache.
template <int D, int KC>
__global__ void __launch_bounds__(kThreads) grid_knn_kernel(const Search a, const Grid gr) {
    const int d = D ? D : a.dim;
    const int qb = blockIdx.x % a.q_blocks;
    const int set = blockIdx.x / a.q_blocks;
    const int t = qb * kThreads + threadIdx.x;
    const bool valid = t < a.m;
    const float* qp = a.qpts + static_cast<size_t>(valid ? t : 0) * d;
    float xq[D ? D : 1];
#pragma unroll
    for (int x = 0; x < (D ? D : 1); ++x) xq[x] = D ? __ldg(qp + x) : 0.f;
    double qa[3];
    float outside[3];
    query_extent(qp, gr, qa, outside);

    TopK<KC> top;
    top.init(a.scratch + (static_cast<size_t>(set) * a.m + (valid ? t : 0)) * a.k, a.k);

    const int base = set * a.n;  // the set's first row, and its first slot in the sort
    const int* cs = a.cell_start + static_cast<size_t>(set) * (gr.cells + 1);
    long long tests = 0;
    int rings = 0, scanning = 0;

    if (valid) {
        const int c = __ldg(a.qcell + t);
        int last0 = base, last1 = base + a.n;  // a non-finite gridded coordinate: every point
        if (c < gr.cells) {
            const int nx = gr.dims[0], ny = gr.dims[1];
            const int cc[3] = {c % nx, (c / nx) % ny, c / (nx * ny)};
            bool stopped = false;
            for (int r = 0;; ++r) {
                int lo[3], hi[3];
#pragma unroll
                for (int x = 0; x < 3; ++x) {
                    lo[x] = cc[x] - r > 0 ? cc[x] - r : 0;
                    hi[x] = cc[x] + r < gr.dims[x] - 1 ? cc[x] + r : gr.dims[x] - 1;
                }
                // ring r: a row (z, y) at distance r takes all its cells of the box, any other row
                // the two cells at distance r along x: at most two ranges of the sort a row
                for (int z = lo[2]; z <= hi[2]; ++z) {
                    for (int y = lo[1]; y <= hi[1]; ++y) {
                        const int* row = cs + (z * ny + y) * nx;
                        const int dz = z > cc[2] ? z - cc[2] : cc[2] - z;
                        const int dy = y > cc[1] ? y - cc[1] : cc[1] - y;
                        const bool whole = (dz > dy ? dz : dy) == r;
                        const int x0 = whole ? lo[0] : cc[0] - r, x1 = whole ? hi[0] : cc[0] + r;
#pragma unroll 1
                        for (int h = 0; h < 2; ++h) {
                            const int x = h ? x1 : x0;
                            if ((h && whole) || x < 0 || x >= nx) continue;
                            const int s0 = __ldg(row + (whole ? lo[0] : x)), s1 = __ldg(row + (whole ? hi[0] : x) + 1);
                            for (int s = s0; s < s1; ++s)
                                top.insert(make_key(sq_dist<D>(xq, qp, a.pts + static_cast<size_t>(s) * d, d),
                                                    __ldg(a.orig + s) - base));
                            tests += s1 - s0;
                        }
                    }
                }
                ++rings;
                float bound;
                if (!ring_bound(qa, outside, gr, lo, hi, &bound)) break;  // the box holds every cell
                if (__float_as_uint(bound) > top.last_bits()) {
                    stopped = true;
                    break;
                }
            }
            last0 = stopped ? 0 : __ldg(cs + gr.cells);  // else the points with no cell
            last1 = stopped ? 0 : __ldg(cs + gr.cells + 1);
        } else {
            scanning = 1;
        }
        for (int s = last0; s < last1; ++s)
            top.insert(make_key(sq_dist<D>(xq, qp, a.pts + static_cast<size_t>(s) * d, d), __ldg(a.orig + s) - base));
        tests += last1 - last0;
        top.write(a.out_d, a.out_i, (static_cast<size_t>(set) * a.m + __ldg(a.qorig + t)) * a.k);
    }
    if (a.stats != nullptr) {
        unsigned long long sum = static_cast<unsigned long long>(tests), most = sum;
        unsigned long long ring_sum = rings, ring_most = rings, scans = scanning;
        for (int off = 16; off > 0; off >>= 1) {
            sum += __shfl_xor_sync(kFull, sum, off);
            const unsigned long long most_o = __shfl_xor_sync(kFull, most, off);
            most = most_o > most ? most_o : most;
            ring_sum += __shfl_xor_sync(kFull, ring_sum, off);
            const unsigned long long ring_o = __shfl_xor_sync(kFull, ring_most, off);
            ring_most = ring_o > ring_most ? ring_o : ring_most;
            scans += __shfl_xor_sync(kFull, scans, off);
        }
        if ((threadIdx.x & 31) == 0) {
            atomicAdd(a.stats, sum);
            atomicMax(a.stats + 1, most);
            atomicAdd(a.stats + 2, ring_sum);
            atomicMax(a.stats + 3, ring_most);
            atomicAdd(a.stats + 4, scans);
        }
    }
}

template <int V>
using Const = std::integral_constant<int, V>;

// f(Const<D>{}, Const<KC>{}): the kernel instance for `dim` (2, 3, or 0 for
// any other) and `k` (a register list of the next power of two up to 32, or
// KC = 0, the global list)
template <typename F>
cudaError_t by_shape(int dim, int k, F f) {
    auto by_k = [&](auto D) {
        if (k <= 1) return f(D, Const<1>{});
        if (k <= 2) return f(D, Const<2>{});
        if (k <= 4) return f(D, Const<4>{});
        if (k <= 8) return f(D, Const<8>{});
        if (k <= 16) return f(D, Const<16>{});
        if (k <= 32) return f(D, Const<32>{});
        return f(D, Const<0>{});
    };
    if (dim == 2) return by_k(Const<2>{});
    if (dim == 3) return by_k(Const<3>{});
    return by_k(Const<0>{});
}

}  // namespace

// Queries in cell order: `qpts` (m, dim) float32, `qorig` (m,) their rows,
// `qcell` (m,) their cells of the grid (nx * ny * nz for a non-finite one).
// Points in (set, cell) order: `pts` (n_sets n, dim) float32, `orig` their
// rows of the (n_sets n, dim) data, `cell_start` (n_sets (nx ny nz + 1) + 1,)
// int32 offsets. The grid: `lo0`-`lo2`, `side`, `nx`-`nz` on the first
// min(dim, 3) axes, `margin` the ring bound's shrink. 1 <= k <= n; `scratch`
// (n_sets, m, k) uint64 filled with all ones when k > 32, else unused;
// `stats` null or 5 uint64 zeroed by the caller (tests, most tests of one
// query, rings, most rings, queries that scanned every point); out_d
// (n_sets, m, k) float32 and out_i (n_sets, m, k) int32, in the queries'
// rows.
SQT_EXPORT int sqt_cross_knn(const float* qpts, const int* qorig, const int* qcell, int m, const float* pts,
                             const int* orig, const int* cell_start, int n_sets, int n, int dim, int k, double lo0,
                             double lo1, double lo2, double side, int nx, int ny, int nz, double margin,
                             long long* scratch, long long* stats, float* out_d, int* out_i, void* stream) {
    if (m <= 0 || n_sets <= 0 || n <= 0 || dim <= 0 || k <= 0 || k > n || (k > 32 && scratch == nullptr) ||
        nx < 1 || ny < 1 || nz < 1 || !(side > 0.0) || static_cast<long long>(n_sets) * n > 0x7fffffffLL ||
        (static_cast<long long>(nx) * ny * nz + 1) * n_sets >= 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Search a{qpts, qorig, qcell, m, pts, orig, cell_start, n, dim, k, (m + kThreads - 1) / kThreads,
                   reinterpret_cast<unsigned long long*>(scratch), reinterpret_cast<unsigned long long*>(stats),
                   out_d, out_i};
    const Grid gr{{lo0, lo1, lo2}, side, margin, {nx, ny, nz}, dim < 3 ? dim : 3, nx * ny * nz};
    const long long blocks = static_cast<long long>(a.q_blocks) * n_sets;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(by_shape(dim, k, [&](auto D, auto KC) {
        grid_knn_kernel<decltype(D)::value, decltype(KC)::value>
            <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, gr);
        return cudaGetLastError();
    }));
}

// The brute-force scan: queries (m, dim) float32; data (n_sets, n, dim)
// float32; 1 <= k <= n; scratch (n_sets, m, k) uint64 filled with all ones
// when k > 32, else unused; out_d (n_sets, m, k) float32 and out_i (n_sets,
// m, k) int32.
SQT_EXPORT int sqt_cross_knn_brute(const float* queries, int m, const float* data, int n_sets, int n, int dim, int k,
                                   long long* scratch, float* out_d, int* out_i, void* stream) {
    if (m <= 0 || n_sets <= 0 || n <= 0 || dim <= 0 || k <= 0 || k > n || (k > 32 && scratch == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int stage = kStagePoints;
    while (stage > 1 && static_cast<size_t>(stage) * dim * 4 > 48 * 1024) stage >>= 1;
    if (static_cast<size_t>(stage) * dim * 4 > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(stage) * dim * 4;
    const int q_blocks = (m + kThreads - 1) / kThreads;
    const long long blocks = static_cast<long long>(q_blocks) * n_sets;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    auto* sc = reinterpret_cast<unsigned long long*>(scratch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(by_shape(dim, k, [&](auto D, auto KC) {
        brute_knn_kernel<decltype(D)::value, decltype(KC)::value><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
            queries, m, data, n, dim, k, stage, q_blocks, sc, out_d, out_i);
        return cudaGetLastError();
    }));
}
