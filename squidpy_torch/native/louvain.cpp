// CSR Louvain and Leiden community detection (modularity optimization with
// resolution), copied from squidpy_tpu/native/louvain.cpp.
//
// Native counterpart of squidpy's leidenalg/scanpy clustering backend
// (squidpy's gr/_niche.py delegates to scanpy.tl.leiden -> leidenalg's C
// core). networkx's pure-Python Louvain is
// minutes-to-hours at 100k-1M cells; this is the same modularity-optimization
// family with O(nnz) local-move passes and graph aggregation, deterministic
// for a given seed.
//
// Input: symmetric CSR (each undirected edge stored in both rows), no
// self-loops required. Output: community id per node (compact, unordered —
// the Python wrapper renumbers largest-first).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
    uint64_t next() {
        s ^= s << 13;
        s ^= s >> 7;
        s ^= s << 17;
        return s;
    }
};

struct Level {
    std::vector<int64_t> iptr;
    std::vector<int32_t> idx;
    std::vector<double> w;
    std::vector<double> self_w;  // self-loop weight per node (internal edges)
};

void degrees(const Level& g, std::vector<double>& k, double& m2) {
    const int64_t n = static_cast<int64_t>(g.iptr.size()) - 1;
    k.assign(n, 0.0);
    m2 = 0.0;
    for (int64_t u = 0; u < n; ++u) {
        double s = 2.0 * g.self_w[u];  // self-loops count twice
        for (int64_t e = g.iptr[u]; e < g.iptr[u + 1]; ++e) s += g.w[e];
        k[u] = s;
        m2 += s;
    }
}

// One local-move level: passes until stable. Starts from `init` communities
// (compact ids < n) when given, singletons otherwise. Returns number of
// communities; fills node->community (compact ids); sets *moved_any if any
// node changed community relative to the start partition.
int64_t local_move(const Level& g, double resolution, Rng& rng,
                   std::vector<int32_t>& comm_out,
                   const int32_t* init = nullptr, bool* moved_any = nullptr) {
    const int64_t n = static_cast<int64_t>(g.iptr.size()) - 1;
    std::vector<double> k;  // weighted degree
    double m2;              // 2m
    degrees(g, k, m2);
    if (moved_any) *moved_any = false;
    if (m2 <= 0.0) {
        std::fill(comm_out.begin(), comm_out.end(), 0);
        return n > 0 ? 1 : 0;
    }

    std::vector<int32_t> comm(n);
    if (init) {
        std::copy(init, init + n, comm.begin());
    } else {
        std::iota(comm.begin(), comm.end(), 0);
    }
    std::vector<double> tot(n, 0.0);  // per-community Σ degrees
    for (int64_t u = 0; u < n; ++u) tot[comm[u]] += k[u];

    std::vector<double> neigh_w(n, 0.0);  // scratch: weight to each community
    std::vector<int32_t> touched;
    touched.reserve(64);

    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);

    bool moved = true;
    for (int pass = 0; pass < 64 && moved; ++pass) {
        moved = false;
        // Fisher-Yates shuffle for pass-dependent but seed-deterministic order
        for (int64_t i = n - 1; i > 0; --i) {
            int64_t j = static_cast<int64_t>(rng.next() % static_cast<uint64_t>(i + 1));
            std::swap(order[i], order[j]);
        }
        for (int64_t oi = 0; oi < n; ++oi) {
            const int64_t u = order[oi];
            const int32_t cu = comm[u];
            touched.clear();
            for (int64_t e = g.iptr[u]; e < g.iptr[u + 1]; ++e) {
                const int32_t v = g.idx[e];
                if (v == static_cast<int32_t>(u)) continue;
                const int32_t cv = comm[v];
                if (neigh_w[cv] == 0.0) touched.push_back(cv);
                neigh_w[cv] += g.w[e];
            }
            // remove u from its community
            tot[cu] -= k[u];
            // gain of joining community c: k_{u,c} - γ·Σtot_c·k_u/(2m)
            double best_gain = neigh_w[cu] - resolution * tot[cu] * k[u] / m2;
            int32_t best = cu;
            for (int32_t c : touched) {
                const double gain = neigh_w[c] - resolution * tot[c] * k[u] / m2;
                if (gain > best_gain + 1e-12 ||
                    (gain > best_gain - 1e-12 && c < best)) {
                    best_gain = gain;
                    best = c;
                }
            }
            tot[best] += k[u];
            if (best != cu) {
                comm[u] = best;
                moved = true;
                if (moved_any) *moved_any = true;
            }
            for (int32_t c : touched) neigh_w[c] = 0.0;
        }
    }

    // compact community ids
    std::vector<int32_t> remap(n, -1);
    int32_t n_comm = 0;
    for (int64_t u = 0; u < n; ++u) {
        if (remap[comm[u]] < 0) remap[comm[u]] = n_comm++;
        comm_out[u] = remap[comm[u]];
    }
    return n_comm;
}

// Aggregate communities into a coarser graph.
Level aggregate(const Level& g, const std::vector<int32_t>& comm, int64_t n_comm) {
    const int64_t n = static_cast<int64_t>(g.iptr.size()) - 1;
    Level out;
    out.self_w.assign(n_comm, 0.0);

    // bucket nodes by community for cache-friendly accumulation
    std::vector<int64_t> counts(n_comm + 1, 0);
    for (int64_t u = 0; u < n; ++u) counts[comm[u] + 1]++;
    for (int64_t c = 0; c < n_comm; ++c) counts[c + 1] += counts[c];
    std::vector<int64_t> members(n);
    {
        std::vector<int64_t> fill(counts.begin(), counts.end() - 1);
        for (int64_t u = 0; u < n; ++u) members[fill[comm[u]]++] = u;
    }

    out.iptr.assign(n_comm + 1, 0);
    std::vector<double> acc(n_comm, 0.0);
    std::vector<int32_t> touched;
    touched.reserve(256);
    // two sweeps: size then fill
    std::vector<std::pair<int32_t, double>> edges;  // (dst, w) per community row
    edges.reserve(1024);
    for (int64_t c = 0; c < n_comm; ++c) {
        touched.clear();
        double self_acc = 0.0;
        for (int64_t mi = counts[c]; mi < counts[c + 1]; ++mi) {
            const int64_t u = members[mi];
            self_acc += g.self_w[u];
            for (int64_t e = g.iptr[u]; e < g.iptr[u + 1]; ++e) {
                const int32_t v = g.idx[e];
                if (v == static_cast<int32_t>(u)) {  // stray diagonal entry
                    self_acc += 0.5 * g.w[e];
                    continue;
                }
                const int32_t cv = comm[v];
                if (cv == static_cast<int32_t>(c)) {
                    self_acc += 0.5 * g.w[e];  // intra edge appears twice in CSR
                } else {
                    if (acc[cv] == 0.0) touched.push_back(cv);
                    acc[cv] += g.w[e];
                }
            }
        }
        out.self_w[c] = self_acc;
        std::sort(touched.begin(), touched.end());
        for (int32_t cv : touched) {
            out.idx.push_back(cv);
            out.w.push_back(acc[cv]);
            acc[cv] = 0.0;
        }
        out.iptr[c + 1] = static_cast<int64_t>(out.idx.size());
    }
    return out;
}

// Queue-based "fast local move" (Traag et al. 2019, §A.2): visit nodes from
// a FIFO; when a node moves, re-enqueue only its neighbors outside the new
// community. Asymptotically the same optimum class as the sweep version but
// ~pass-count× faster on converged regions — this is why Leiden can run
// FASTER than Louvain despite doing more work per level. Used by leiden_csr
// only (louvain_csr keeps the sweep to preserve its established outputs).
int64_t local_move_fast(const Level& g, double resolution, Rng& rng,
                        std::vector<int32_t>& comm_out,
                        const int32_t* init, bool* moved_any) {
    const int64_t n = static_cast<int64_t>(g.iptr.size()) - 1;
    std::vector<double> k;
    double m2;
    degrees(g, k, m2);
    if (moved_any) *moved_any = false;
    if (m2 <= 0.0) {
        std::fill(comm_out.begin(), comm_out.end(), 0);
        return n > 0 ? 1 : 0;
    }

    std::vector<int32_t> comm(n);
    if (init) {
        std::copy(init, init + n, comm.begin());
    } else {
        std::iota(comm.begin(), comm.end(), 0);
    }
    std::vector<double> tot(n, 0.0);
    for (int64_t u = 0; u < n; ++u) tot[comm[u]] += k[u];

    // FIFO ring of capacity n (in_queue keeps each node at most once)
    std::vector<int64_t> ring(n);
    std::iota(ring.begin(), ring.end(), 0);
    for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(rng.next() % static_cast<uint64_t>(i + 1));
        std::swap(ring[i], ring[j]);
    }
    std::vector<char> in_queue(n, 1);
    int64_t head = 0, count = n;

    std::vector<double> neigh_w(n, 0.0);
    std::vector<int32_t> touched;
    touched.reserve(64);

    while (count > 0) {
        const int64_t u = ring[head];
        head = (head + 1) % n;
        --count;
        in_queue[u] = 0;
        const int32_t cu = comm[u];
        touched.clear();
        for (int64_t e = g.iptr[u]; e < g.iptr[u + 1]; ++e) {
            const int32_t v = g.idx[e];
            if (v == static_cast<int32_t>(u)) continue;
            const int32_t cv = comm[v];
            if (neigh_w[cv] == 0.0) touched.push_back(cv);
            neigh_w[cv] += g.w[e];
        }
        tot[cu] -= k[u];
        double best_gain = neigh_w[cu] - resolution * tot[cu] * k[u] / m2;
        int32_t best = cu;
        for (int32_t c : touched) {
            const double gain = neigh_w[c] - resolution * tot[c] * k[u] / m2;
            if (gain > best_gain + 1e-12 ||
                (gain > best_gain - 1e-12 && c < best)) {
                best_gain = gain;
                best = c;
            }
        }
        tot[best] += k[u];
        if (best != cu) {
            comm[u] = best;
            if (moved_any) *moved_any = true;
            for (int64_t e = g.iptr[u]; e < g.iptr[u + 1]; ++e) {
                const int32_t v = g.idx[e];
                if (comm[v] != best && !in_queue[v]) {
                    ring[(head + count) % n] = v;
                    ++count;
                    in_queue[v] = 1;
                }
            }
        }
        for (int32_t c : touched) neigh_w[c] = 0.0;
    }

    std::vector<int32_t> remap(n, -1);
    int32_t n_comm = 0;
    for (int64_t u = 0; u < n; ++u) {
        if (remap[comm[u]] < 0) remap[comm[u]] = n_comm++;
        comm_out[u] = remap[comm[u]];
    }
    return n_comm;
}

// Leiden refinement (Traag, Waltman, van Eck 2019, §Leiden algorithm): inside
// each local-move community, re-partition from singletons by greedy merges
// along edges, gated on the node being well-connected to its community.
// Merges only follow intra-community edges, so every refined subcommunity is
// internally CONNECTED by construction — the property Louvain lacks.
// Deterministic greedy (θ→0 limit of the paper's randomized selection).
// Fills `ref` (compact subcommunity per node) and `ref2comm` (coarse
// community of each subcommunity); returns the subcommunity count.
int64_t refine(const Level& g, const std::vector<int32_t>& comm,
               double resolution, Rng& rng,
               std::vector<int32_t>& ref, std::vector<int32_t>& ref2comm) {
    const int64_t n = static_cast<int64_t>(g.iptr.size()) - 1;
    std::vector<double> k;
    double m2;
    degrees(g, k, m2);
    ref.assign(n, 0);
    std::iota(ref.begin(), ref.end(), 0);
    if (m2 <= 0.0) {
        ref2comm = comm;
        return n;
    }

    std::vector<double> tot_ref(k);     // Σ degrees per subcommunity
    std::vector<int64_t> csize(n, 1);   // node count per subcommunity
    std::vector<double> tot_comm(n, 0.0);
    for (int64_t u = 0; u < n; ++u) tot_comm[comm[u]] += k[u];

    std::vector<double> neigh_w(n, 0.0);
    std::vector<int32_t> touched;
    touched.reserve(64);
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(rng.next() % static_cast<uint64_t>(i + 1));
        std::swap(order[i], order[j]);
    }

    for (int64_t oi = 0; oi < n; ++oi) {
        const int64_t u = order[oi];
        if (csize[ref[u]] != 1) continue;  // only singletons merge (paper)
        const int32_t cu = comm[u];
        // weight from u to the rest of its coarse community (gate) and to
        // each refined subcommunity within it (candidates)
        double e_to_comm = 0.0;
        touched.clear();
        for (int64_t e = g.iptr[u]; e < g.iptr[u + 1]; ++e) {
            const int32_t v = g.idx[e];
            if (v == static_cast<int32_t>(u) || comm[v] != cu) continue;
            e_to_comm += g.w[e];
            const int32_t rv = ref[v];
            if (rv == ref[u]) continue;
            if (neigh_w[rv] == 0.0) touched.push_back(rv);
            neigh_w[rv] += g.w[e];
        }
        // well-connectedness: k_{u,C∖u} ≥ γ·k_u·(k_C−k_u)/2m
        const bool well =
            e_to_comm >= resolution * k[u] * (tot_comm[cu] - k[u]) / m2 - 1e-12;
        if (well) {
            double best_gain = 1e-12;  // staying singleton has gain 0
            int32_t best = -1;
            for (int32_t c : touched) {
                const double gain = neigh_w[c] - resolution * tot_ref[c] * k[u] / m2;
                if (gain > best_gain + 1e-12 ||
                    (best >= 0 && gain > best_gain - 1e-12 && c < best)) {
                    best_gain = gain;
                    best = c;
                }
            }
            if (best >= 0) {
                tot_ref[ref[u]] = 0.0;
                csize[ref[u]] = 0;
                ref[u] = best;
                tot_ref[best] += k[u];
                csize[best] += 1;
            }
        }
        for (int32_t c : touched) neigh_w[c] = 0.0;
    }

    std::vector<int32_t> remap(n, -1);
    int32_t n_ref = 0;
    ref2comm.clear();
    for (int64_t u = 0; u < n; ++u) {
        if (remap[ref[u]] < 0) {
            remap[ref[u]] = n_ref++;
            ref2comm.push_back(comm[u]);
        }
        ref[u] = remap[ref[u]];
    }
    return n_ref;
}

// Split communities that are internally disconnected on the ORIGINAL graph
// into their connected components. For γ > 0 this strictly increases
// modularity (the intra-edge term is unchanged; Σ tot² decreases), so it is
// a pure improvement pass as well as the connectivity guarantee.
int64_t split_disconnected(const int64_t* indptr, const int32_t* indices,
                           int64_t n, std::vector<int32_t>& labels) {
    std::vector<int32_t> out(n, -1);
    std::vector<int64_t> stack;
    stack.reserve(1024);
    int32_t next_id = 0;
    for (int64_t s = 0; s < n; ++s) {
        if (out[s] >= 0) continue;
        const int32_t lab = labels[s];
        const int32_t cid = next_id++;
        out[s] = cid;
        stack.push_back(s);
        while (!stack.empty()) {
            const int64_t u = stack.back();
            stack.pop_back();
            for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
                const int32_t v = indices[e];
                if (out[v] < 0 && labels[v] == lab) {
                    out[v] = cid;
                    stack.push_back(v);
                }
            }
        }
    }
    labels.swap(out);
    return next_id;
}

}  // namespace

// Renumber compact partition labels by first occurrence (canonical form for
// partition-equality checks across iterations).
void canonicalize(std::vector<int32_t>& labels) {
    std::vector<int32_t> remap(labels.size(), -1);
    int32_t next = 0;
    for (auto& l : labels) {
        if (remap[l] < 0) remap[l] = next++;
        l = remap[l];
    }
}

extern "C" int64_t leiden_csr(const int64_t* indptr, const int32_t* indices,
                              const double* weights, int64_t n,
                              double resolution, uint64_t seed,
                              int32_t max_levels, int32_t n_iterations,
                              int32_t* labels_out) {
    if (n <= 0) return 0;
    Rng rng(seed);
    std::vector<int32_t> labels;  // partition over original nodes
    int64_t n_comm = n;

    // iterate the full (local-move → refine → aggregate) procedure from the
    // previous partition until it stops changing — the paper's outer loop;
    // local moves never decrease modularity, so iterations are monotone.
    // n_iterations <= 0 means iterate to convergence (leidenalg semantics).
    const int32_t max_iters = n_iterations > 0 ? n_iterations : 32;
    for (int32_t iter = 0; iter < max_iters; ++iter) {
        Level g;
        g.iptr.assign(indptr, indptr + n + 1);
        g.idx.assign(indices, indices + indptr[n]);
        g.w.assign(weights, weights + indptr[n]);
        g.self_w.assign(n, 0.0);

        std::vector<int32_t> node2cur(n);  // original node -> current node
        std::iota(node2cur.begin(), node2cur.end(), 0);
        std::vector<int32_t> init(labels);  // seed partition (empty on iter 0)
        std::vector<int32_t> comm;
        for (int32_t level = 0; level < max_levels; ++level) {
            const int64_t n_cur = static_cast<int64_t>(g.iptr.size()) - 1;
            comm.assign(n_cur, 0);
            bool moved = false;
            local_move_fast(g, resolution, rng, comm,
                            init.empty() ? nullptr : init.data(), &moved);
            if (!init.empty() && !moved) break;  // stable at this level
            std::vector<int32_t> ref, ref2comm;
            const int64_t n_ref = refine(g, comm, resolution, rng, ref, ref2comm);
            if (n_ref == n_cur) break;  // aggregation would be isomorphic
            // next level starts from the CURRENT communities, not singletons
            for (int64_t u = 0; u < n; ++u) node2cur[u] = ref[node2cur[u]];
            g = aggregate(g, ref, n_ref);
            init.assign(ref2comm.begin(), ref2comm.end());
        }

        std::vector<int32_t> new_labels(n);
        for (int64_t u = 0; u < n; ++u) new_labels[u] = comm[node2cur[u]];
        n_comm = split_disconnected(indptr, indices, n, new_labels);
        canonicalize(new_labels);
        if (iter > 0 && new_labels == labels) break;  // converged
        labels.swap(new_labels);
    }
    std::copy(labels.begin(), labels.end(), labels_out);
    return n_comm;
}

extern "C" int64_t louvain_csr(const int64_t* indptr, const int32_t* indices,
                               const double* weights, int64_t n,
                               double resolution, uint64_t seed,
                               int32_t max_levels, int32_t* labels_out) {
    if (n <= 0) return 0;
    Level g;
    g.iptr.assign(indptr, indptr + n + 1);
    g.idx.assign(indices, indices + indptr[n]);
    g.w.assign(weights, weights + indptr[n]);
    g.self_w.assign(n, 0.0);

    std::vector<int32_t> node2final(n);
    std::iota(node2final.begin(), node2final.end(), 0);
    Rng rng(seed);

    int64_t n_comm = n;
    for (int32_t level = 0; level < max_levels; ++level) {
        const int64_t n_cur = static_cast<int64_t>(g.iptr.size()) - 1;
        std::vector<int32_t> comm(n_cur);
        const int64_t n_new = local_move(g, resolution, rng, comm);
        for (int64_t u = 0; u < n; ++u) node2final[u] = comm[node2final[u]];
        if (n_new == n_cur) {  // no merge happened: converged
            n_comm = n_new;
            break;
        }
        n_comm = n_new;
        g = aggregate(g, comm, n_new);
    }
    std::copy(node2final.begin(), node2final.end(), labels_out);
    return n_comm;
}
