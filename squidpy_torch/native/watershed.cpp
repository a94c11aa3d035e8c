// Native segmentation kernels: priority-flood watershed and union-find label
// merging for tiled segmentation reconciliation (copy of
// squidpy_tpu/native/watershed.cpp, built with the same g++ flags).
//
// The reference delegates watershed to skimage (Cython) and reconciles
// chunked labels through dask-image's delayed connected-components relabel
// (the reference's im/_segment.py:105-206). Both algorithms are
// queue/pointer-chasing host code, exposed through ctypes.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// Priority-flood watershed on a 2D image.
//   image:   (h*w) float32 "elevation" (flood ascends)
//   markers: (h*w) int32 seed labels (>0), 0 elsewhere
//   mask:    (h*w) uint8; 0 pixels are never labeled (may be nullptr)
//   out:     (h*w) int32 result labels
// 4-connectivity, FIFO tie-break on equal elevation — matches the classic
// Beucher/Meyer algorithm skimage implements.
void watershed(const float* image, const int32_t* markers, const uint8_t* mask,
               int64_t h, int64_t w, int32_t* out) {
    const int64_t n = h * w;
    struct Item {
        float elevation;
        int64_t order;
        int64_t index;
    };
    struct Cmp {
        bool operator()(const Item& a, const Item& b) const {
            if (a.elevation != b.elevation) return a.elevation > b.elevation;
            return a.order > b.order;  // FIFO among equal elevations
        }
    };
    std::priority_queue<Item, std::vector<Item>, Cmp> pq;

    std::memset(out, 0, sizeof(int32_t) * n);
    std::vector<uint8_t> queued(n, 0);
    int64_t order = 0;

    for (int64_t i = 0; i < n; ++i) {
        if (markers[i] > 0 && (!mask || mask[i])) {
            out[i] = markers[i];
            pq.push({image[i], order++, i});
            queued[i] = 1;
        }
    }

    const int64_t dr[4] = {-1, 1, 0, 0};
    const int64_t dc[4] = {0, 0, -1, 1};

    while (!pq.empty()) {
        Item it = pq.top();
        pq.pop();
        const int64_t r = it.index / w;
        const int64_t c = it.index % w;
        const int32_t lab = out[it.index];
        for (int k = 0; k < 4; ++k) {
            const int64_t rr = r + dr[k];
            const int64_t cc = c + dc[k];
            if (rr < 0 || rr >= h || cc < 0 || cc >= w) continue;
            const int64_t j = rr * w + cc;
            if (queued[j] || (mask && !mask[j])) continue;
            out[j] = lab;
            queued[j] = 1;
            // flood never descends: neighbors enter at max(own, current) level
            const float lvl = image[j] > it.elevation ? image[j] : it.elevation;
            pq.push({lvl, order++, j});
        }
    }
}

// Union-find over label equivalence pairs, then in-place relabeling to
// consecutive ids (1..k) preserving first-occurrence order of the roots.
//   labels:  (n) int64 label array, 0 = background (left untouched)
//   pairs:   (n_pairs*2) int64 equivalent label pairs
// Returns the number of distinct labels after merging.
static int64_t uf_find(std::vector<int64_t>& parent, int64_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

int64_t relabel_merge(int64_t* labels, int64_t n, const int64_t* pairs, int64_t n_pairs) {
    int64_t max_label = 0;
    for (int64_t i = 0; i < n; ++i)
        if (labels[i] > max_label) max_label = labels[i];
    for (int64_t p = 0; p < n_pairs; ++p) {
        if (pairs[2 * p] > max_label) max_label = pairs[2 * p];
        if (pairs[2 * p + 1] > max_label) max_label = pairs[2 * p + 1];
    }

    std::vector<int64_t> parent(max_label + 1);
    for (int64_t i = 0; i <= max_label; ++i) parent[i] = i;

    for (int64_t p = 0; p < n_pairs; ++p) {
        const int64_t a = uf_find(parent, pairs[2 * p]);
        const int64_t b = uf_find(parent, pairs[2 * p + 1]);
        if (a != b) parent[b < a ? a : b] = b < a ? b : a;  // smaller id wins
    }

    std::vector<int64_t> remap(max_label + 1, -1);
    remap[0] = 0;
    int64_t next_id = 1;
    for (int64_t i = 0; i < n; ++i) {
        if (labels[i] == 0) continue;
        const int64_t root = uf_find(parent, labels[i]);
        if (remap[root] < 0) remap[root] = next_id++;
        labels[i] = remap[root];
    }
    return next_id - 1;
}

}  // extern "C"
