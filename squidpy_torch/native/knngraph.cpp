// Symmetrized kNN adjacency from an (n, k) neighbor-index table (copied from
// squidpy_tpu/native/knngraph.cpp).
//
// The niche clustering graphs (models/clustering.knn_graph) need
// A = max(A_knn, A_knn^T) as CSR. scipy's coo->csr conversion plus
// .maximum(adj.T) measured 13.7 s at 1M x 15 on one host core; this is
// the O(nnz) counting-sort construction (~1 s): degree count -> bucket fill
// (both edge directions) -> per-row sort+unique, compacted in place.
//
// Reference semantics: scanpy pp.neighbors builds a symmetric connectivity
// graph for leiden (squidpy's gr/_niche.py); the
// repo's graphs are binary (weight 1 per undirected edge), matching the
// previous scipy maximum() path bit for bit.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// idx: (n, k) int32 neighbor table (entries outside [0, n) or self loops are
// ignored). indptr: out, size n+1. indices_out: out, capacity 2*n*k.
// Returns the final nnz (deduplicated), or -1 on bad arguments.
int64_t symmetrize_knn(const int32_t* idx, int64_t n, int64_t k,
                       int64_t* indptr, int32_t* indices_out) {
  if (n < 0 || k < 0) return -1;
  std::vector<int64_t> deg(static_cast<size_t>(n), 0);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = idx + i * k;
    for (int64_t t = 0; t < k; ++t) {
      int64_t j = row[t];
      if (j < 0 || j >= n || j == i) continue;
      ++deg[i];
      ++deg[j];
    }
  }
  indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] = indptr[i] + deg[i];

  std::vector<int64_t> pos(indptr, indptr + n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = idx + i * k;
    for (int64_t t = 0; t < k; ++t) {
      int64_t j = row[t];
      if (j < 0 || j >= n || j == i) continue;
      indices_out[pos[i]++] = static_cast<int32_t>(j);
      indices_out[pos[j]++] = static_cast<int32_t>(i);
    }
  }

  // per-row sort + unique, compacting in place (write pos <= read pos)
  int64_t w = 0;
  int64_t row_begin = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t row_end = indptr[i + 1];
    std::sort(indices_out + row_begin, indices_out + row_end);
    int32_t* new_end =
        std::unique(indices_out + row_begin, indices_out + row_end);
    int64_t m = new_end - (indices_out + row_begin);
    if (w != row_begin)
      std::copy(indices_out + row_begin, indices_out + row_begin + m,
                indices_out + w);
    w += m;
    row_begin = row_end;
    indptr[i + 1] = w;
  }
  return w;
}

}  // extern "C"
