// K15's filter route (its design is in csrc/ivf_search.cu, its rule and
// proof in csrc/knn_filter.cuh), built in an nvcc process of its own beside
// the exact route's.
#define SQT_IVF_SEARCH_FILTER
#include "ivf_search.cu"
