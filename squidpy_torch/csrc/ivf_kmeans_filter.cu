// K14's filter route for the nearest entry (its design is in
// csrc/ivf_kmeans.cu, its rule and proof in csrc/knn_filter.cuh), built in an
// nvcc process of its own beside the exact route's.
#define SQT_IVF_KMEANS_FILTER
#include "ivf_kmeans.cu"
