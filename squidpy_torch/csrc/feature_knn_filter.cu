// K12's filter route (its code and its proof are in csrc/feature_knn.cu),
// built in an nvcc process of its own beside the exact route's.
#define SQT_FEATURE_KNN_FILTER
#include "feature_knn.cu"
