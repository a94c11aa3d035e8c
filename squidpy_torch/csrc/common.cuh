// Shared helpers for the squidpy_torch kernels: a plain C interface (loaded
// with ctypes), every entry point returning cudaGetLastError() as an int.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SQT_EXPORT extern "C" __attribute__((visibility("default")))

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the 48 KB a block gets without opting in.
template <typename Kernel>
static inline cudaError_t sqt_allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}
