// Shared helpers of the port's CUDA kernels (plain C interface, built by
// _build.py with nvcc for sm_90a and loaded through ctypes).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// 31 - clz(max(x, 1)): the reference kernels' highbit.
__device__ __forceinline__ int zk_highbit(int x) { return 31 - __clz(x > 1 ? x : 1); }

// A meta row index outside [0, n) reads row n - 1 (the fused decoders).
__device__ __forceinline__ int zk_clamp_row(int i, int n) {
  return (unsigned)i < (unsigned)n ? i : n - 1;
}

// The low min(n, 31) bits (the fused decoders' bit reads).
__device__ __forceinline__ uint32_t zk_low_mask(int n) { return (1u << (n < 31 ? n : 31)) - 1u; }

// Every launcher returns this, so the wrapper can raise when a launch was
// refused (too much shared memory, a bad configuration) before it runs.
static inline int zk_last_error() { return (int)cudaGetLastError(); }
