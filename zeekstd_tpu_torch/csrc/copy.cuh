// Warp-wide copies of the serial sequence executor (exec_kernel.cu): one
// warp owns a frame's output row and its 32 lanes split every literal run
// and every match copy.
#pragma once

#include "common.cuh"

namespace {

constexpr int LANES = 32;

// Literals one int32 per byte (the serial executor's contract). Reads
// outside the pool return 0.
struct WideLits {
  const int* p;
  long long n;
  __device__ __forceinline__ uint8_t operator()(long long i) const {
    return (i >= 0 && i < n) ? (uint8_t)p[i] : 0;
  }
};

template <typename Lits>
__device__ __forceinline__ void copy_lits(uint8_t* out, int pos, const Lits& lit,
                                          int litcur, int n) {
  for (int k = threadIdx.x % LANES; k < n; k += LANES) {
    out[pos + k] = lit((long long)litcur + k);
  }
}

// out[mpos + k] = out[mpos - off + (k mod off)] for k < n: every source
// byte precedes mpos, so the lanes never read a byte this copy writes.
// A source before the row's start reads 0.
__device__ __forceinline__ void copy_match(uint8_t* out, int mpos, int off, int n) {
  const int src = mpos - off;
  for (int k = threadIdx.x % LANES; k < n; k += LANES) {
    const int i = src + (k < off ? k : k % off);
    out[mpos + k] = i >= 0 ? out[i] : 0;
  }
}

}  // namespace
