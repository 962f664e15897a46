// Tile-local byte kernels for Hopper, behind two launchers:
//
//   zk_byte_histogram_launch  replaces byte_histogram_pallas of
//       zeekstd_tpu/ops/pallas_kernels.py (_hist_kernel, the pallas_call
//       at pallas_kernels.py:68): per-block 256-bin byte histograms,
//       uint8[n] -> int32[n / block, 256].
//   zk_table_lookup_launch    replaces table_lookup_pallas (_lut_kernel,
//       the pallas_call at pallas_kernels.py:111): out[i] = table[data[i]],
//       uint8[n], int32[256] -> int32[n].
//
// The plain versions are ops/byte_kernels.py::histogram_plain and
// ::lookup_plain.
//
// What bounds them on this card: memory. The histogram reads each byte
// once and writes 1 KiB per block; the lookup reads one byte and writes
// four per element. The TPU kernels worked around a missing dynamic
// gather (one compare per bin, lane shuffles of the table halves); here
// shared memory takes both gathers directly.
//
// What the design does about it: 16-byte loads (and, for the lookup,
// 16-byte stores) per thread. The histogram gives each warp its own 256
// bins in shared memory, so skewed data (long runs of one byte) contends
// within a warp only; the warps' bins are summed at the end. The lookup
// keeps the table in shared memory and walks the data grid-stride.

#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 256;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int LUT_THREADS = 256;

__device__ __forceinline__ void count4(unsigned* h, uint32_t w) {
  atomicAdd(&h[w & 0xFF], 1u);
  atomicAdd(&h[(w >> 8) & 0xFF], 1u);
  atomicAdd(&h[(w >> 16) & 0xFF], 1u);
  atomicAdd(&h[w >> 24], 1u);
}

__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(const uint8_t* __restrict__ data, int block, int* __restrict__ out) {
  __shared__ unsigned bins[HIST_WARPS][256];
  const int t = threadIdx.x;
  for (int i = t; i < HIST_WARPS * 256; i += HIST_THREADS) (&bins[0][0])[i] = 0u;
  __syncthreads();
  unsigned* h = bins[t / 32];
  const uint8_t* p = data + (long long)blockIdx.x * block;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    for (int i = t; i < block / 16; i += HIST_THREADS) {
      const uint4 x = v[i];
      count4(h, x.x);
      count4(h, x.y);
      count4(h, x.z);
      count4(h, x.w);
    }
  } else {
    for (int i = t; i < block; i += HIST_THREADS) atomicAdd(&h[p[i]], 1u);
  }
  __syncthreads();
  unsigned s = 0;
  for (int w = 0; w < HIST_WARPS; ++w) s += bins[w][t];
  out[(long long)blockIdx.x * 256 + t] = (int)s;
}

__global__ void __launch_bounds__(LUT_THREADS)
lookup_kernel(const uint8_t* __restrict__ data, long long n, const int* __restrict__ table,
              int* __restrict__ out) {
  __shared__ int tab[256];
  tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * LUT_THREADS;
  const long long first = (long long)blockIdx.x * LUT_THREADS + threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(data) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(data);
    int4* o = reinterpret_cast<int4*>(out);
    for (long long i = first; i < n / 16; i += stride) {
      const uint4 x = v[i];
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[i * 4 + k] = make_int4(tab[w[k] & 0xFF], tab[(w[k] >> 8) & 0xFF],
                                 tab[(w[k] >> 16) & 0xFF], tab[w[k] >> 24]);
      }
    }
  } else {
    for (long long i = first; i < n; i += stride) out[i] = tab[data[i]];
  }
}

}  // namespace

extern "C" int zk_byte_histogram_launch(const void* data, long long n, int block, void* out,
                                        void* stream) {
  if (n > 0 && block > 0) {
    histogram_kernel<<<(unsigned)(n / block), HIST_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, block, (int*)out);
  }
  return zk_last_error();
}

extern "C" int zk_table_lookup_launch(const void* data, long long n, const void* table,
                                      void* out, void* stream) {
  if (n > 0) {
    const long long vecs = (n + 15) / 16;
    const long long want = (vecs + LUT_THREADS - 1) / LUT_THREADS;
    const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
    lookup_kernel<<<grid, LUT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, n, (const int*)table, (int*)out);
  }
  return zk_last_error();
}
