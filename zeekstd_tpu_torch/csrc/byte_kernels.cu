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
// What bounds them on this card: memory, and for the histogram the rate
// of its counting. The histogram reads each byte once and writes 1 KiB
// per block; the lookup reads one byte and writes four per element. At
// the sizes they are called with (10 MiB: 3.2 and 15.7 us at 3.35 TB/s)
// a launch's fixed cost (about 1.4 us for a wave of empty blocks in a
// CUDA graph) is of the same order.
//
// What the design does about it:
// - Histogram: one CTA of 256 threads counts a block into one 256-bin
//   table of 32-bit counters per warp in shared memory, with shared
//   atomics; each thread issues its four 16-byte loads of a round before
//   it counts. Lanes that count the same byte share an address, which
//   costs no more than distinct banks (a block of one byte value counts
//   as fast as text), and one atomic per byte, about 2.9 TB/s on this
//   card, is the floor of the kernel's rate (8-bit counters per thread,
//   replicated bins and a cluster of CTAs per 32 KiB block were each
//   measured slower). The CTA writes the block's 256 ints once: no global
//   atomics, no zero fill, no second pass. The launch goes through
//   cudaLaunchKernelEx with a cluster dimension of 1, measured faster
//   than a plain launch; a failed launch returns its error.
// - Lookup: one wave of resident CTAs, each over a contiguous span of
//   the output. Lane l of a warp stores int4 number base + 32k + l, so
//   each warp store covers 512 contiguous bytes, from a 4-byte load of
//   the same index; a thread issues 16 loads before its first store (at
//   10 MiB that is all of its span, so the whole input is asked for at
//   once), and the write-once output goes out with streaming stores. The
//   table sits in shared memory.
// Data that is not 16-byte (histogram) or 4-byte (lookup) aligned takes
// byte loads in the same kernels.

#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 256;  // thread t also owns bin t
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int HIST_VECS = 4;  // 16-byte loads a thread issues before it counts
constexpr int LUT_THREADS = 256;
constexpr int LUT_UNROLL = 16;  // at 10 MiB: all of a thread's loads at once

__device__ __forceinline__ void count_word(unsigned* bins, uint32_t w) {
  atomicAdd(bins + (w & 0xFF), 1u);
  atomicAdd(bins + ((w >> 8) & 0xFF), 1u);
  atomicAdd(bins + ((w >> 16) & 0xFF), 1u);
  atomicAdd(bins + (w >> 24), 1u);
}

template <bool ALIGNED>
__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(const uint8_t* __restrict__ data, int block, int* __restrict__ out) {
  __shared__ unsigned bins[HIST_WARPS][256];
  const int t = threadIdx.x;
  for (int i = t; i < HIST_WARPS * 256; i += HIST_THREADS) (&bins[0][0])[i] = 0u;
  __syncthreads();
  unsigned* mine = bins[t >> 5];
  const uint8_t* p = data + (long long)blockIdx.x * block;
  if (ALIGNED) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    const int nv = block >> 4;
    for (int i0 = t; i0 < nv; i0 += HIST_THREADS * HIST_VECS) {
      uint4 x[HIST_VECS];
#pragma unroll
      for (int k = 0; k < HIST_VECS; ++k) {
        if (i0 + k * HIST_THREADS < nv) x[k] = v[i0 + k * HIST_THREADS];
      }
#pragma unroll
      for (int k = 0; k < HIST_VECS; ++k) {
        if (i0 + k * HIST_THREADS < nv) {
          count_word(mine, x[k].x);
          count_word(mine, x[k].y);
          count_word(mine, x[k].z);
          count_word(mine, x[k].w);
        }
      }
    }
  } else {
    for (int i = t; i < block; i += HIST_THREADS) atomicAdd(mine + p[i], 1u);
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < HIST_WARPS; ++w) sum += (int)bins[w][t];
  out[(long long)blockIdx.x * 256 + t] = sum;
}

template <bool ALIGNED>
__global__ void __launch_bounds__(LUT_THREADS)
lookup_kernel(const uint8_t* __restrict__ data, long long quads, long long span,
              const int* __restrict__ table, int4* __restrict__ out) {
  __shared__ int tab[256];
  tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const long long begin = (long long)blockIdx.x * span;
  const long long end = min(begin + span, quads);
  const uint32_t* d32 = reinterpret_cast<const uint32_t*>(data);
  for (long long i0 = begin + threadIdx.x; i0 < end; i0 += LUT_THREADS * LUT_UNROLL) {
    uint32_t w[LUT_UNROLL];
#pragma unroll
    for (int k = 0; k < LUT_UNROLL; ++k) {
      const long long i = i0 + k * LUT_THREADS;
      if (i < end) {
        if (ALIGNED) {
          w[k] = d32[i];
        } else {
          const uint8_t* b = data + 4 * i;
          w[k] = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < LUT_UNROLL; ++k) {
      const long long i = i0 + k * LUT_THREADS;
      if (i < end) {
        __stcs(out + i, make_int4(tab[w[k] & 0xFF], tab[(w[k] >> 8) & 0xFF],
                                  tab[(w[k] >> 16) & 0xFF], tab[w[k] >> 24]));
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(1, sms);
}

// CTAs of the lookup resident at once on the whole card (one wave).
int lookup_wave() {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lookup_kernel<true>, LUT_THREADS, 0);
  return sm_count() * max(1, per_sm);
}

}  // namespace

// n % block == 0 and block % 128 == 0 (the wrapper checks): one CTA a
// block.
extern "C" int zk_byte_histogram_launch(const void* data, long long n, int block, void* out,
                                        void* stream) {
  if (n <= 0 || block <= 0) return zk_last_error();
  const bool aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  auto kernel = aligned ? histogram_kernel<true> : histogram_kernel<false>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n / block));
  cfg.blockDim = dim3(HIST_THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)data, block, (int*)out);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return zk_last_error();
}

// n % 4 == 0 (the wrapper asks n % 1024 == 0); table holds 256 int32.
extern "C" int zk_table_lookup_launch(const void* data, long long n, const void* table,
                                      void* out, void* stream) {
  if (n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    static const int wave = lookup_wave();
    const long long quads = n / 4;
    long long span = (quads + wave - 1) / wave;
    span = span < 32 ? 32 : (span + 31) / 32 * 32;
    const unsigned grid = (unsigned)((quads + span - 1) / span);
    const bool aligned = (reinterpret_cast<uintptr_t>(data) & 3) == 0;
    auto kernel = aligned ? lookup_kernel<true> : lookup_kernel<false>;
    kernel<<<grid, LUT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, quads, span, (const int*)table, (int4*)out);
  }
  return zk_last_error();
}
