// Chunked greedy reachability for Hopper: the two kernels of the parse's
// anchor pass, behind two launchers.
//
//   zk_reach_tables_launch  replaces chunk_pointer_tables of
//       zeekstd_tpu/ops/pallas_kernels.py (_ptr_tables_kernel, the
//       pallas_call at pallas_kernels.py:152): per 128-position chunk, the
//       pointer tables f^(2^k), k < 8, of the step map lane + step.
//   zk_reach_mark_launch    replaces chunk_mark (_mark_kernel, the
//       pallas_call at pallas_kernels.py:181): marks the positions a chain
//       visits by binary lifting from the chunk's entry phase.
//
// A table value v >= 128 means "left the chunk, entering the next one at
// phase v - 128"; such values stay put, and a lookup reads lane
// clip(v, 0, 127), exactly as the TPU kernels do. The plain versions are
// ops/reach_kernel.py::tables_plain and ::mark_plain.
//
// What bounds it on this card: memory. Tables reads 4 bytes and writes
// 32 bytes per position, mark reads 36 and writes 4; the arithmetic is a
// few integer operations per byte moved.
//
// What the design does about it: one 128-thread row of the block per
// chunk, four chunks per block. The doubling rounds and the lifting walk
// gather within a chunk, so they run out of shared memory (the TPU's lane
// shuffles); global memory sees only coalesced row loads and stores.

#include "common.cuh"

namespace {

constexpr int CHUNK = 128;
constexpr int N_TABLES = 8;
constexpr int ROWS_PER_BLOCK = 4;
constexpr int TAB = N_TABLES * CHUNK;

__device__ __forceinline__ int clip_lane(int v) { return min(max(v, 0), CHUNK - 1); }

__global__ void __launch_bounds__(CHUNK * ROWS_PER_BLOCK)
ptr_tables_kernel(const int* __restrict__ step, int rows, int* __restrict__ out) {
  __shared__ int v[ROWS_PER_BLOCK][CHUNK];
  const int lane = threadIdx.x, r = threadIdx.y;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + r;
  const bool live = row < rows;
  int* o = out + row * TAB + lane;
  int x = live ? (int)((unsigned)lane + (unsigned)step[row * CHUNK + lane]) : 0;
  if (live) o[0] = x;
  for (int k = 1; k < N_TABLES; ++k) {
    v[r][lane] = x;
    __syncthreads();
    const int nxt = v[r][clip_lane(x)];
    __syncthreads();
    if (x < CHUNK) x = nxt;
    if (live) o[k * CHUNK] = x;
  }
}

__global__ void __launch_bounds__(CHUNK * ROWS_PER_BLOCK)
mark_kernel(const int* __restrict__ tables, const int* __restrict__ entry, int rows,
            int* __restrict__ out) {
  __shared__ int tab[ROWS_PER_BLOCK][TAB];
  const int lane = threadIdx.x, r = threadIdx.y;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + r;
  const bool live = row < rows;
  if (live) {
    for (int i = lane; i < TAB; i += CHUNK) tab[r][i] = tables[row * TAB + i];
  }
  __syncthreads();
  if (!live) return;
  int cur = entry[row * CHUNK + lane];
  for (int k = N_TABLES - 1; k >= 0; --k) {
    const int cand = tab[r][k * CHUNK + clip_lane(cur)];
    if (cand <= lane) cur = cand;
  }
  out[row * CHUNK + lane] = cur == lane ? 1 : 0;
}

}  // namespace

extern "C" int zk_reach_tables_launch(const void* step, int rows, void* out, void* stream) {
  if (rows > 0) {
    const dim3 block(CHUNK, ROWS_PER_BLOCK);
    const int grid = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    ptr_tables_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const int*)step, rows,
                                                                 (int*)out);
  }
  return zk_last_error();
}

extern "C" int zk_reach_mark_launch(const void* tables, const void* entry, int rows,
                                    void* out, void* stream) {
  if (rows > 0) {
    const dim3 block(CHUNK, ROWS_PER_BLOCK);
    const int grid = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    mark_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)tables, (const int*)entry, rows, (int*)out);
  }
  return zk_last_error();
}
