// Heaviest-first tile order for the blend kernels (csrc/blend.cu,
// csrc/blend_backward.cu): order[r] is the tile of rank r by key count,
// descending, ties by tile id, so the order is a fixed permutation.
//
// A blend block takes tile order[blockIdx.x]. The hardware hands blocks
// to the SMs in about blockIdx order, so the longest tiles start first and
// the short ones fill the tail: at the full-width frame a greedy schedule
// of the tiles' key steps on 132 SMs finishes within 2.1% of the even
// split this way, against 27% over it in tile order (PERF.md).
// Only the speed depends on the dispatch order, never the result.
//
// Each thread ranks one tile against all of them (O(tiles^2) compares:
// ~260k at 510 tiles, a few microseconds).
#pragma once
#include <cuda_runtime.h>

#define ORDER_THREADS 256

__global__ void __launch_bounds__(ORDER_THREADS)
tile_order_kernel(const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, int num_tiles,
                  int* __restrict__ order) {
  __shared__ int s_len[ORDER_THREADS];
  const int t = blockIdx.x * ORDER_THREADS + threadIdx.x;
  const int len = t < num_tiles ? max(tile_end[t] - tile_start[t], 0) : 0;
  int rank = 0;
  for (int b = 0; b < num_tiles; b += ORDER_THREADS) {
    __syncthreads();
    const int j = b + threadIdx.x;
    s_len[threadIdx.x] =
        j < num_tiles ? max(tile_end[j] - tile_start[j], 0) : 0;
    __syncthreads();
    const int m = min(ORDER_THREADS, num_tiles - b);
    for (int i = 0; i < m; ++i) {
      const int l = s_len[i];
      rank += (l > len) || (l == len && b + i < t);
    }
  }
  if (t < num_tiles) order[rank] = t;
}

static inline cudaError_t launch_tile_order(const int* tile_start,
                                            const int* tile_end,
                                            int num_tiles, int* order,
                                            cudaStream_t stream) {
  const int blocks = (num_tiles + ORDER_THREADS - 1) / ORDER_THREADS;
  tile_order_kernel<<<blocks, ORDER_THREADS, 0, stream>>>(
      tile_start, tile_end, num_tiles, order);
  return cudaGetLastError();
}
