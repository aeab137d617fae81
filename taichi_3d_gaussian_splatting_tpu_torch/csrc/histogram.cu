// Tile ranges of the sorted keys, in place of a bucket histogram.
//
// It replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/
// histogram.py (bucket_histogram, _kernel), which reduced one-hot blocks on
// the VPU; the JAX render path takes the exclusive cumsum of its counts of
// the sorted tile ids as each tile's [start, end) key range, in place of
// searchsorted (its docstring, :3-12).
//
// tile_ranges_kernel (the render and train paths): the keys arrive sorted,
// so a tile's range starts where the tile id changes. Thread i < total
// reads tid[i] and tid[i-1] (-1 for i = 0), both clamped to [-1,
// num_tiles], and writes bounds[b] = i for every b in (tid[i-1], tid[i]];
// thread i = total writes bounds[b] = total for b in (tid[total-1],
// num_tiles]. So bounds[b] = the number of keys with tile < b, which is
// searchsorted(tid, b, side='left'): the histogram, its cumsum and the
// zero fills fold into one pass that writes every entry exactly once, with
// no atomics. Sentinel keys carry tid = num_tiles, so bounds[num_tiles]
// counts the live keys. Bound on the H100: bytes (4 B a key read, 4 B a
// tile written); at a frame's half-million keys the launch and the ramp of
// one wave of blocks take longer than the bytes.
#include <cuda_runtime.h>

__device__ __forceinline__ int clamped_tile(int key, int dbits,
                                            int num_tiles) {
  const int t = key >> dbits;  // keys are >= 0: the shift is logical
  return max(min(t, num_tiles), -1);
}

__global__ void tile_ranges_kernel(const int* __restrict__ fused, int total,
                                   int dbits, int num_tiles,
                                   int* __restrict__ bounds) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > total) return;
  const int hi =
      i < total ? clamped_tile(__ldg(fused + i), dbits, num_tiles) : num_tiles;
  const int lo =
      i > 0 ? clamped_tile(__ldg(fused + i - 1), dbits, num_tiles) : -1;
  for (int b = lo + 1; b <= hi; ++b) bounds[b] = (int)i;
}

// fused: (total,) sorted keys >= 0; bounds: (num_tiles + 1,), every entry
// written. Launched on `stream`.
extern "C" int tile_ranges_launch(const int* fused, int total, int dbits,
                                  int num_tiles, int* bounds,
                                  cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = ((long long)total + 1 + threads - 1) / threads;
  tile_ranges_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      fused, total, dbits, num_tiles, bounds);
  return (int)cudaGetLastError();
}
