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

// tile_counts_kernel (ops/stages.py's tile counters, recorded inside the
// train window's graph): the summary of one frame's tile ranges, written as
// three int64 counters: the keys of the heaviest tile, the kept keys
// (bounds[num_tiles] - bounds[0]: every key below the sentinel tile) and
// the tiles that hold a key. One block strides over the tiles, reduces its
// warps' maxima and counts with shuffles and one shared-memory round, and
// thread 0 writes the three slots. A frame has under 10^4 tiles: one launch
// of a few microseconds, inside the graph.
__global__ void tile_counts_kernel(const int* __restrict__ bounds,
                                   int num_tiles,
                                   long long* __restrict__ out) {
  __shared__ int warp_max[32];
  __shared__ int warp_held[32];
  int heaviest = 0, held = 0;
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
    const int n = __ldg(bounds + t + 1) - __ldg(bounds + t);
    heaviest = max(heaviest, n);
    held += n > 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    heaviest = max(heaviest, __shfl_down_sync(0xffffffffu, heaviest, o));
    held += __shfl_down_sync(0xffffffffu, held, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_max[warp] = heaviest;
    warp_held[warp] = held;
  }
  __syncthreads();
  if (warp != 0) return;
  const int warps = blockDim.x >> 5;
  heaviest = lane < warps ? warp_max[lane] : 0;
  held = lane < warps ? warp_held[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) {
    heaviest = max(heaviest, __shfl_down_sync(0xffffffffu, heaviest, o));
    held += __shfl_down_sync(0xffffffffu, held, o);
  }
  if (lane == 0) {
    out[0] = heaviest;
    out[1] = (long long)__ldg(bounds + num_tiles) - __ldg(bounds);
    out[2] = held;
  }
}

// bounds: (num_tiles + 1,) tile ranges (tile_ranges_launch); out: three
// int64 slots. Launched on `stream`.
extern "C" int tile_counts_launch(const int* bounds, int num_tiles,
                                  long long* out, cudaStream_t stream) {
  tile_counts_kernel<<<1, 1024, 0, stream>>>(bounds, num_tiles, out);
  return (int)cudaGetLastError();
}
