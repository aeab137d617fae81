// Bucket histogram: counts of each id in [0, num_buckets); other ids ignored.
//
// Replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/histogram.py
// (bucket_histogram, _kernel), which reduced one-hot blocks on the VPU.
// On the render path it counts the sorted tile id of every key, and the
// exclusive cumsum of the counts gives each tile's [start, end) key range.
//
// Bound on the H100: bytes. It reads 4 bytes per id and does one integer
// add each, far below the card's compute rate. Design: each block keeps a
// private histogram in shared memory (atomics there are cheap and the
// sorted input hits few buckets per block), then adds it to the global
// one. Integer atomics make the counts exact and deterministic. When the
// buckets do not fit in shared memory the block adds straight to global.
#include <cuda_runtime.h>

#define MAX_SMEM_BUCKETS 12288  // 48 KB of int counters

__global__ void histogram_kernel(const int* __restrict__ ids, long long n,
                                 int num_buckets, int* __restrict__ out) {
  extern __shared__ int local[];
  const bool use_smem = num_buckets <= MAX_SMEM_BUCKETS;
  if (use_smem) {
    for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) local[b] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int id = ids[i];
    if (id >= 0 && id < num_buckets) {
      if (use_smem) {
        atomicAdd(&local[id], 1);
      } else {
        atomicAdd(&out[id], 1);
      }
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) {
      const int c = local[b];
      if (c != 0) atomicAdd(&out[b], c);
    }
  }
}

// out must hold num_buckets zeros; launched on `stream`.
extern "C" int bucket_histogram_launch(const int* ids, long long n,
                                       int num_buckets, int* out,
                                       cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM on 132 SMs
  if (blocks < 1) blocks = 1;
  const size_t smem =
      num_buckets <= MAX_SMEM_BUCKETS ? (size_t)num_buckets * sizeof(int) : 0;
  histogram_kernel<<<(unsigned)blocks, threads, smem, stream>>>(ids, n,
                                                                num_buckets, out);
  return (int)cudaGetLastError();
}
