// The first design of the port's csrc/segment_reduce.cu, kept as the yardstick of
// kernel_variants/keys_step0.py and chip_smoke.py (not built by the
// package; built with -I the package's csrc/). Unchanged.
//
// Ragged contiguous segment sum: per-key rows in original key order ->
// per-point rows.
//
// Replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/
// segment_reduce.py (segment_reduce, _kernel), which resolved key-to-point
// ownership with a membership matrix contracted on the MXU (a bf16x3 split)
// over windows fed by a 3-slot DMA ring. Point p owns lanes
// [offsets[p], offsets[p] + counts[p]) of every row. Here one thread takes
// one (row, point) pair and adds its segment's lanes in lane order: the
// result repeats bit for bit, with no atomics. Neighbouring threads take
// neighbouring points, whose segments are neighbours in memory.
//
// Bound on the H100: bytes. Each row lane is read once and each output
// written once; the mean segment is short (about two keys a point at the
// full-width frame), so one thread per point needs no tree reduction.
#include <cuda_runtime.h>

__global__ void segment_reduce_kernel(const float* __restrict__ rows,
                                      long long cols,
                                      const int* __restrict__ offsets,
                                      const int* __restrict__ counts, int n,
                                      long long total, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int r = (int)(idx / n);
  const int p = (int)(idx % n);
  const long long lo = offsets[p];
  const long long hi = min(lo + (long long)counts[p], cols);
  const float* row = rows + (size_t)r * cols;
  float s = 0.0f;
  for (long long k = lo; k < hi; ++k) s += row[k];
  out[idx] = s;
}

// rows: (num_rows, cols) f32; offsets, counts: (n,) i32 with 0 <= offsets,
// 0 <= counts; out: (num_rows, n) f32. Lanes past cols are not read.
extern "C" int segment_reduce_launch(const float* rows, int num_rows,
                                     long long cols, const int* offsets,
                                     const int* counts, int n, float* out,
                                     cudaStream_t stream) {
  const long long total = (long long)num_rows * n;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  segment_reduce_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      rows, cols, offsets, counts, n, total, out);
  return (int)cudaGetLastError();
}
