// The first design of the port's csrc/expand.cu, kept as the yardstick of
// kernel_variants/keys_step0.py and chip_smoke.py (not built by the
// package; built with -I the package's csrc/). Unchanged.
//
// Key expansion: per-point rows -> per-key sort keys and blend table rows.
//
// Replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/expand.py
// (expand_keys, _expand_kernel), which broadcast point columns to key
// slots with a one-hot matmul. Here each thread owns one key slot k and
// finds its point p (the one with offsets[p] <= k < offsets[p] +
// counts[p]) by binary search over the non-decreasing offsets: the last
// p with offsets[p] <= k always owns k, because a zero-count point after
// the owner starts past k. Then, as the TPU kernel did:
//   - the u-major tile decode j = k - off, du = j / h, dv = j - du h,
//     tid = base + du + dv tiles_u;
//   - the fused int32 sort key (tid << dbits) + dkey, or the sentinel;
//   - the splat centre made tile-local;
//   - with exact_cull, the exact (point, tile) cull: the pair is dropped
//     to the sentinel when the blend quadratic's minimum over the tile's
//     pixel-centre rectangle exceeds logro + log 255 + margin;
//   - the (16, total) table in pre-sort order: rows 0..9 = u_local,
//     v_local, conic a, b, c, logro, r, g, b, depth; row 10 = point index;
//     rows 11..15 = 0.
//
// Bound on the H100: bytes. Per key it writes 68 bytes (fused key and 16
// table rows) and reads a few cached point columns; the binary search and
// the cull are a few dozen flops. Writes are coalesced (neighbouring
// threads write neighbouring slots of each row); reads of one point's
// columns are shared by the neighbouring keys it owns.
//
// Rounding: built with -fmad=false, and every expression keeps the
// operation order of the plain PyTorch version, so the cull decisions and
// the table agree with it bit for bit. The rectangle minimum is
// csrc/conic_cull.cuh's, which the blend kernels share (a degenerate conic
// gives NaN and keeps its key).
#include <cuda_runtime.h>

#include "conic_cull.cuh"

__global__ void expand_kernel(const int* __restrict__ offsets,
                              const int* __restrict__ dkey,
                              const int* __restrict__ base,
                              const int* __restrict__ h,
                              const float* __restrict__ attr, int n, int total,
                              int tiles_u, int tile_w, int tile_h, int dbits,
                              int sentinel, int exact_cull, float cull_bias,
                              int* __restrict__ fused,
                              float* __restrict__ table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  int lo = 0, hi = n;  // first index with offsets[idx] > k
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= k) lo = mid + 1; else hi = mid;
  }
  const int p = lo - 1;
  const int j = k - offsets[p];
  const int hh = max(h[p], 1);
  const int du = j / hh;
  const int dv = j - du * hh;
  const int tid = base[p] + du + dv * tiles_u;
  const float cx = (float)(tid % tiles_u) * (float)tile_w;
  const float cy = (float)(tid / tiles_u) * (float)tile_h;
  const float u_raw = attr[p] - cx;
  const float v_raw = attr[(size_t)n + p] - cy;

  bool valid = true;
  if (exact_cull) {
    const Conic c{attr[2 * (size_t)n + p], attr[3 * (size_t)n + p],
                  attr[4 * (size_t)n + p]};
    const float logro = attr[5 * (size_t)n + p];
    const float qmin = c.rect_min(0.5f - u_raw, ((float)tile_w - 0.5f) - u_raw,
                                  0.5f - v_raw, ((float)tile_h - 0.5f) - v_raw);
    valid = !(qmin > logro + cull_bias);
  }

  fused[k] = valid ? (tid << dbits) + dkey[p] : sentinel;
  const size_t t = (size_t)total;
  table[k] = valid ? u_raw : 0.0f;
  table[t + k] = valid ? v_raw : 0.0f;
#pragma unroll
  for (int r = 2; r < 10; ++r) table[r * t + k] = attr[r * (size_t)n + p];
  table[10 * t + k] = (float)p;
#pragma unroll
  for (int r = 11; r < 16; ++r) table[r * t + k] = 0.0f;
}

// attr: (10, n) f32; fused: (total,) i32; table: (16, total) f32.
extern "C" int expand_keys_launch(const int* offsets, const int* dkey,
                                  const int* base, const int* h,
                                  const float* attr, int n, int total,
                                  int tiles_u, int tile_w, int tile_h,
                                  int dbits, int sentinel, int exact_cull,
                                  float cull_bias, int* fused, float* table,
                                  cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  expand_kernel<<<blocks, threads, 0, stream>>>(
      offsets, dkey, base, h, attr, n, total, tiles_u, tile_w, tile_h, dbits,
      sentinel, exact_cull, cull_bias, fused, table);
  return (int)cudaGetLastError();
}
