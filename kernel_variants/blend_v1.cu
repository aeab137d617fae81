// The first design of the port's csrc/blend.cu, kept as the yardstick of
// kernel_variants/blend_step0.py (not built by the package). One change:
// block b takes tile order[b] when `order` is not NULL, else tile b.
//
// Tile blend, forward: front-to-back alpha compositing of each tile's
// depth-sorted key range.
//
// Replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/
// blend_pallas.py (blend_forward, _forward_kernel and _chunk_state), which
// computed the transmittance as a log-space prefix sum on the MXU (an
// approximation within 7e-5). Here one block blends one tile, one thread
// per pixel, each carrying its own sequential f32 transmittance T, which
// is the reference semantics:
//   alpha = exp(-0.5 (a dx^2 + c dy^2) - b dx dy + log(rescale*opacity))
//   a key is skipped when !(alpha >= 1/255) (NaN skips too);
//   a = min(alpha, 0.99); the pixel stops for good when T (1 - a) < 1e-4;
//   otherwise w = a T adds w rgb (and w depth, w, 1), and T *= 1 - a.
// Output (num_tiles, tile_w tile_h, 8): [r, g, b, sum w depth, sum w,
// count, T_final, 0]; T_final is 1 for an empty pixel. With rgb_only only
// r, g, b are blended and the rest is [0, 0, 0, 1, 0].
//
// The block stages the tile's keys through shared memory one chunk of
// blockDim keys at a time (one key per thread, coalesced row reads), so
// every pixel reads each key's attributes as a shared-memory broadcast.
// The block stops once every pixel has stopped (__syncthreads_count).
//
// Bound on the H100: operations. Each live (pixel, key) pair costs ~16
// flops and one expf; the table is read once per tile. The card's f32
// rate bounds it; T's sequential dependence within a pixel is hidden by
// the 1024 pixels of a tile in flight.
//
// Rounding: built with -fmad=false; the exponent keeps the plain PyTorch
// version's operation order, and expf is the full-precision libdevice one
// (no fast math), so the 1/255 and 1e-4 tests see the same values.
#include <cuda_runtime.h>

#define MAX_PX 1024
#define ROWS 10

__global__ void __launch_bounds__(MAX_PX)
blend_forward_kernel(const float* __restrict__ table, long long cap,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end, int tile_w,
                     int rgb_only, float* __restrict__ out,
                     const int* __restrict__ order) {
  __shared__ float s[ROWS][MAX_PX];
  const float alpha_skip = 1.0f / 255.0f;
  const float alpha_clamp = 0.99f;
  const float t_sat = 1e-4f;

  const int t = order ? order[blockIdx.x] : blockIdx.x;
  const int px = threadIdx.x;
  const int npx = blockDim.x;
  const float x = (float)(px % tile_w) + 0.5f;
  const float y = (float)(px / tile_w) + 0.5f;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int rows = rgb_only ? 9 : ROWS;

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  float wd = 0.0f, ws = 0.0f, cnt = 0.0f;
  bool active = true;
  for (int base = start; base < end; base += npx) {
    // also the barrier that keeps the previous chunk alive until read
    if (__syncthreads_count(active) == 0) break;
    const int k = base + px;
    if (k < end) {
      for (int r = 0; r < rows; ++r) s[r][px] = table[r * cap + k];
    }
    __syncthreads();
    if (!active) continue;
    const int n = min(npx, end - base);
    for (int i = 0; i < n; ++i) {
      const float dx = x - s[0][i];
      const float dy = y - s[1][i];
      const float power = -0.5f * (s[2][i] * dx * dx + s[4][i] * dy * dy) -
                          s[3][i] * dx * dy + s[5][i];
      const float alpha = expf(power);
      if (!(alpha >= alpha_skip)) continue;
      const float a = fminf(alpha, alpha_clamp);
      const float om = 1.0f - a;
      const float next = T * om;
      if (next < t_sat) {
        active = false;
        break;
      }
      const float w = a * T;
      cr += w * s[6][i];
      cg += w * s[7][i];
      cb += w * s[8][i];
      if (!rgb_only) {
        wd += w * s[9][i];
        ws += w;
        cnt += 1.0f;
      }
      T = next;
    }
  }
  float* o = out + ((size_t)t * npx + px) * 8;
  reinterpret_cast<float4*>(o)[0] = make_float4(cr, cg, cb, wd);
  reinterpret_cast<float4*>(o)[1] =
      make_float4(ws, cnt, rgb_only ? 1.0f : T, 0.0f);
}

// table: (16, cap) f32 sorted; tile_start/tile_end: (num_tiles,) i32 with
// 0 <= start <= end <= cap; out: (num_tiles, tile_w*tile_h, 8) f32.
extern "C" int blend_forward_launch(const float* table, long long cap,
                                    const int* tile_start, const int* tile_end,
                                    int num_tiles, int tile_w, int tile_h,
                                    int rgb_only, float* out,
                                    cudaStream_t stream, const int* order) {
  const int npx = tile_w * tile_h;
  if (npx < 1 || npx > MAX_PX) return (int)cudaErrorInvalidValue;
  blend_forward_kernel<<<num_tiles, npx, 0, stream>>>(
      table, cap, tile_start, tile_end, tile_w, rgb_only, out, order);
  return (int)cudaGetLastError();
}
