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
// Bound on the H100: operations, ~16 flops and one expf per (pixel, key)
// pair a pixel needs; the table is read once per tile. The first design
// (every warp of a pixel row evaluating every staged key until its last
// pixel stopped, tiles in grid order) walked 1.45x the pairs the pixels
// need, 58% of the warps' key steps went to keys whose footprint misses
// the warp's row, and its heaviest tiles set the tail (measured at the
// full-width frame; PERF.md). This design:
//   - stages the tile's keys through shared memory one chunk of blockDim
//     keys at a time (one key per thread, coalesced row reads), so every
//     pixel reads each key's attributes as a shared-memory broadcast;
//   - a warp takes an 8x4 block of pixels where the tile shape allows
//     (csrc/warp_layout.cuh), a compact footprint that few splats meet;
//   - per-warp cull: a warp tests 32 staged keys at a time against its
//     own pixel-centre rectangle (csrc/conic_cull.cuh, K1's tile test
//     widened by a rounding slack; one key a lane, then a ballot) and
//     walks only the keys some pixel of it may reach. A culled key would
//     be skipped by each of the warp's pixels, so every pixel takes the
//     same operations in the same order and the output is unchanged. (The
//     partial last warp of a tile whose pixel count is not a multiple of
//     32 walks every key.);
//   - a warp stops when its last pixel has stopped, the block when every
//     pixel has (__syncthreads_count);
//   - tiles heaviest first (csrc/tile_order.cuh), so the long tiles do not
//     start last.
//
// Rounding: built with -fmad=false; the exponent keeps the plain PyTorch
// version's operation order, and expf is the full-precision libdevice one
// (no fast math), so the 1/255 and 1e-4 tests see the same values.
#include <cuda_runtime.h>

#include "conic_cull.cuh"
#include "tile_order.cuh"
#include "warp_layout.cuh"

#define MAX_PX 1024
#define ROWS 10

// two blocks an SM: at 32 registers a thread (ptxas spills a few values
// to the stack) the SM holds 64 warps, so one block's barriers and tail
// overlap the other's work; without the bound the cull takes the kernel
// to 56 registers and one block
__global__ void __launch_bounds__(MAX_PX, 2)
blend_forward_kernel(const float* __restrict__ table, long long cap,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end,
                     const int* __restrict__ order, int tile_w, int rgb_only,
                     float cull_bias, float* __restrict__ out) {
  __shared__ float s[ROWS][MAX_PX];
  const float alpha_skip = 1.0f / 255.0f;
  const float alpha_clamp = 0.99f;
  const float t_sat = 1e-4f;

  const int t = order[blockIdx.x];
  const int px = threadIdx.x;
  const int npx = blockDim.x;
  const int lane = px % 32;
  // this thread's pixel and its warp's rectangle; the lanes of the warp
  // (the last warp of a tile may be partial)
  const WarpPixels wp = warp_pixels(px, npx, tile_w, npx / tile_w);
  const float x = wp.x, y = wp.y;
  const int nlanes = min(32, npx - (px - lane));
  const unsigned lanes = nlanes == 32 ? 0xffffffffu : (1u << nlanes) - 1u;
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
    if (!__any_sync(lanes, active)) continue;
    const int n = min(npx, end - base);
    for (int w32 = 0; w32 < n; w32 += 32) {
      // the 32 keys from w32, one a lane; a partial warp walks them all
      unsigned bits = n - w32 >= 32 ? 0xffffffffu : (1u << (n - w32)) - 1u;
      if (lanes == 0xffffffffu) {
        const int kc = w32 + lane;
        const bool keep =
            kc < n && rect_may_reach(s[2][kc], s[3][kc], s[4][kc], s[5][kc],
                                     wp.x0 - s[0][kc], wp.x1 - s[0][kc],
                                     wp.y0 - s[1][kc], wp.y1 - s[1][kc],
                                     cull_bias);
        bits = __ballot_sync(lanes, keep);
      }
      while (bits) {
        const int i = w32 + __ffs(bits) - 1;
        bits &= bits - 1;
        if (active) {
          const float dx = x - s[0][i];
          const float dy = y - s[1][i];
          const float power = -0.5f * (s[2][i] * dx * dx + s[4][i] * dy * dy) -
                              s[3][i] * dx * dy + s[5][i];
          const float alpha = expf(power);
          if (alpha >= alpha_skip) {
            const float a = fminf(alpha, alpha_clamp);
            const float om = 1.0f - a;
            const float next = T * om;
            if (next < t_sat) {
              active = false;
            } else {
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
        }
        if (!__any_sync(lanes, active)) break;
      }
      if (!__any_sync(lanes, active)) break;
    }
  }
  float* o = out + ((size_t)t * npx + wp.pixel) * 8;
  reinterpret_cast<float4*>(o)[0] = make_float4(cr, cg, cb, wd);
  reinterpret_cast<float4*>(o)[1] =
      make_float4(ws, cnt, rgb_only ? 1.0f : T, 0.0f);
}

// table: (16, cap) f32 sorted; tile_start/tile_end: (num_tiles,) i32 with
// 0 <= start <= end <= cap; order: (num_tiles,) i32 scratch for the tile
// order; out: (num_tiles, tile_w*tile_h, 8) f32. cull_bias: log 255 +
// K1's margin.
extern "C" int blend_forward_launch(const float* table, long long cap,
                                    const int* tile_start, const int* tile_end,
                                    int* order, int num_tiles, int tile_w,
                                    int tile_h, int rgb_only, float cull_bias,
                                    float* out, cudaStream_t stream) {
  const int npx = tile_w * tile_h;
  if (npx < 1 || npx > MAX_PX) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      launch_tile_order(tile_start, tile_end, num_tiles, order, stream);
  if (e != cudaSuccess) return (int)e;
  blend_forward_kernel<<<num_tiles, npx, 0, stream>>>(
      table, cap, tile_start, tile_end, order, tile_w, rgb_only, cull_bias,
      out);
  return (int)cudaGetLastError();
}
