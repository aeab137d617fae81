// Tile blend, backward: per-key gradients of sum(g * rgb) for every key of
// each tile's depth-sorted range, recomputing the forward.
//
// Replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/
// blend_pallas.py (blend_backward, _backward_kernel and _backward_sub),
// which recomputed the forward with a log-space transmittance prefix and
// reduced over pixels with monomial-moment matmuls on the MXU. Here one
// block takes one tile, one thread per pixel, and each pixel walks the keys
// front to back with the forward's own f32 arithmetic (csrc/blend.cu), so
// the recomputed inclusion decisions are the forward's. Per key k, with
// g the pixel's rgb cotangent, C the forward's rgb, T the transmittance
// before k and A the inclusive prefix of c_j w_j (both per channel):
//   w = a T;  A += c w;  S_after = g.(C - A)  (the part of g.C after k);
//   dL/dalpha = (g.c) T - S_after / (1 - a);  de = dL/dalpha * alpha
// (alpha unclamped: the 0.99 clamp is straight-through). A is summed per
// channel in the forward's order, so C - A is exactly 0 after a pixel's
// last key: S_after carries no rounding of g.C against a prefix summed
// otherwise. With dx, dy the pixel's offset from the centre:
// gx = de (a_c dx + b_c dy), gy = de (b_c dx + c_c dy), and the key's
// outputs are the pixel sums
//   d_u = sum gx, d_v = sum gy, d_a = sum -1/2 de dx^2, d_b = sum -de dx dy,
//   d_c = sum -1/2 de dy^2, d_logro = sum de, d_rgb = sum g w,
//   |grad_uv| = sum sqrt(gx^2 + gy^2), count = number of including pixels.
// The conic terms come directly from dx, dy (the TPU's moment form
// cancels). With imggrad each pixel also writes (sum |gx|, sum |gy|).
//
// Reduction: each warp sums a key's 11 values with shuffles; lane 0 puts
// the warp's partials in shared memory; after SUB keys the block adds the
// warps' partials in a fixed order and writes the keys' columns. No global
// atomics: every output lane belongs to one tile, so the result repeats
// bit for bit. Lanes of no tile stay as the wrapper's zero fill.
//
// Bound on the H100: operations. Each evaluated (pixel, key) pair costs
// ~16 flops and one expf, each included pair ~50 more plus its share of
// 55 warp shuffles. The table is read once per tile; the block stops when
// every pixel has saturated (__syncthreads_count), as the forward does.
//
// Rounding: built with -fmad=false and full-precision expf, like
// csrc/blend.cu; the plain PyTorch version takes the same per-pixel
// operations in the same order, so the two differ only in the order of the
// pixel sums.
#include <cuda_runtime.h>

#define MAX_PX 1024
#define NW (MAX_PX / 32)
#define STAGE 256  // keys staged in shared memory at a time
#define SUB 16     // keys between two cross-warp reductions
#define NV 11      // reduced values per key
#define FULL 0xffffffffu

__global__ void __launch_bounds__(MAX_PX)
blend_backward_kernel(const float* __restrict__ table, long long cap,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_end,
                      const float* __restrict__ d_rgb,
                      const float* __restrict__ cfin, int tile_w,
                      int extra_info, int imggrad, float* __restrict__ d_table,
                      float* __restrict__ img) {
  __shared__ float s_tab[9][STAGE];
  __shared__ float s_part[SUB][NV][NW];
  const float alpha_skip = 1.0f / 255.0f;
  const float alpha_clamp = 0.99f;
  const float t_sat = 1e-4f;

  const int t = blockIdx.x;
  const int px = threadIdx.x;
  const int npx = blockDim.x;
  const int nwarps = npx / 32;
  const int warp = px / 32;
  const int lane = px % 32;
  const float x = (float)(px % tile_w) + 0.5f;
  const float y = (float)(px / tile_w) + 0.5f;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const size_t pix = (size_t)t * npx + px;
  const float g0 = d_rgb[pix * 3 + 0];
  const float g1 = d_rgb[pix * 3 + 1];
  const float g2 = d_rgb[pix * 3 + 2];
  const float c0 = cfin[pix * 3 + 0];
  const float c1 = cfin[pix * 3 + 1];
  const float c2 = cfin[pix * 3 + 2];

  float T = 1.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, imgx = 0.0f, imgy = 0.0f;
  bool done = false;
  bool finished = false;
  for (int base = start; base < end && !finished; base += STAGE) {
    __syncthreads();  // the previous chunk's s_tab is no longer read
    const int n = min(STAGE, end - base);
    for (int k = px; k < n; k += npx) {
      for (int r = 0; r < 9; ++r) s_tab[r][k] = table[r * cap + base + k];
    }
    __syncthreads();
    for (int sub = 0; sub < n; sub += SUB) {
      const int m = min(SUB, n - sub);
      for (int i = 0; i < m; ++i) {
        if (__all_sync(FULL, done)) {
          if (lane == 0) {
            for (int v = 0; v < NV; ++v) s_part[i][v][warp] = 0.0f;
          }
          continue;
        }
        const int k = sub + i;
        float val[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) val[v] = 0.0f;
        if (!done) {
          const float ca = s_tab[2][k], cb = s_tab[3][k], cc = s_tab[4][k];
          const float dx = x - s_tab[0][k];
          const float dy = y - s_tab[1][k];
          const float power =
              -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy + s_tab[5][k];
          const float alpha = expf(power);
          if (alpha >= alpha_skip) {
            const float a = fminf(alpha, alpha_clamp);
            const float om = 1.0f - a;
            const float next = T * om;
            if (next < t_sat) {
              done = true;
            } else {
              const float r = s_tab[6][k], gg = s_tab[7][k], b = s_tab[8][k];
              const float gc = g0 * r + g1 * gg + g2 * b;
              const float w = a * T;
              a0 += w * r;  // as csrc/blend.cu sums the colour
              a1 += w * gg;
              a2 += w * b;
              const float s_after =
                  g0 * (c0 - a0) + g1 * (c1 - a1) + g2 * (c2 - a2);
              const float dalpha = gc * T - s_after / om;
              const float de = dalpha * alpha;
              const float gx = de * (ca * dx + cb * dy);
              const float gy = de * (cb * dx + cc * dy);
              val[0] = gx;
              val[1] = gy;
              val[2] = -0.5f * (de * dx * dx);
              val[3] = -(de * dx * dy);
              val[4] = -0.5f * (de * dy * dy);
              val[5] = de;
              val[6] = g0 * w;
              val[7] = g1 * w;
              val[8] = g2 * w;
              if (extra_info) {
                val[9] = sqrtf(gx * gx + gy * gy);
                val[10] = 1.0f;
                if (imggrad) {
                  imgx += fabsf(gx);
                  imgy += fabsf(gy);
                }
              }
              T = next;
            }
          }
        }
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float s = val[v];
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
          val[v] = s;
        }
        if (lane == 0) {
#pragma unroll
          for (int v = 0; v < NV; ++v) s_part[i][v][warp] = val[v];
        }
      }
      const int alive = __syncthreads_count(!done);
      for (int j = px; j < m * NV; j += npx) {
        const int v = j / m;
        const int i = j % m;
        float s = 0.0f;
        for (int w = 0; w < nwarps; ++w) s += s_part[i][v][w];
        const int row = v < 9 ? v : v + 1;  // values 9, 10 -> rows 10, 11
        d_table[(size_t)row * cap + base + sub + i] = s;
      }
      __syncthreads();  // s_part is read before the next keys write it
      if (alive == 0) {
        finished = true;  // every pixel has saturated: later keys add 0
        break;
      }
    }
  }
  img[pix * 2 + 0] = imgx;
  img[pix * 2 + 1] = imgy;
}

// table: (16, cap) f32 sorted; tile_start/tile_end: (num_tiles,) i32 with
// 0 <= start <= end <= cap, disjoint; d_rgb, cfin: (num_tiles, px, 3) f32;
// d_table: (16, cap) f32, zero-filled by the caller; img: (num_tiles, px,
// 2) f32. px = tile_w * tile_h must be a multiple of 32, at most 1024.
extern "C" int blend_backward_launch(const float* table, long long cap,
                                     const int* tile_start,
                                     const int* tile_end, const float* d_rgb,
                                     const float* cfin, int num_tiles,
                                     int tile_w, int tile_h, int extra_info,
                                     int imggrad, float* d_table, float* img,
                                     cudaStream_t stream) {
  const int npx = tile_w * tile_h;
  if (npx < 32 || npx > MAX_PX || npx % 32) return (int)cudaErrorInvalidValue;
  blend_backward_kernel<<<num_tiles, npx, 0, stream>>>(
      table, cap, tile_start, tile_end, d_rgb, cfin, tile_w, extra_info,
      imggrad, d_table, img);
  return (int)cudaGetLastError();
}
