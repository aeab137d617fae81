// The first design of the port's csrc/blend_backward.cu (one block per
// tile; every warp evaluates every staged key and reduces its 11 values
// with 5 shuffles each; the block adds the warps' partials every SUB keys
// between two barriers), kept as the yardstick of
// kernel_variants/blend_step0.py and not built by the package. Variants:
//   -DZERO_RED    the shuffle reduction replaced by lane 0 writing zeros
//                 (the values are summed into a sink the compiler keeps)
//   -DSUB_N=64    SUB 64 keys between reductions (default 16)
//   order         block b takes tile order[b] when not NULL, else tile b
// The partials sit in dynamic shared memory in every variant.
#include <cuda_runtime.h>

#define MAX_PX 1024
#define NW (MAX_PX / 32)
#define STAGE 256
#ifndef SUB_N
#define SUB_N 16
#endif
#define SUB SUB_N
#define NV 11
#define FULL 0xffffffffu

__global__ void __launch_bounds__(MAX_PX)
blend_backward_kernel(const float* __restrict__ table, long long cap,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_end,
                      const float* __restrict__ d_rgb,
                      const float* __restrict__ cfin, int tile_w,
                      int extra_info, int imggrad, float* __restrict__ d_table,
                      float* __restrict__ img, const int* __restrict__ order) {
  __shared__ float s_tab[9][STAGE];
  extern __shared__ float s_dyn[];
  float (*s_part)[NV][NW] = reinterpret_cast<float (*)[NV][NW]>(s_dyn);
  const float alpha_skip = 1.0f / 255.0f;
  const float alpha_clamp = 0.99f;
  const float t_sat = 1e-4f;

  const int t = order ? order[blockIdx.x] : blockIdx.x;
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
    __syncthreads();
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
              a0 += w * r;
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
#ifdef ZERO_RED
        if (lane == 0) {
#pragma unroll
          for (int v = 0; v < NV; ++v) s_part[i][v][warp] = 0.0f;
        }
        // keep the values alive without reducing them
        float sink = 0.0f;
#pragma unroll
        for (int v = 0; v < NV; ++v) sink += val[v];
        if (sink == 1234.5f) imgx += 1.0f;
#else
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
#endif
      }
      const int alive = __syncthreads_count(!done);
      for (int j = px; j < m * NV; j += npx) {
        const int v = j / m;
        const int i = j % m;
        float s = 0.0f;
        for (int w = 0; w < nwarps; ++w) s += s_part[i][v][w];
        const int row = v < 9 ? v : v + 1;
        d_table[(size_t)row * cap + base + sub + i] = s;
      }
      __syncthreads();
      if (alive == 0) {
        finished = true;
        break;
      }
    }
  }
  img[pix * 2 + 0] = imgx;
  img[pix * 2 + 1] = imgy;
}

extern "C" int blend_backward_launch(const float* table, long long cap,
                                     const int* tile_start,
                                     const int* tile_end, const float* d_rgb,
                                     const float* cfin, int num_tiles,
                                     int tile_w, int tile_h, int extra_info,
                                     int imggrad, float* d_table, float* img,
                                     cudaStream_t stream, const int* order) {
  const int npx = tile_w * tile_h;
  if (npx < 32 || npx > MAX_PX || npx % 32) return (int)cudaErrorInvalidValue;
  const int smem = SUB * NV * NW * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      blend_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  blend_backward_kernel<<<num_tiles, npx, smem, stream>>>(
      table, cap, tile_start, tile_end, d_rgb, cfin, tile_w, extra_info,
      imggrad, d_table, img, order);
  return (int)cudaGetLastError();
}
