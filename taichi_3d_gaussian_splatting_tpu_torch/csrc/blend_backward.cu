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
// Bound on the H100: operations, ~16 flops and one expf per evaluated
// (pixel, key) pair and ~50 more per blended one. What the first design
// spent its time on instead (measured at the full-width frame; PERF.md):
// every warp (a pixel row) evaluated every key, though a key of a 32x32
// tile covers a few of its rows; every warp reduced 11 values with 55
// shuffles a key whether or not a lane blended it (48% of its time); the
// heaviest tiles started last (15%); and the block met at two barriers
// every 16 keys. This design:
//   - a warp takes an 8x4 block of pixels where the tile shape allows
//     (csrc/warp_layout.cuh), a compact footprint that few splats meet;
//   - per-warp cull: a warp tests 32 keys at a time against its own
//     pixel-centre rectangle (csrc/conic_cull.cuh, K1's tile test widened
//     by a rounding slack) and walks only the keys some pixel of it may
//     reach; a culled key would be skipped by each of its pixels anyway,
//     so every pixel's arithmetic and order are unchanged;
//   - ballot-gated transposed reduction: a key's 11 values (padded to 16)
//     are reduced only when some lane of the warp blended it, by a
//     transpose butterfly that halves the values each lane carries at each
//     stage, 8+4+2+1+1 = 16 shuffles; lane 2v then holds value v's sum;
//   - one barrier a window of WIN keys: partials are parked in a double
//     buffer of dynamic shared memory with a per-key mask of the warps that
//     wrote one (an OR, so deterministic); after the window's barrier the
//     threads add, per key and value, only those warps' partials in
//     ascending warp order, then walk the next window's keys into the
//     other buffer, with no second barrier;
//   - tiles heaviest first: block b takes tile order[b], the tiles ranked
//     by key count (csrc/tile_order.cuh, launched just before), so the
//     hardware's in-order block dispatch starts the long tiles first and
//     the short ones fill the tail.
// Every per-key sum has a fixed order and no global atomics are used, so
// the result repeats bit for bit. A block writes only its tile's lanes;
// lanes of no tile stay as the wrapper's zero fill. The block stops when
// every pixel has saturated (__syncthreads_count), as the forward does.
//
// Rounding: built with -fmad=false and full-precision expf, like
// csrc/blend.cu; the plain PyTorch version takes the same per-pixel
// operations in the same order, so the two differ only in the order of the
// pixel sums.
#include <cuda_runtime.h>

#include "conic_cull.cuh"
#include "tile_order.cuh"
#include "warp_layout.cuh"

#define MAX_PX 1024
#define WIN 64   // keys staged and reduced together (a multiple of 32)
#define NV 11    // reduced values per key
#define FULL 0xffffffffu

// One stage of the transpose butterfly: each lane keeps the half of its
// first 2H values that its lane bit O selects and adds its partner's copy
// of that half, so values [0, H) then hold the selected half's sums.
template <int O, int H>
__device__ __forceinline__ void butterfly_stage(float* val, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? val[i] : val[i + H];
    const float mine = up ? val[i + H] : val[i];
    val[i] = mine + __shfl_xor_sync(FULL, send, O);
  }
}

// shared-memory floats a block of nw warps takes
__host__ __device__ inline int part_stride(int nw) { return nw * WIN + 1; }
__host__ __device__ inline int smem_floats(int nw) {
  return 2 * 9 * WIN + 2 * NV * part_stride(nw) + 3 * WIN;
}

__global__ void __launch_bounds__(MAX_PX)
blend_backward_kernel(const float* __restrict__ table, long long cap,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_end,
                      const int* __restrict__ order,
                      const float* __restrict__ d_rgb,
                      const float* __restrict__ cfin, int tile_w,
                      int extra_info, int imggrad, float cull_bias,
                      float* __restrict__ d_table, float* __restrict__ img) {
  extern __shared__ float smem[];
  const int npx = blockDim.x;
  const int nw = npx / 32;
  const int ps = part_stride(nw);
  float* s_tab = smem;                      // [2][9][WIN]
  float* s_part = smem + 2 * 9 * WIN;       // [2][NV][nw * WIN + 1]
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(s_part + 2 * NV * ps);  // [3][WIN]

  const float alpha_skip = 1.0f / 255.0f;
  const float alpha_clamp = 0.99f;
  const float t_sat = 1e-4f;

  const int t = order[blockIdx.x];
  const int px = threadIdx.x;
  const int warp = px / 32;
  const int lane = px % 32;
  // this thread's pixel and its warp's rectangle
  const WarpPixels wp = warp_pixels(px, npx, tile_w, npx / tile_w);
  const float x = wp.x, y = wp.y;

  const int start = tile_start[t];
  const int end = tile_end[t];
  const size_t pix = (size_t)t * npx + wp.pixel;
  const float g0 = d_rgb[pix * 3 + 0];
  const float g1 = d_rgb[pix * 3 + 1];
  const float g2 = d_rgb[pix * 3 + 2];
  const float c0 = cfin[pix * 3 + 0];
  const float c1 = cfin[pix * 3 + 1];
  const float c2 = cfin[pix * 3 + 2];

  for (int j = px; j < 3 * WIN; j += npx) s_mask[j] = 0u;

  float T = 1.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, imgx = 0.0f, imgy = 0.0f;
  bool done = false;
  const int nwin = end > start ? (end - start + WIN - 1) / WIN : 0;
  // iteration n stages window n, adds up window n - 1's partials, then
  // walks window n's keys: one barrier a window
  for (int n = 0; n <= nwin; ++n) {
    const int buf = n & 1;
    const int base = start + n * WIN;
    const int cnt = n < nwin ? min(WIN, end - base) : 0;
    float* tab = s_tab + buf * 9 * WIN;
    for (int j = px; j < 9 * WIN; j += npx) {
      const int r = j / WIN, i = j % WIN;
      if (i < cnt) tab[j] = table[r * cap + base + i];
    }
    const int alive = __syncthreads_count(!done);
    if (n > 0) {  // window n - 1: fixed-order sums over the warps that wrote
      const float* part = s_part + (buf ^ 1) * NV * ps;
      const unsigned* mask = s_mask + ((n - 1) % 3) * WIN;
      const int prev = base - WIN;
      const int pcnt = min(WIN, end - prev);
      for (int j = px; j < NV * WIN; j += npx) {
        const int v = j / WIN, i = j % WIN;
        unsigned m = i < pcnt ? mask[i] : 0u;
        if (m == 0u) continue;
        float s = 0.0f;
        while (m) {
          const int w = __ffs(m) - 1;
          m &= m - 1;
          s += part[v * ps + w * WIN + i];
        }
        const int row = v < 9 ? v : v + 1;  // values 9, 10 -> rows 10, 11
        d_table[(size_t)row * cap + prev + i] = s;
      }
    }
    if (cnt == 0 || alive == 0) break;  // no keys left, or all saturated
    // window n + 1 ORs into this mask; window n - 2's sums read it last
    for (int j = px; j < WIN; j += npx) s_mask[((n + 1) % 3) * WIN + j] = 0u;
    if (__all_sync(FULL, done)) continue;

    float* part = s_part + buf * NV * ps;
    unsigned* mask = s_mask + (n % 3) * WIN;
    for (int w32 = 0; w32 < cnt; w32 += 32) {
      const int kc = w32 + lane;
      const bool keep =
          kc < cnt &&
          rect_may_reach(tab[2 * WIN + kc], tab[3 * WIN + kc],
                         tab[4 * WIN + kc], tab[5 * WIN + kc],
                         wp.x0 - tab[kc], wp.x1 - tab[kc],
                         wp.y0 - tab[WIN + kc], wp.y1 - tab[WIN + kc],
                         cull_bias);
      unsigned bits = __ballot_sync(FULL, keep);
      while (bits) {
        const int k = w32 + __ffs(bits) - 1;
        bits &= bits - 1;
        float val[16];
#pragma unroll
        for (int v = 0; v < 16; ++v) val[v] = 0.0f;
        bool inc = false;
        if (!done) {
          const float ca = tab[2 * WIN + k], cb = tab[3 * WIN + k],
                      cc = tab[4 * WIN + k];
          const float dx = x - tab[k];
          const float dy = y - tab[WIN + k];
          const float power = -0.5f * (ca * dx * dx + cc * dy * dy) -
                              cb * dx * dy + tab[5 * WIN + k];
          const float alpha = expf(power);
          if (alpha >= alpha_skip) {
            const float a = fminf(alpha, alpha_clamp);
            const float om = 1.0f - a;
            const float next = T * om;
            if (next < t_sat) {
              done = true;
            } else {
              const float r = tab[6 * WIN + k], gg = tab[7 * WIN + k],
                          b = tab[8 * WIN + k];
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
              inc = true;
            }
          }
        }
        if (__ballot_sync(FULL, inc)) {
          butterfly_stage<16, 8>(val, lane);
          butterfly_stage<8, 4>(val, lane);
          butterfly_stage<4, 2>(val, lane);
          butterfly_stage<2, 1>(val, lane);
          val[0] += __shfl_xor_sync(FULL, val[0], 1);
          const int v = lane >> 1;  // the value lane 2v now holds
          if (!(lane & 1) && v < NV) part[v * ps + warp * WIN + k] = val[0];
          if (lane == 0) atomicOr(&mask[k], 1u << warp);
        }
        if (__all_sync(FULL, done)) break;
      }
      if (__all_sync(FULL, done)) break;
    }
  }
  img[pix * 2 + 0] = imgx;
  img[pix * 2 + 1] = imgy;
}

// table: (16, cap) f32 sorted; tile_start/tile_end: (num_tiles,) i32 with
// 0 <= start <= end <= cap, disjoint; order: (num_tiles,) i32 scratch for
// the tile order; d_rgb, cfin: (num_tiles, px, 3) f32; d_table: (16, cap)
// f32, zero-filled by the caller; img: (num_tiles, px, 2) f32. px =
// tile_w * tile_h must be a multiple of 32, at most 1024. cull_bias:
// log 255 + K1's margin.
extern "C" int blend_backward_launch(const float* table, long long cap,
                                     const int* tile_start,
                                     const int* tile_end, int* order,
                                     const float* d_rgb, const float* cfin,
                                     int num_tiles, int tile_w, int tile_h,
                                     int extra_info, int imggrad,
                                     float cull_bias, float* d_table,
                                     float* img, cudaStream_t stream) {
  const int npx = tile_w * tile_h;
  if (npx < 32 || npx > MAX_PX || npx % 32) return (int)cudaErrorInvalidValue;
  const int smem = smem_floats(npx / 32) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      blend_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(MAX_PX / 32) * (int)sizeof(float));
  if (e != cudaSuccess) return (int)e;
  e = launch_tile_order(tile_start, tile_end, num_tiles, order, stream);
  if (e != cudaSuccess) return (int)e;
  blend_backward_kernel<<<num_tiles, npx, smem, stream>>>(
      table, cap, tile_start, tile_end, order, d_rgb, cfin, tile_w,
      extra_info, imggrad, cull_bias, d_table, img);
  return (int)cudaGetLastError();
}
