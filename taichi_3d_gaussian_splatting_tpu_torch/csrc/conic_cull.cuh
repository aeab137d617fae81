// The rectangle test of the blend quadratic, shared by the key expansion
// (csrc/expand.cu: one tile's rectangle) and the blend kernels
// (csrc/blend.cu, csrc/blend_backward.cu: one warp's rectangle).
//
// A splat's alpha at offset (dx, dy) from its centre is
// exp(logro - q(dx, dy)) with q = 1/2 (a dx^2 + c dy^2) + b dx dy. For a
// positive-definite conic q is convex, so its minimum over a rectangle of
// offsets is 0 when the centre lies inside, else the least of the four
// edge minima, each at the clipped vertex of a parabola. The plain
// PyTorch version is ops/expand.py::rect_qmin, in the same operations and
// order (built with -fmad=false), so K1's cull matches it bit for bit.
// min/max propagate NaN like torch.minimum/maximum: a degenerate conic
// gives NaN, and the callers keep NaN keys.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return nan_min(nan_max(v, lo), hi);
}

struct Conic {
  float ca, cb, cc;
  __device__ float q(float xx, float yy) const {
    return 0.5f * (ca * xx * xx + cc * yy * yy) + cb * xx * yy;
  }
  // min over dy in [y0, y1] at fixed dx
  __device__ float edge_x(float xx, float y0, float y1) const {
    return q(xx, clip(-cb * xx / cc, y0, y1));
  }
  // min over dx in [x0, x1] at fixed dy
  __device__ float edge_y(float yy, float x0, float x1) const {
    return q(clip(-cb * yy / ca, x0, x1), yy);
  }
  // min over the rectangle [x0, x1] x [y0, y1] of offsets
  __device__ float rect_min(float x0, float x1, float y0, float y1) const {
    const bool inside = (x0 <= 0.0f) && (0.0f <= x1) && (y0 <= 0.0f) &&
                        (0.0f <= y1);
    const float qmin = nan_min(nan_min(edge_x(x0, y0, y1), edge_x(x1, y0, y1)),
                               nan_min(edge_y(y0, x0, x1), edge_y(y1, x0, x1)));
    return inside ? 0.0f : qmin;
  }
};

// The blend kernels' per-warp cull (ops/blend.py::warp_key_cull_plain):
// may some pixel centre of the rectangle [x0, x1] x [y0, y1] of offsets
// reach alpha >= 1/255? K1's test (bias = log 255 + 1e-3), widened by
// WARP_CULL_SLACK x the magnitude of the exponent's terms, which bounds
// how far the blend's f32 exponent and this minimum can round apart. A
// conic that is NaN or not positive definite is always kept.
#define WARP_CULL_SLACK 1.9073486328125e-06f  // 2^-19

__device__ __forceinline__ bool rect_may_reach(float ca, float cb, float cc,
                                               float logro, float x0,
                                               float x1, float y0, float y1,
                                               float bias) {
  const bool pd = (ca > 0.0f) && (cc > 0.0f) && (ca * cc > cb * cb);
  const float xm = fmaxf(fabsf(x0), fabsf(x1));
  const float ym = fmaxf(fabsf(y0), fabsf(y1));
  const float mag =
      0.5f * (ca * xm * xm + cc * ym * ym) + fabsf(cb) * xm * ym + fabsf(logro);
  const float qmin = Conic{ca, cb, cc}.rect_min(x0, x1, y0, y1);
  return !pd || !(qmin > logro + (bias + WARP_CULL_SLACK * mag));
}
