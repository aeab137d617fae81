// Per-point screen-space attributes of a frame that needs no gradient, in
// one pass: what ops/rasterizer.py::compute_raw_attrs returns.
//
// Replaces no TPU kernel. On the TPU, XLA fuses the attribute stage
// (ops/attributes.py, projection.py, sh.py and the pose inverse of
// ops/transforms.py) into a few loops over the points. Eager PyTorch runs
// it as a few hundred elementwise, stack and reduce kernels, each reading
// and writing (N,) to (N, 3, 16) temporaries; a CUDA graph takes the
// launches' host cost away, not their bytes. The plain version
// (ops/attributes.py::point_attributes_plain) stays the CPU path, the
// autograd path and the test oracle.
//
// point_attributes_kernel: one thread a pool slot. It folds the camera pose
// into the pass (the inverse of (q, t) and its rotation matrix, per thread,
// from device memory, so a CUDA graph replay sees the pose copied into its
// static inputs; with per-object poses the pose of the point's object id),
// then the guarded quaternion normalize, the projection, the EWA
// covariance, the filtered conic with its rescale and radius, the sigmoid
// opacity, the per-axis cull radius, the SH basis to band 3 (the bands
// above sh_coeffs multiplied by 0, so a NaN coefficient still gives NaN),
// the three SH sums and their sigmoids, and the row0 shift of v. It writes
// each field as its own row-major tensor.
//
// Bound on the H100: bytes. A point reads 236 bytes (xyz and the 56
// feature columns) and writes 64 (uv, cov2d, conic, opacity, colour,
// depth, the per-axis radius) with some 400 f32 operations: far under the
// operation roofline. The block's 128 rows of the row-major (N, 56)
// features are one contiguous range of 28,672 bytes; the block reads it
// with 16-byte loads, neighbouring threads on neighbouring addresses, all
// 14 of a thread in flight at once, into shared memory rows padded to 60
// floats, so each thread's 16-byte reads of its own row hit 8 distinct
// bank groups in every quarter warp.
//
// Rounding: built with -fmad=false, and every expression keeps the
// operation order of the plain version, one rounding a PyTorch op, so the
// fields equal it bit for bit: the reductions as PyTorch's reduce kernel
// takes them (lane i adds lane i + half, then i + half/2, ..., over 16 or
// 4 lanes, and a 3-element sum as (x0 + x2) + x1), the cross product as
// torch.linalg.cross's kernel contracts a*b - c*d, a division by a host
// scalar as the multiply by its inverse, and every constant rounded from
// the double the Python source gives.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 56;     // feature columns a point
constexpr int kVecs = kCols / 4;  // 16-byte loads a row
constexpr int kPitch = 60;    // a row's floats in shared memory

#define F(x) static_cast<float>(x)  // a Python float constant, as torch casts it

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);  // torch.clamp_min: NaN passes
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float minimum(float a, float b) {
  if (a != a) return a;  // torch.minimum: NaN wins
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float away_from_zero(float z) {
  return fabsf(z) < F(1e-6) ? (z < 0.0f ? F(-1e-6) : F(1e-6)) : z;
}

__device__ __forceinline__ float sigmoid(float a) {
  return 1.0f / (1.0f + expf(-a));
}

// a*b - c*d as torch.linalg.cross's kernel computes it
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = cross_term(a[1], b[2], a[2], b[1]);
  out[1] = cross_term(a[2], b[0], a[0], b[2]);
  out[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// ops/transforms.py::quaternion_to_rotation_matrix, xyzw
__device__ __forceinline__ void rotation(float x, float y, float z, float w,
                                         float R[9]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz);
  R[1] = 2.0f * (xy - wz);
  R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz);
  R[4] = 1.0f - 2.0f * (xx + zz);
  R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy);
  R[7] = 2.0f * (yz + wx);
  R[8] = 1.0f - 2.0f * (xx + yy);
}

// ops/transforms.py::inverse_qt of the camera pose (q, t), and the rotation
// of the inverse: world -> camera
__device__ __forceinline__ void camera_from_pose(const float* q,
                                                 const float* t, float R[9],
                                                 float t_cw[3]) {
  const float qv[3] = {-q[0], -q[1], -q[2]};
  const float w = q[3];
  const float v[3] = {t[0], t[1], t[2]};
  float c[3], tt[3], c2[3];
  cross(qv, v, c);
  for (int i = 0; i < 3; ++i) tt[i] = 2.0f * c[i];
  cross(qv, tt, c2);
  for (int i = 0; i < 3; ++i) t_cw[i] = -((v[i] + w * tt[i]) + c2[i]);
  rotation(qv[0], qv[1], qv[2], w, R);
}

// torch.sum over 16 values, as PyTorch's reduce kernel folds its lanes:
// lane i adds lane i + 8, then i + 4, i + 2, i + 1
__device__ __forceinline__ float sum16(const float p[16]) {
  float s[8];
  for (int i = 0; i < 8; ++i) s[i] = p[i] + p[i + 8];
  for (int i = 0; i < 4; ++i) s[i] = s[i] + s[i + 4];
  return (s[0] + s[2]) + (s[1] + s[3]);
}

// The block's rows [0, rows) of the features into shared memory, 16-byte
// loads (the wrapper checks the alignment), each thread's all in flight
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int rows, float* dst) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int n4 = rows * kVecs;
  float4 v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int k = j * kThreads + threadIdx.x;
    if (k < n4) v[j] = __ldg(s4 + k);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int k = j * kThreads + threadIdx.x;
    const int r = k / kVecs;
    if (k < n4)
      *reinterpret_cast<float4*>(dst + r * kPitch + (k - r * kVecs) * 4) =
          v[j];
  }
}

__global__ void __launch_bounds__(kThreads) point_attributes_kernel(
    const float* __restrict__ xyz, const float* __restrict__ features,
    long long n, const float* __restrict__ q_pc,
    const float* __restrict__ t_pc, const int* __restrict__ object_id,
    int num_poses, const float* __restrict__ K, int sh_coeffs, float row0,
    float* __restrict__ uv, float* __restrict__ cov2d,
    float* __restrict__ conic, float* __restrict__ opacity,
    float* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ radius_xy) {
  __shared__ __align__(16) float rows[kThreads * kPitch];
  const long long first = (long long)blockIdx.x * kThreads;
  const int count = (int)min((long long)kThreads, n - first);
  stage_rows(features + first * kCols, count, rows);
  __syncthreads();
  if ((int)threadIdx.x >= count) return;
  const long long p = first + threadIdx.x;
  const float* f = rows + threadIdx.x * kPitch;

  // the pose: one, or the one of the point's object
  const float* q = q_pc;
  const float* t = t_pc;
  if (object_id != nullptr) {
    const int id = object_id[p];
    if (id < 0 || id >= num_poses) {  // no such pose: NaN fields
      const float nan = __int_as_float(0x7fc00000);
      uv[2 * p] = uv[2 * p + 1] = nan;
      for (int i = 0; i < 3; ++i) cov2d[3 * p + i] = color[3 * p + i] = nan;
      for (int i = 0; i < 4; ++i) conic[4 * p + i] = nan;
      opacity[p] = depth[p] = radius_xy[2 * p] = radius_xy[2 * p + 1] = nan;
      return;
    }
    q += 4 * id;
    t += 3 * id;
  }
  float Rc[9], tc[3];
  camera_from_pose(q, t, Rc, tc);

  // the guarded quaternion normalize
  float qn[4];
  {
    const float a0 = f[0] * f[0], a1 = f[1] * f[1];
    const float a2 = f[2] * f[2], a3 = f[3] * f[3];
    const float d = clamp_min(sqrtf((a0 + a2) + (a1 + a3)), F(1e-12));
    for (int i = 0; i < 4; ++i) qn[i] = f[i] / d;
  }

  // ops/projection.py::project_point
  const float x = xyz[3 * p], y = xyz[3 * p + 1], z = xyz[3 * p + 2];
  const float cx = ((Rc[0] * x + Rc[1] * y) + Rc[2] * z) + tc[0];
  const float cy = ((Rc[3] * x + Rc[4] * y) + Rc[5] * z) + tc[1];
  const float cz = ((Rc[6] * x + Rc[7] * y) + Rc[8] * z) + tc[2];
  const float K00 = K[0], K01 = K[1], K02 = K[2];
  const float K10 = K[3], K11 = K[4], K12 = K[5];
  const float inv_z = 1.0f / away_from_zero(cz);
  const float u = ((K00 * cx + K01 * cy) + K02 * cz) * inv_z;
  float v = ((K10 * cx + K11 * cy) + K12 * cz) * inv_z;

  // ops/projection.py::project_cov2d_components
  float a, b, c;
  {
    const float jx = K00 * inv_z, jy = K11 * inv_z;
    const float jxz = ((-K00 * cx) * inv_z) * inv_z;
    const float jyz = ((-K11 * cy) * inv_z) * inv_z;
    float A0[3], A1[3];
    for (int i = 0; i < 3; ++i) {
      A0[i] = jx * Rc[i] + jxz * Rc[6 + i];
      A1[i] = jy * Rc[3 + i] + jyz * Rc[6 + i];
    }
    float Rq[9];
    rotation(qn[0], qn[1], qn[2], qn[3], Rq);
    float B0[3], B1[3];
    for (int k = 0; k < 3; ++k) {
      const float s = expf(f[4 + k]);
      B0[k] = ((A0[0] * Rq[k] + A0[1] * Rq[3 + k]) + A0[2] * Rq[6 + k]) * s;
      B1[k] = ((A1[0] * Rq[k] + A1[1] * Rq[3 + k]) + A1[2] * Rq[6 + k]) * s;
    }
    a = (B0[0] * B0[0] + B0[1] * B0[1]) + B0[2] * B0[2];
    b = (B0[0] * B1[0] + B0[1] * B1[1]) + B0[2] * B1[2];
    c = (B1[0] * B1[0] + B1[1] * B1[1]) + B1[2] * B1[2];
  }

  // ops/projection.py::conic_rescale_radius_components
  const float ac = clamp(a, F(-1e18), F(1e18));
  const float bc = clamp(b, F(-1e18), F(1e18));
  const float cc = clamp(c, F(-1e18), F(1e18));
  const float det_pre = ac * cc - bc * bc;
  const float af = ac + F(0.3), cf = cc + F(0.3);
  const float det = clamp_min(af * cf - bc * bc, F(1e-6));
  const float ratio = clamp_min(det_pre / det, 0.0f);
  const float rescale = ratio > 0.0f ? sqrtf(clamp_min(ratio, F(1e-30))) : 0.0f;
  const float inv_det = 1.0f / det;
  const float lam_max =
      ((ac + cc) + sqrtf((ac - cc) * (ac - cc) + (4.0f * bc) * bc)) * 0.5f;
  const float radius = sqrtf(clamp_min(lam_max, 0.0f)) * 3.0f;

  // ops/attributes.py: opacity and the per-axis cull radius
  const float op = sigmoid(f[7]);
  const float qm = clamp_min(
      2.0f * logf(clamp_min((255.0f * rescale) * op, F(1e-30))), 0.0f);
  const float rx = minimum(radius, sqrtf(qm * clamp_min(a + F(0.3), 0.0f)));
  const float ry = minimum(radius, sqrtf(qm * clamp_min(c + F(0.3), 0.0f)));

  // ops/sh.py::sh_basis of the camera -> point direction
  float basis[16];
  {
    const float dx = x - t[0], dy = y - t[1], dz = z - t[2];
    const float nrm = clamp_min(sqrtf((dx * dx + dz * dz) + dy * dy), F(1e-12));
    const float X = dx / nrm, Y = dy / nrm, Z = dz / nrm;
    const float xx = X * X, yy = Y * Y, zz = Z * Z;
    basis[0] = F(0.28209479177387814) * 1.0f;
    basis[1] = F(-0.48860251190291987) * Y;
    basis[2] = F(0.48860251190291987) * Z;
    basis[3] = F(-0.48860251190291987) * X;
    basis[4] = (F(1.0925484305920792) * X) * Y;
    basis[5] = (F(-1.0925484305920792) * Y) * Z;
    basis[6] = F(0.94617469575755997) * zz - F(0.31539156525251999);
    basis[7] = (F(-1.0925484305920792) * X) * Z;
    basis[8] = F(0.54627421529603959) * xx - F(0.54627421529603959) * yy;
    basis[9] = (F(0.59004358992664352) * Y) * (-3.0f * xx + yy);
    basis[10] = ((F(2.8906114426405538) * X) * Y) * Z;
    basis[11] = (F(0.45704579946446572) * Y) * (1.0f - 5.0f * zz);
    basis[12] = (F(0.3731763325901154) * Z) * (5.0f * zz - 3.0f);
    basis[13] = (F(0.45704579946446572) * X) * (1.0f - 5.0f * zz);
    basis[14] = (F(1.4453057213202769) * Z) * (xx - yy);
    basis[15] = (F(0.59004358992664352) * X) * (-xx + 3.0f * yy);
    for (int k = 0; k < 16; ++k) basis[k] = basis[k] * (k < sh_coeffs ? 1.0f : 0.0f);
  }
  float rgb[3];
  for (int ch = 0; ch < 3; ++ch) {
    float prod[16];
    for (int k = 0; k < 16; ++k) prod[k] = f[8 + 16 * ch + k] * basis[k];
    rgb[ch] = sigmoid(sum16(prod));
  }

  if (row0 != 0.0f) v = v - row0;
  reinterpret_cast<float2*>(uv)[p] = make_float2(u, v);
  cov2d[3 * p] = a;
  cov2d[3 * p + 1] = b;
  cov2d[3 * p + 2] = c;
  reinterpret_cast<float4*>(conic)[p] =
      make_float4(cf * inv_det, -bc * inv_det, af * inv_det, rescale);
  opacity[p] = op;
  for (int ch = 0; ch < 3; ++ch) color[3 * p + ch] = rgb[ch];
  depth[p] = cz;
  reinterpret_cast<float2*>(radius_xy)[p] = make_float2(rx, ry);
}

}  // namespace

// xyz (n, 3), features (n, 56) at a 16-byte aligned address, K (3, 3),
// all f32 row-major; q_pc (4,) and t_pc (3,) the camera pose in the world,
// or (num_poses, 4) / (num_poses, 3) with object_id (n,) int32 picking a
// point's pose (object_id NULL: one pose); sh_coeffs the coefficients a
// channel keeps, (band + 1)^2 in [0, 16]. Outputs (n, 2) uv, (n, 3) cov2d,
// (n, 4) conic, (n,) opacity, (n, 3) colour, (n,) depth, (n, 2)
// radius_xy, every entry written. Launched on `stream`.
extern "C" int point_attributes_launch(
    const float* xyz, const float* features, long long n, const float* q_pc,
    const float* t_pc, const int* object_id, int num_poses, const float* K,
    int sh_coeffs, float row0, float* uv, float* cov2d, float* conic,
    float* opacity, float* color, float* depth, float* radius_xy,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  point_attributes_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      xyz, features, n, q_pc, t_pc, object_id, num_poses, K, sh_coeffs, row0,
      uv, cov2d, conic, opacity, color, depth, radius_xy);
  return (int)cudaGetLastError();
}
