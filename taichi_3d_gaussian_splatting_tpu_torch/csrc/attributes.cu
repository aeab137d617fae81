// Per-point screen-space attributes in one pass, and their VJP in another:
// what ops/rasterizer.py::compute_raw_attrs returns, and what the train
// step's attrs_vjp maps its cotangents back to.
//
// Replaces no TPU kernel. On the TPU, XLA fuses the attribute stage
// (ops/attributes.py, projection.py, sh.py and the pose inverse of
// ops/transforms.py) and its VJP into a few loops over the points. Eager
// PyTorch runs each as a few hundred elementwise, stack and reduce kernels,
// each reading and writing (N,) to (N, 3, 16) temporaries, and autograd
// keeps the forward's temporaries as its tape; a CUDA graph takes the
// launches' host cost away, not their bytes. The plain version
// (ops/attributes.py::point_attributes_plain, and autograd of it) stays the
// CPU path, the pose-gradient path and the test oracle.
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
// point_attributes_vjp_kernel: one thread a pool slot, and no tape. It
// recomputes the point's forward in registers from xyz, its feature row
// and the pose (the same device functions as the forward, so the forward
// math has one source), then chains the cotangents of uv, conic, opacity
// and colour back through the sigmoids, the SH basis and its normalize,
// the conic and rescale, the EWA covariance, the quaternion normalize and
// the projection to the point's xyz and its 56 feature columns. Every
// guard takes autograd's subgradient: clamp_min and clamp pass the
// gradient where the input lies inside the bound (ends included) and not
// at NaN, _away_from_zero's constant branch and the rescale's `where`
// pass none, and a norm at zero gives zero, so the result is finite
// wherever autograd's is. The SH columns above sh_coeffs get the band
// mask's gradient (zero for a finite colour cotangent). Each row is
// written once by one thread and nothing is summed across threads, so two
// launches give the same bits.
//
// Bound on the H100: bytes. The forward reads 236 bytes a point (xyz and
// the 56 feature columns) and writes 64 (uv, cov2d, conic, opacity,
// colour, depth, the per-axis radius) with some 400 f32 operations; the
// VJP reads those 236 and the 40 bytes of cotangents and writes 236 (the
// gradients of xyz and the features) with about 3x the operations: both far
// under the operation roofline. The block's 128 rows of the row-major
// (N, 56) features are one contiguous range of 28,672 bytes; the block
// reads it with 16-byte loads, neighbouring threads on neighbouring
// addresses, all 14 of a thread in flight at once, into shared memory rows
// padded to 60 floats, so each thread's 16-byte reads of its own row hit 8
// distinct bank groups in every quarter warp. The VJP writes its feature
// gradients into the same rows and stores the block's range back with
// 16-byte stores the same way.
//
// Rounding: built with -fmad=false, and every forward expression keeps the
// operation order of the plain version, one rounding a PyTorch op, so the
// forward's fields equal it bit for bit: the reductions as PyTorch's
// reduce kernel takes them (lane i adds lane i + half, then i + half/2,
// ..., over 16 or 4 lanes, and a 3-element sum as (x0 + x2) + x1), the
// cross product as torch.linalg.cross's kernel contracts a*b - c*d, a
// division by a host scalar as the multiply by its inverse, and every
// constant rounded from the double the Python source gives. The VJP sums
// its chain-rule terms in another order than autograd's engine, so it
// agrees with autograd to f32 rounding, not to the bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 56;     // feature columns a point
constexpr int kVecs = kCols / 4;  // 16-byte loads a row
constexpr int kPitch = 60;    // a row's floats in shared memory

#define F(x) static_cast<float>(x)  // a Python float constant, as torch casts it

// --- the point math both kernels share (begin) ---

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);  // torch.clamp_min: NaN passes
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// autograd's gradient through clamp_min / clamp: where the input lies
// inside the bound, ends included; none at NaN
__device__ __forceinline__ float pass_min(float g, float v, float lo) {
  return v >= lo ? g : 0.0f;
}

__device__ __forceinline__ float pass_clamp(float g, float v, float lo,
                                            float hi) {
  return (v >= lo && v <= hi) ? g : 0.0f;
}

__device__ __forceinline__ float minimum(float a, float b) {
  if (a != a) return a;  // torch.minimum: NaN wins
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ bool near_zero(float z) {
  return fabsf(z) < F(1e-6);
}

__device__ __forceinline__ float away_from_zero(float z) {
  return near_zero(z) ? (z < 0.0f ? F(-1e-6) : F(1e-6)) : z;
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

// the VJP of rotation(): the quaternion's cotangent from R's, G; each
// product's and sum's terms added in the order autograd's engine adds them
// (the last op of the forward first)
__device__ __forceinline__ void rotation_vjp(const float q[4],
                                             const float G[9], float d[4]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float dxx = -G[8] * 2.0f + -G[4] * 2.0f;
  const float dyy = -G[8] * 2.0f + -G[0] * 2.0f;
  const float dzz = -G[4] * 2.0f + -G[0] * 2.0f;
  const float dxy = G[3] * 2.0f + G[1] * 2.0f;
  const float dxz = G[6] * 2.0f + G[2] * 2.0f;
  const float dyz = G[7] * 2.0f + G[5] * 2.0f;
  const float dwx = G[7] * 2.0f + -(G[5] * 2.0f);
  const float dwy = -(G[6] * 2.0f) + G[2] * 2.0f;
  const float dwz = G[3] * 2.0f + -(G[1] * 2.0f);
  d[0] = (((dwx * w + dxz * z) + dxy * y) + dxx * x) + dxx * x;
  d[1] = (((dwy * w + dyz * z) + dxy * x) + dyy * y) + dyy * y;
  d[2] = (((dwz * w + dyz * y) + dxz * x) + dzz * z) + dzz * z;
  d[3] = (dwz * z + dwy * y) + dwx * x;
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

// a normalize v / clamp_min(|v|, 1e-12) (the feature quaternion, the view
// direction): the norm n and the divisor d
struct Norm {
  float n, d;
};

// the VJP of v / clamp_min(|v|, 1e-12) at v (k = 3 or 4 entries) with
// the output u = v / d: the cotangent of v from du's, as autograd forms it
// on the card (the divisor's terms summed as PyTorch's reduce kernel adds
// 3 or 4 lanes; |v|'s gradient dn (v / |v|), none at zero)
template <int k>
__device__ __forceinline__ void normalize_vjp(const float* v, const float* u,
                                              Norm nm, const float* du,
                                              float* dv) {
  float p[4];
  for (int i = 0; i < k; ++i) p[i] = -du[i] * (u[i] / nm.d);
  float dd = (p[0] + p[2]) + p[1];
  if constexpr (k == 4) dd = (p[0] + p[2]) + (p[1] + p[3]);
  const float dn = pass_min(dd, nm.n, F(1e-12));
  for (int i = 0; i < k; ++i)
    dv[i] = du[i] / nm.d + dn * (nm.n == 0.0f ? 0.0f : v[i] / nm.n);
}

// the guarded quaternion normalize of the feature row's columns 0-3
__device__ __forceinline__ Norm unit_quaternion(const float* f, float qn[4]) {
  const float a0 = f[0] * f[0], a1 = f[1] * f[1];
  const float a2 = f[2] * f[2], a3 = f[3] * f[3];
  Norm nm;
  nm.n = sqrtf((a0 + a2) + (a1 + a3));
  nm.d = clamp_min(nm.n, F(1e-12));
  for (int i = 0; i < 4; ++i) qn[i] = f[i] / nm.d;
  return nm;
}

// ops/projection.py::project_point: camera-frame point, 1/z, and the
// numerators of u and v
struct Projection {
  float cx, cy, cz, inv_z, nu, nv;
};

__device__ __forceinline__ Projection project(const float Rc[9],
                                              const float tc[3], float x,
                                              float y, float z,
                                              const float* K) {
  Projection p;
  p.cx = ((Rc[0] * x + Rc[1] * y) + Rc[2] * z) + tc[0];
  p.cy = ((Rc[3] * x + Rc[4] * y) + Rc[5] * z) + tc[1];
  p.cz = ((Rc[6] * x + Rc[7] * y) + Rc[8] * z) + tc[2];
  p.inv_z = 1.0f / away_from_zero(p.cz);
  p.nu = (K[0] * p.cx + K[1] * p.cy) + K[2] * p.cz;
  p.nv = (K[3] * p.cx + K[4] * p.cy) + K[5] * p.cz;
  return p;
}

// ops/projection.py::project_cov2d_components: B = (J R_cw)(R(q) diag(s))
// row by row (P: before the scale), and (a, b, c) of B B^T
struct Ewa {
  float jx, jy, jxz, jyz;
  float A0[3], A1[3], Rq[9], s[3], P0[3], P1[3], B0[3], B1[3];
  float a, b, c;
};

__device__ __forceinline__ void ewa(const float* K, const Projection& p,
                                    const float Rc[9], const float qn[4],
                                    const float* log_scale, Ewa& e) {
  e.jx = K[0] * p.inv_z;
  e.jy = K[4] * p.inv_z;
  e.jxz = ((-K[0] * p.cx) * p.inv_z) * p.inv_z;
  e.jyz = ((-K[4] * p.cy) * p.inv_z) * p.inv_z;
  for (int i = 0; i < 3; ++i) {
    e.A0[i] = e.jx * Rc[i] + e.jxz * Rc[6 + i];
    e.A1[i] = e.jy * Rc[3 + i] + e.jyz * Rc[6 + i];
  }
  rotation(qn[0], qn[1], qn[2], qn[3], e.Rq);
  for (int k = 0; k < 3; ++k) {
    e.s[k] = expf(log_scale[k]);
    e.P0[k] = (e.A0[0] * e.Rq[k] + e.A0[1] * e.Rq[3 + k]) +
              e.A0[2] * e.Rq[6 + k];
    e.P1[k] = (e.A1[0] * e.Rq[k] + e.A1[1] * e.Rq[3 + k]) +
              e.A1[2] * e.Rq[6 + k];
    e.B0[k] = e.P0[k] * e.s[k];
    e.B1[k] = e.P1[k] * e.s[k];
  }
  e.a = (e.B0[0] * e.B0[0] + e.B0[1] * e.B0[1]) + e.B0[2] * e.B0[2];
  e.b = (e.B0[0] * e.B1[0] + e.B0[1] * e.B1[1]) + e.B0[2] * e.B1[2];
  e.c = (e.B1[0] * e.B1[0] + e.B1[1] * e.B1[1]) + e.B1[2] * e.B1[2];
}

// ops/projection.py::conic_rescale_radius_components but the radius:
// the clamped covariance, the filtered one, the determinants and the
// rescale; the conic is (cf, -bc, af) * inv_det
struct Conic {
  float ac, bc, cc, af, cf, det_pre, det_raw, det, quot, ratio, rescale,
      inv_det;
};

__device__ __forceinline__ Conic conic(float a, float b, float c) {
  Conic k;
  k.ac = clamp(a, F(-1e18), F(1e18));
  k.bc = clamp(b, F(-1e18), F(1e18));
  k.cc = clamp(c, F(-1e18), F(1e18));
  k.det_pre = k.ac * k.cc - k.bc * k.bc;
  k.af = k.ac + F(0.3);
  k.cf = k.cc + F(0.3);
  k.det_raw = k.af * k.cf - k.bc * k.bc;
  k.det = clamp_min(k.det_raw, F(1e-6));
  k.quot = k.det_pre / k.det;
  k.ratio = clamp_min(k.quot, 0.0f);
  k.rescale = k.ratio > 0.0f ? sqrtf(clamp_min(k.ratio, F(1e-30))) : 0.0f;
  k.inv_det = 1.0f / k.det;
  return k;
}

// ops/sh.py::sh_basis of the camera -> point direction (dx, dy, dz), the
// bands above sh_coeffs multiplied by 0 (ops/attributes.py's band mask)
struct Basis {
  Norm nm;
  float X, Y, Z, v[16];
};

constexpr double kC1 = 0.48860251190291987, kC4 = 1.0925484305920792,
                 kC6 = 0.94617469575755997, kC6b = 0.31539156525251999,
                 kC8 = 0.54627421529603959, kC9 = 0.59004358992664352,
                 kC10 = 2.8906114426405538, kC11 = 0.45704579946446572,
                 kC12 = 0.3731763325901154, kC14 = 1.4453057213202769;

__device__ __forceinline__ void sh_basis(float dx, float dy, float dz,
                                         int sh_coeffs, Basis& b) {
  b.nm.n = sqrtf((dx * dx + dz * dz) + dy * dy);
  b.nm.d = clamp_min(b.nm.n, F(1e-12));
  const float X = dx / b.nm.d, Y = dy / b.nm.d, Z = dz / b.nm.d;
  b.X = X;
  b.Y = Y;
  b.Z = Z;
  const float xx = X * X, yy = Y * Y, zz = Z * Z;
  float* v = b.v;
  v[0] = F(0.28209479177387814) * 1.0f;
  v[1] = F(-kC1) * Y;
  v[2] = F(kC1) * Z;
  v[3] = F(-kC1) * X;
  v[4] = (F(kC4) * X) * Y;
  v[5] = (F(-kC4) * Y) * Z;
  v[6] = F(kC6) * zz - F(kC6b);
  v[7] = (F(-kC4) * X) * Z;
  v[8] = F(kC8) * xx - F(kC8) * yy;
  v[9] = (F(kC9) * Y) * (-3.0f * xx + yy);
  v[10] = ((F(kC10) * X) * Y) * Z;
  v[11] = (F(kC11) * Y) * (1.0f - 5.0f * zz);
  v[12] = (F(kC12) * Z) * (5.0f * zz - 3.0f);
  v[13] = (F(kC11) * X) * (1.0f - 5.0f * zz);
  v[14] = (F(kC14) * Z) * (xx - yy);
  v[15] = (F(kC9) * X) * (-xx + 3.0f * yy);
  for (int k = 0; k < 16; ++k) v[k] = v[k] * (k < sh_coeffs ? 1.0f : 0.0f);
}

// the VJP of sh_basis' 16 values (g: their cotangents, the band mask
// applied) to the unit direction's (dX, dY, dZ), each sum in autograd's
// order (the last term of the basis first)
__device__ __forceinline__ void sh_basis_vjp(const Basis& b, const float g[16],
                                             float d[3]) {
  const float X = b.X, Y = b.Y, Z = b.Z;
  const float xx = X * X, yy = Y * Y, zz = Z * Z;
  // the terms' first factors and second factors, as the forward forms them
  const float t4 = F(kC4) * X, t5 = F(-kC4) * Y, t7 = F(-kC4) * X;
  const float t9 = F(kC9) * Y, t10a = F(kC10) * X, t10b = t10a * Y;
  const float t11 = F(kC11) * Y, t12 = F(kC12) * Z, t13 = F(kC11) * X;
  const float t14 = F(kC14) * Z, t15 = F(kC9) * X;
  const float w9 = -3.0f * xx + yy, w11 = 1.0f - 5.0f * zz;
  const float w12 = 5.0f * zz - 3.0f, w14 = xx - yy;
  const float w15 = -xx + 3.0f * yy;
  const float dxx = ((-(g[15] * t15) + g[14] * t14) + (g[9] * t9) * -3.0f) +
                    g[8] * F(kC8);
  const float dyy = (((g[15] * t15) * 3.0f + -(g[14] * t14)) + g[9] * t9) +
                    -g[8] * F(kC8);
  const float dzz = (((-(g[13] * t13)) * 5.0f + (g[12] * t12) * 5.0f) +
                     (-(g[11] * t11)) * 5.0f) +
                    g[6] * F(kC6);
  d[0] = ((((((g[15] * w15) * F(kC9) + (g[13] * w11) * F(kC11)) +
             ((g[10] * Z) * Y) * F(kC10)) +
            (g[7] * Z) * F(-kC4)) +
           (g[4] * Y) * F(kC4)) +
          g[3] * F(-kC1)) +
         dxx * X;
  d[0] = d[0] + dxx * X;
  d[1] = ((((((g[11] * w11) * F(kC11) + (g[10] * Z) * t10a) +
             (g[9] * w9) * F(kC9)) +
            (g[5] * Z) * F(-kC4)) +
           g[4] * t4) +
          g[1] * F(-kC1)) +
         dyy * Y;
  d[1] = d[1] + dyy * Y;
  d[2] = ((((((g[14] * w14) * F(kC14) + (g[12] * w12) * F(kC12)) +
             g[10] * t10b) +
            g[7] * t7) +
           g[5] * t5) +
          g[2] * F(kC1)) +
         dzz * Z;
  d[2] = d[2] + dzz * Z;
}

// One point's fields from its xyz, its feature row f, the pose (q, t) and
// K: what point_attributes_kernel writes, but v's row0 shift
struct Fields {
  float u, v, a, b, c, conic[4], op, rgb[3], depth, rx, ry;
};

__device__ __forceinline__ void point_forward(const float* f, float x,
                                              float y, float z,
                                              const float* q, const float* t,
                                              const float* K, int sh_coeffs,
                                              Fields& o) {
  float Rc[9], tc[3];
  camera_from_pose(q, t, Rc, tc);
  float qn[4];
  unit_quaternion(f, qn);
  const Projection pr = project(Rc, tc, x, y, z, K);
  o.u = pr.nu * pr.inv_z;
  o.v = pr.nv * pr.inv_z;
  o.depth = pr.cz;
  Ewa e;
  ewa(K, pr, Rc, qn, f + 4, e);
  o.a = e.a;
  o.b = e.b;
  o.c = e.c;
  const Conic k = conic(e.a, e.b, e.c);
  o.conic[0] = k.cf * k.inv_det;
  o.conic[1] = -k.bc * k.inv_det;
  o.conic[2] = k.af * k.inv_det;
  o.conic[3] = k.rescale;
  const float lam_max =
      ((k.ac + k.cc) +
       sqrtf((k.ac - k.cc) * (k.ac - k.cc) + (4.0f * k.bc) * k.bc)) *
      0.5f;
  const float radius = sqrtf(clamp_min(lam_max, 0.0f)) * 3.0f;

  // ops/attributes.py: opacity and the per-axis cull radius
  o.op = sigmoid(f[7]);
  const float qm = clamp_min(
      2.0f * logf(clamp_min((255.0f * k.rescale) * o.op, F(1e-30))), 0.0f);
  o.rx = minimum(radius, sqrtf(qm * clamp_min(e.a + F(0.3), 0.0f)));
  o.ry = minimum(radius, sqrtf(qm * clamp_min(e.c + F(0.3), 0.0f)));

  Basis bs;
  sh_basis(x - t[0], y - t[1], z - t[2], sh_coeffs, bs);
  for (int ch = 0; ch < 3; ++ch) {
    float prod[16];
    for (int j = 0; j < 16; ++j) prod[j] = f[8 + 16 * ch + j] * bs.v[j];
    o.rgb[ch] = sigmoid(sum16(prod));
  }
}

// The VJP of one point's (uv, conic, opacity, colour) from its xyz, its
// feature row f (read; its columns 0-55 are overwritten by their
// gradients), the pose (q, t) and K: d_xyz gets xyz's gradient. Each
// gradient that sums several terms adds them in the order autograd's
// engine adds them for ops/attributes.py::point_attributes_plain (the
// consumer made last in the forward first), so a cancellation that leaves
// autograd's result at rounding level leaves this one there too.
__device__ __forceinline__ void point_vjp(float* f, float x, float y,
                                          float z, const float* q,
                                          const float* t, const float* K,
                                          int sh_coeffs, float du, float dv,
                                          const float dcon[4], float dop,
                                          const float dcol[3],
                                          float d_xyz[3]) {
  float Rc[9], tc[3];
  camera_from_pose(q, t, Rc, tc);

  // colour = sigmoid(sum(sh * basis)): the SH columns take d_raw * basis,
  // the basis the three channels' d_raw * sh, summed in channel order
  const float dir[3] = {x - t[0], y - t[1], z - t[2]};
  Basis bs;
  sh_basis(dir[0], dir[1], dir[2], sh_coeffs, bs);
  float g[16];
  for (int ch = 0; ch < 3; ++ch) {
    float* sh = f + 8 + 16 * ch;
    float prod[16];
    for (int k = 0; k < 16; ++k) prod[k] = sh[k] * bs.v[k];
    const float col = sigmoid(sum16(prod));
    const float d_raw = (dcol[ch] * (1.0f - col)) * col;
    for (int k = 0; k < 16; ++k) {
      g[k] = ch == 0 ? d_raw * sh[k] : g[k] + d_raw * sh[k];
      sh[k] = d_raw * bs.v[k];
    }
  }
  for (int k = 0; k < 16; ++k) g[k] = g[k] * (k < sh_coeffs ? 1.0f : 0.0f);
  float d_unit[3], d_dir[3];
  sh_basis_vjp(bs, g, d_unit);
  const float unit[3] = {bs.X, bs.Y, bs.Z};
  normalize_vjp<3>(dir, unit, bs.nm, d_unit, d_dir);

  // opacity = sigmoid(f[7])
  const float op = sigmoid(f[7]);
  const float d_alpha = (dop * (1.0f - op)) * op;

  // the forward of the covariance and conic, again
  float qn[4];
  const Norm qnm = unit_quaternion(f, qn);
  const Projection p = project(Rc, tc, x, y, z, K);
  Ewa e;
  ewa(K, p, Rc, qn, f + 4, e);
  const Conic k = conic(e.a, e.b, e.c);

  // conic = (cf, -bc, af) * inv_det, inv_det = 1 / det, and the rescale
  // where(ratio > 0, sqrt(clamp_min(ratio, 1e-30)), 0), ratio =
  // clamp_min(det_pre / det, 0), det = clamp_min(af cf - bc^2, 1e-6)
  const float d_inv =
      (dcon[2] * k.af + dcon[1] * -k.bc) + dcon[0] * k.cf;
  float d_det = -d_inv * (k.inv_det * k.inv_det);
  const float d_sqrt = k.ratio > 0.0f ? dcon[3] : 0.0f;
  const float d_ratio =
      pass_min(d_sqrt / (2.0f * sqrtf(clamp_min(k.ratio, F(1e-30)))),
               k.ratio, F(1e-30));
  const float d_quot = pass_min(d_ratio, k.quot, 0.0f);
  const float d_pre = d_quot / k.det;
  d_det = d_det + -d_quot * (k.quot / k.det);
  const float d_raw_det = pass_min(d_det, k.det_raw, F(1e-6));
  const float d_af = dcon[2] * k.inv_det + d_raw_det * k.cf;
  const float d_cf = dcon[0] * k.inv_det + d_raw_det * k.af;
  const float d_bc = (((-(dcon[1] * k.inv_det) + -(d_raw_det * k.bc)) +
                       -(d_raw_det * k.bc)) +
                      -(d_pre * k.bc)) +
                     -(d_pre * k.bc);
  const float da = pass_clamp(d_af + d_pre * k.cc, e.a, F(-1e18), F(1e18));
  const float db = pass_clamp(d_bc, e.b, F(-1e18), F(1e18));
  const float dc = pass_clamp(d_cf + d_pre * k.ac, e.c, F(-1e18), F(1e18));

  // a, b, c = B0.B0, B0.B1, B1.B1; B = P * s; P = A Rq; s = exp(log_scale)
  float dP0[3], dP1[3], d_log_scale[3];
  for (int j = 0; j < 3; ++j) {
    const float dB0 = (db * e.B1[j] + da * e.B0[j]) + da * e.B0[j];
    const float dB1 = (dc * e.B1[j] + dc * e.B1[j]) + db * e.B0[j];
    dP0[j] = dB0 * e.s[j];
    dP1[j] = dB1 * e.s[j];
    d_log_scale[j] = (dB1 * e.P1[j] + dB0 * e.P0[j]) * e.s[j];
  }
  float dA0[3], dA1[3], G[9];
  for (int i = 0; i < 3; ++i) {
    const float* r = e.Rq + 3 * i;
    dA0[i] = (dP0[2] * r[2] + dP0[1] * r[1]) + dP0[0] * r[0];
    dA1[i] = (dP1[2] * r[2] + dP1[1] * r[1]) + dP1[0] * r[0];
    for (int j = 0; j < 3; ++j)
      G[3 * i + j] = dP1[j] * e.A1[i] + dP0[j] * e.A0[i];
  }
  float d_qn[4], d_quat[4];
  rotation_vjp(qn, G, d_qn);
  normalize_vjp<4>(f, qn, qnm, d_qn, d_quat);

  // A0 = jx R0 + jxz R2, A1 = jy R1 + jyz R2; jx = fx inv_z, jxz =
  // ((-fx cx) inv_z) inv_z, jy, jyz alike; inv_z = 1 / away_from_zero(cz)
  const float d_jx = (dA0[2] * Rc[2] + dA0[1] * Rc[1]) + dA0[0] * Rc[0];
  const float d_jxz = (dA0[2] * Rc[8] + dA0[1] * Rc[7]) + dA0[0] * Rc[6];
  const float d_jy = (dA1[2] * Rc[5] + dA1[1] * Rc[4]) + dA1[0] * Rc[3];
  const float d_jyz = (dA1[2] * Rc[8] + dA1[1] * Rc[7]) + dA1[0] * Rc[6];
  const float fx = K[0], fy = K[4];
  const float m1x = -fx * p.cx, m1y = -fy * p.cy;
  const float dm2x = d_jxz * p.inv_z, dm2y = d_jyz * p.inv_z;
  const float d_inv_cov = ((((d_jyz * (m1y * p.inv_z) + dm2y * m1y) +
                             d_jxz * (m1x * p.inv_z)) +
                            dm2x * m1x) +
                           d_jy * fy) +
                          d_jx * fx;
  const bool passes = !near_zero(p.cz);  // _away_from_zero's subgradient
  const float d_cz_cov =
      passes ? -d_inv_cov * (p.inv_z * p.inv_z) : 0.0f;

  // u, v = (nu, nv) inv_z with its own 1 / away_from_zero(cz); nu = K0 c
  const float d_inv_uv = dv * p.nv + du * p.nu;
  const float dnu = du * p.inv_z, dnv = dv * p.inv_z;
  const float dcx = ((dm2x * p.inv_z) * -fx + dnv * K[3]) + dnu * K[0];
  const float dcy = ((dm2y * p.inv_z) * -fy + dnv * K[4]) + dnu * K[1];
  float dcz = (d_cz_cov + dnv * K[5]) + dnu * K[2];
  if (passes) dcz = dcz + -d_inv_uv * (p.inv_z * p.inv_z);

  // camera point = Rc xyz + tc; the SH direction = xyz - t
  for (int i = 0; i < 3; ++i)
    d_xyz[i] = d_dir[i] + ((dcz * Rc[6 + i] + dcy * Rc[3 + i]) + dcx * Rc[i]);
  for (int i = 0; i < 4; ++i) f[i] = d_quat[i];
  for (int i = 0; i < 3; ++i) f[4 + i] = d_log_scale[i];
  f[7] = d_alpha;
}

// the pose of point p: the one pose, or that of its object id; false where
// the id names no pose
__device__ __forceinline__ bool pose_of(const float* q_pc, const float* t_pc,
                                        const int* object_id, int num_poses,
                                        long long p, const float** q,
                                        const float** t) {
  *q = q_pc;
  *t = t_pc;
  if (object_id == nullptr) return true;
  const int id = object_id[p];
  if (id < 0 || id >= num_poses) return false;
  *q += 4 * id;
  *t += 3 * id;
  return true;
}

// --- the point math both kernels share (end) ---

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

// The reverse: shared memory rows [0, rows) to the block's range of an
// (n, 56) output, 16-byte stores, neighbouring threads on neighbouring
// addresses
__device__ __forceinline__ void store_rows(const float* src, int rows,
                                           float* __restrict__ dst) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int n4 = rows * kVecs;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int k = j * kThreads + threadIdx.x;
    const int r = k / kVecs;
    if (k < n4)
      d4[k] = *reinterpret_cast<const float4*>(src + r * kPitch +
                                               (k - r * kVecs) * 4);
  }
}

__global__ void __launch_bounds__(kThreads) point_attributes_kernel(
    const float* __restrict__ xyz, const float* __restrict__ features,
    long long n, const float* __restrict__ q_pc,
    const float* __restrict__ t_pc, const int* __restrict__ object_id,
    int num_poses, const float* __restrict__ K, int sh_coeffs, float row0,
    float* __restrict__ uv, float* __restrict__ cov2d,
    float* __restrict__ conic_out, float* __restrict__ opacity,
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

  const float* q;
  const float* t;
  if (!pose_of(q_pc, t_pc, object_id, num_poses, p, &q, &t)) {
    const float nan = __int_as_float(0x7fc00000);  // no such pose: NaN
    uv[2 * p] = uv[2 * p + 1] = nan;
    for (int i = 0; i < 3; ++i) cov2d[3 * p + i] = color[3 * p + i] = nan;
    for (int i = 0; i < 4; ++i) conic_out[4 * p + i] = nan;
    opacity[p] = depth[p] = radius_xy[2 * p] = radius_xy[2 * p + 1] = nan;
    return;
  }
  Fields o;
  point_forward(f, xyz[3 * p], xyz[3 * p + 1], xyz[3 * p + 2], q, t, K,
                sh_coeffs, o);
  const float v = row0 != 0.0f ? o.v - row0 : o.v;
  reinterpret_cast<float2*>(uv)[p] = make_float2(o.u, v);
  cov2d[3 * p] = o.a;
  cov2d[3 * p + 1] = o.b;
  cov2d[3 * p + 2] = o.c;
  reinterpret_cast<float4*>(conic_out)[p] =
      make_float4(o.conic[0], o.conic[1], o.conic[2], o.conic[3]);
  opacity[p] = o.op;
  for (int ch = 0; ch < 3; ++ch) color[3 * p + ch] = o.rgb[ch];
  depth[p] = o.depth;
  reinterpret_cast<float2*>(radius_xy)[p] = make_float2(o.rx, o.ry);
}

__global__ void __launch_bounds__(kThreads) point_attributes_vjp_kernel(
    const float* __restrict__ xyz, const float* __restrict__ features,
    long long n, const float* __restrict__ q_pc,
    const float* __restrict__ t_pc, const int* __restrict__ object_id,
    int num_poses, const float* __restrict__ K, int sh_coeffs,
    const float* __restrict__ d_uv, const float* __restrict__ d_conic,
    const float* __restrict__ d_opacity, const float* __restrict__ d_color,
    float* __restrict__ d_xyz, float* __restrict__ d_features) {
  __shared__ __align__(16) float rows[kThreads * kPitch];
  const long long first = (long long)blockIdx.x * kThreads;
  const int count = (int)min((long long)kThreads, n - first);
  stage_rows(features + first * kCols, count, rows);
  __syncthreads();
  if ((int)threadIdx.x < count) {
    const long long p = first + threadIdx.x;
    float* f = rows + threadIdx.x * kPitch;
    const float* q;
    const float* t;
    float g[3];
    if (pose_of(q_pc, t_pc, object_id, num_poses, p, &q, &t)) {
      const float2 duv = reinterpret_cast<const float2*>(d_uv)[p];
      const float4 dc4 = reinterpret_cast<const float4*>(d_conic)[p];
      const float dcon[4] = {dc4.x, dc4.y, dc4.z, dc4.w};
      const float dcol[3] = {d_color[3 * p], d_color[3 * p + 1],
                             d_color[3 * p + 2]};
      point_vjp(f, xyz[3 * p], xyz[3 * p + 1], xyz[3 * p + 2], q, t, K,
                sh_coeffs, duv.x, duv.y, dcon, d_opacity[p], dcol, g);
    } else {
      const float nan = __int_as_float(0x7fc00000);  // no such pose: NaN
      for (int i = 0; i < kCols; ++i) f[i] = nan;
      g[0] = g[1] = g[2] = nan;
    }
    for (int i = 0; i < 3; ++i) d_xyz[3 * p + i] = g[i];
  }
  __syncthreads();
  store_rows(rows, count, d_features + first * kCols);
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

// The VJP of point_attributes_launch's uv, conic, opacity and colour, at
// the same inputs (but row0, which moves no gradient): cotangents d_uv
// (n, 2), d_conic (n, 4), d_opacity (n,), d_color (n, 3), f32 row-major.
// Outputs d_xyz (n, 3) and d_features (n, 56) at a 16-byte aligned
// address, every entry written. Launched on `stream`.
extern "C" int point_attributes_vjp_launch(
    const float* xyz, const float* features, long long n, const float* q_pc,
    const float* t_pc, const int* object_id, int num_poses, const float* K,
    int sh_coeffs, const float* d_uv, const float* d_conic,
    const float* d_opacity, const float* d_color, float* d_xyz,
    float* d_features, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  point_attributes_vjp_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      xyz, features, n, q_pc, t_pc, object_id, num_poses, K, sh_coeffs, d_uv,
      d_conic, d_opacity, d_color, d_xyz, d_features);
  return (int)cudaGetLastError();
}
