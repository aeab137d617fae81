// The Adam update of the train step's two leaves (the features (N, 56) and
// the positions (N, 3)) in one pass over their bytes: what
// training/trainer.py::Adam.update_plain computes, leaf by leaf.
//
// Replaces no TPU kernel. On the TPU the update is optax's adam, which XLA
// fuses into one loop a leaf. Eager PyTorch runs the plain formula as 14
// full-size passes a leaf ((1-b1)·g, b1·mu, their sum, g·g, (1-b2)·g², b2·nu,
// their sum, the two multiplies by the bias corrections' reciprocals, sqrt,
// +eps, the division, (-lr)·u, p + that), each reading its inputs from
// device memory and writing a temporary: about 132 bytes an element. The
// plain version stays the CPU path and the test oracle.
//
// Bound on the H100: bytes. An element reads its gradient, parameter, mu
// and nu and writes the three new ones: 28 bytes, at 59 elements a point
// 1,652 bytes. Over 3.35 TB/s that is 0.211 ms at 428,687 points, 1.026 ms
// at 2.08M and 3.008 ms at 6.1M; the few operations an element are far
// under the operation roofline. So the kernel is a byte stream: each leaf
// is a flat array of n f32 values, a thread takes 16 bytes (float4) of each
// of the four inputs, neighbouring threads on neighbouring addresses, with
// all four loads in flight before any arithmetic, and stores the three
// results with streaming stores (nothing reads them again in this pass).
// One thread a float4 gives some 6M threads at 428,687 points: every SM is
// full for many waves. The ragged tail of n mod 4 values, and a leaf whose
// streams do not all start on a 16-byte boundary, take the scalar path.
// Both leaves go in one launch: the first blocks take the first leaf, the
// rest the second, each with its own count, bias tables and rate.
//
// The scalars stay on the device, so a CUDA graph replays the launch with
// no host value baked in: a leaf's update count (int64), read and written
// back plus one by the leaf's first thread into a new tensor; Adam's bias
// corrections read from the host-made tables 1 - b**c (trainer._bias_table)
// at the new count, clamped to the table's last row (where it reads 1.0);
// and the learning rate, either a () f32 device tensor (the position rate's
// staircase, computed in f64 and cast by the wrapper) or a host constant.
//
// Rounding: every operation of the plain formula, as a separately rounded
// f32 operation in its order (round-to-nearest intrinsics, so no
// contraction into an FMA whatever the flags): mu' = c1·g + b1·mu and
// nu' = c2·(g·g) + b2·nu with the constants the f32 casts of the Python
// doubles the plain formula multiplies by; mu'·(1/bc1) and nu'·(1/bc2) with
// the reciprocal an IEEE division, as PyTorch divides by a device scalar on
// a card (trainer._over); IEEE sqrt, + eps and an IEEE division; then
// p + (-lr)·u. So p', mu' and nu' equal the plain formula's on a card bit
// for bit.
#include <cuda_runtime.h>

// One leaf: its flat streams, its count and bias tables, and the f32
// constants of the formula. Mirrored by trainer._AdamLeaf (ctypes).
struct AdamLeaf {
  const float* grad;
  const float* param;
  const float* mu;
  const float* nu;
  float* param_out;
  float* mu_out;
  float* nu_out;
  const long long* count;  // () updates applied before this one
  long long* count_out;    // () count + 1
  const float* bias1;      // (len1,) 1 - b1**c
  const float* bias2;      // (len2,) 1 - b2**c
  const float* lr;         // () device rate, or null: neg_lr is the rate
  long long n;             // elements
  long long vec4;          // float4 units (0: the scalar path throughout)
  long long units;         // vec4 + the scalar elements after them
  int len1;
  int len2;
  float c1, b1, c2, b2, eps, neg_lr;
};
static_assert(sizeof(AdamLeaf) == 152, "trainer._AdamLeaf's layout");

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float r1, r2, neg_lr;  // 1/bc1, 1/bc2, -lr
};

__device__ __forceinline__ void adam(const AdamLeaf& L, const Scalars& s,
                                     float g, float p, float m, float v,
                                     float& p_out, float& m_out,
                                     float& v_out) {
  m_out = __fadd_rn(__fmul_rn(L.c1, g), __fmul_rn(L.b1, m));
  v_out = __fadd_rn(__fmul_rn(L.c2, __fmul_rn(g, g)), __fmul_rn(L.b2, v));
  const float u = __fdiv_rn(
      __fmul_rn(m_out, s.r1),
      __fadd_rn(__fsqrt_rn(__fmul_rn(v_out, s.r2)), L.eps));
  p_out = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
}

__device__ __forceinline__ void update_leaf(const AdamLeaf& L,
                                            long long i) {
  if (i == 0) *L.count_out = *L.count + 1;
  if (i >= L.units) return;
  // the stream's loads first, so they are in flight under the scalars'
  float4 g, p, m, v;
  long long e = 0;  // the scalar path's element
  const bool vec = i < L.vec4;
  if (vec) {
    g = __ldcs(reinterpret_cast<const float4*>(L.grad) + i);
    p = __ldcs(reinterpret_cast<const float4*>(L.param) + i);
    m = __ldcs(reinterpret_cast<const float4*>(L.mu) + i);
    v = __ldcs(reinterpret_cast<const float4*>(L.nu) + i);
  } else {
    e = 4 * L.vec4 + (i - L.vec4);
    g.x = __ldcs(L.grad + e);
    p.x = __ldcs(L.param + e);
    m.x = __ldcs(L.mu + e);
    v.x = __ldcs(L.nu + e);
  }
  const long long c = *L.count + 1;
  Scalars s;
  s.r1 = __fdiv_rn(1.0f, L.bias1[c < L.len1 ? c : L.len1 - 1]);
  s.r2 = __fdiv_rn(1.0f, L.bias2[c < L.len2 ? c : L.len2 - 1]);
  s.neg_lr = L.lr != nullptr ? -*L.lr : L.neg_lr;
  float4 po, mo, vo;
  if (vec) {
    adam(L, s, g.x, p.x, m.x, v.x, po.x, mo.x, vo.x);
    adam(L, s, g.y, p.y, m.y, v.y, po.y, mo.y, vo.y);
    adam(L, s, g.z, p.z, m.z, v.z, po.z, mo.z, vo.z);
    adam(L, s, g.w, p.w, m.w, v.w, po.w, mo.w, vo.w);
    __stcs(reinterpret_cast<float4*>(L.param_out) + i, po);
    __stcs(reinterpret_cast<float4*>(L.mu_out) + i, mo);
    __stcs(reinterpret_cast<float4*>(L.nu_out) + i, vo);
  } else {
    adam(L, s, g.x, p.x, m.x, v.x, po.x, mo.x, vo.x);
    __stcs(L.param_out + e, po.x);
    __stcs(L.mu_out + e, mo.x);
    __stcs(L.nu_out + e, vo.x);
  }
}

// Blocks [0, blocks_a) update leaf a, the rest leaf b; a thread one unit.
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const AdamLeaf a, const AdamLeaf b,
                       unsigned blocks_a) {
  if (blockIdx.x < blocks_a) {
    update_leaf(a, (long long)blockIdx.x * kThreads + threadIdx.x);
  } else {
    update_leaf(b, (long long)(blockIdx.x - blocks_a) * kThreads +
                       threadIdx.x);
  }
}

long long blocks_of(const AdamLeaf& L) {
  const long long blocks = (L.units + kThreads - 1) / kThreads;
  return blocks > 0 ? blocks : 1;  // a leaf's first thread writes its count
}

}  // namespace

// The update of num_leaves (1 or 2) leaves, as described above; every
// stream f32, `vec4` nonzero only where all seven start 16-byte aligned.
// Launched on `stream`; returns the cudaError_t of the launch.
extern "C" int adam_update_launch(const AdamLeaf* leaves, int num_leaves,
                                  cudaStream_t stream) {
  if (num_leaves < 1 || num_leaves > 2) return (int)cudaErrorInvalidValue;
  const long long blocks_a = blocks_of(leaves[0]);
  const long long blocks = blocks_a + (num_leaves == 2
                                       ? blocks_of(leaves[1]) : 0);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  adam_update_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      leaves[0], leaves[num_leaves == 2 ? 1 : 0], (unsigned)blocks_a);
  return (int)cudaGetLastError();
}
