// Ragged contiguous segment sum, read through a permutation: per-key rows
// in sorted key order -> per-point rows.
//
// Replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/
// segment_reduce.py (segment_reduce, _kernel), which resolved key-to-point
// ownership with a membership matrix contracted on the MXU (a bf16x3 split)
// over windows fed by a 3-slot DMA ring, after a payload sort had carried
// the rows back to pre-sort key order. Point p owns the pre-sort slots
// [offsets[p], offsets[p] + counts[p]); slot k's row lane is inv[k] (inv
// NULL: k). Here
//
//   out[r, p] = sum over k in p's slots, in k order, of rows[r, inv[k]],
//
// so the backward needs no regroup of the rows to pre-sort order: it
// reads the blend backward's sorted rows, which the 50 MB L2 still holds,
// through the inverse of the sort's permutation.
//
// Design: one thread a point loads offsets[p] and counts[p] once, and for
// every slot inv[k] once and then the rows' lanes (rows r0 .. r0 + 11 of
// a block's row pass; 12 rows, the backward's, take one pass). Slots are
// taken two at a time, their loads issued before their adds. Segments
// longer than kLong slots (at the Truck cell's full-width frame, 3.7% of
// the points with keys and 14% of the keys, up to 154 slots a point; one
// thread a point would leave a warp 5.6x the even share of key steps) go
// to the block's warps after the short ones:
// the warp loads 32 slots at once, parks their rows in shared memory, and
// lane r adds row r's 32 values in k order. Every sum is thus added in k
// order from 0, as a sequential loop does: the result repeats bit for bit
// and equals the pre-sort lane sum of the first design, with no atomics.
// Stores are coalesced across neighbouring points for each row.
//
// Bound on the H100: bytes. Each row lane, inv, offsets and counts are
// read once and each output written once; but the lanes of one slot lie
// in 12 rows and the slots of one point at random sorted positions, so
// each lane read costs a 32-byte L2 sector.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 12;   // rows a block pass
constexpr int kGroup = 2;   // slots whose loads are issued together
constexpr int kLong = 4;    // longer segments go to a warp

}  // namespace

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ rows, int num_rows,
                      long long cols, const int* __restrict__ inv,
                      const int* __restrict__ offsets,
                      const int* __restrict__ counts, int n,
                      float* __restrict__ out) {
  __shared__ int s_long[kThreads];
  __shared__ int s_nlong;
  __shared__ float s_park[kWarps][32][kRows + 1];
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, num_rows - r0);
  const float* rows_r0 = rows + (size_t)r0 * cols;
  float* out_r0 = out + (size_t)r0 * n;
  if (threadIdx.x == 0) s_nlong = 0;
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n) {
    const long long lo = offsets[p];
    const long long hi = min(lo + (long long)counts[p], cols);
    if (hi - lo > kLong) {
      s_long[atomicAdd(&s_nlong, 1)] = p;  // list order does not matter
    } else {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (long long k = lo; k < hi; k += kGroup) {
        const int m = (int)min((long long)kGroup, hi - k);
        long long lane[kGroup];
        float v[kGroup][kRows];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          lane[g] = g < m ? (inv ? (long long)inv[k + g] : k + g) : 0;
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            v[g][r] = (g < m && r < nr) ? rows_r0[r * cols + lane[g]] : 0.0f;
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (g < m) acc[r] += v[g][r];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) out_r0[(size_t)r * n + p] = acc[r];
    }
  }
  __syncthreads();

  // the long segments: warp w takes list entries w, w + kWarps, ...
  const int w = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  float (*park)[kRows + 1] = s_park[w];
  for (int e = w; e < s_nlong; e += kWarps) {
    const int q = s_long[e];
    const long long lo = offsets[q];
    const long long hi = min(lo + (long long)counts[q], cols);
    float acc = 0.0f;  // lane l < nr: row l
    for (long long k = lo; k < hi; k += 32) {
      const int m = (int)min(32LL, hi - k);
      if (l < m) {
        const long long lane = inv ? (long long)inv[k + l] : k + l;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nr) park[l][r] = rows_r0[r * cols + lane];
      }
      __syncwarp();
      if (l < nr)
        for (int j = 0; j < m; ++j) acc += park[j][l];
      __syncwarp();
    }
    if (l < nr) out_r0[(size_t)l * n + q] = acc;
  }
}

// rows: (num_rows, cols) f32; inv: (cols,) i32 row lane of each slot, a
// permutation of [0, cols), or NULL for the identity; offsets, counts:
// (n,) i32 with 0 <= offsets, 0 <= counts; out: (num_rows, n) f32. Slots
// past cols are not read.
extern "C" int segment_reduce_launch(const float* rows, int num_rows,
                                     long long cols, const int* inv,
                                     const int* offsets, const int* counts,
                                     int n, float* out, cudaStream_t stream) {
  if (num_rows == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads,
                  (num_rows + kRows - 1) / kRows);
  segment_reduce_kernel<<<grid, kThreads, 0, stream>>>(
      rows, num_rows, cols, inv, offsets, counts, n, out);
  return (int)cudaGetLastError();
}
