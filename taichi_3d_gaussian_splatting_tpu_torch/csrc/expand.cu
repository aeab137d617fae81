// Key expansion in two passes around the sort: the keys before it (K1a),
// the blend table after it (K1b).
//
// Replaces the TPU kernel taichi_3d_gaussian_splatting_tpu/ops/expand.py
// (expand_keys, _expand_kernel), which broadcast point columns to key
// slots with a one-hot matmul and wrote the (16, key_cap) table in
// pre-sort order for the sort to carry as its payload. On the H100 a
// payload sort is a gather of the 30 MB table after the sort; here the
// table is written once, after the sort, in sorted order.
//
// K1a, slot_keys_kernel: one pass over the key slots. Slot k belongs to
// the last point p with offsets[p] <= k (a zero-count point after the
// owner starts past k). A block takes a run of 512 consecutive slots, so
// its owners are a run of consecutive points: warp 0 finds the run's two
// ends by a 16-way search of the offsets in global memory (two searches
// at once, one a half-warp), the block stages the run's offsets in shared
// memory, and each thread takes 4 consecutive slots, finds its first
// owner by binary search in shared memory and walks on from it. A run of
// more points than the stage holds (many zero-count points) searches in
// global memory instead. For each slot, as the TPU kernel did: the
// u-major tile decode j = k - off, du = j / h, dv = j - du h, tid = base +
// du + dv tiles_u; with exact_cull, the exact (point, tile) cull: the pair
// goes to the sentinel when the blend quadratic's minimum over the tile's
// pixel-centre rectangle exceeds logro + log 255 + margin; the fused int32
// sort key (tid << dbits) + dkey or the sentinel. It writes the fused key
// and the owner of every slot, 16-byte stores. In its capped mode (the
// windowed train step's static key capacity) the buffer holds `total` =
// key_cap slots and the key total is read from device memory, so no host
// sync sizes the launch: the slots of the first min(key total, key_cap)
// decode as above, the rest are padding (the sentinel, owner 0), and the
// keys of slots past key_cap, the surplus keys of the highest-index
// points, are dropped, as the TPU kernel drops them.
//
// K1b, sorted_table_kernel: one pass over the sorted positions i. With
// s = perm[i] (perm NULL: s = i), p = owner[s], tid = fused_s[i] >> dbits
// and valid = fused_s[i] != sentinel, it writes column i of the (16,
// total) table: rows 0..9 = u_local, v_local, conic a, b, c, logro, r, g,
// b, depth; row 10 = p; rows 11..15 = 0; u_local = v_local = 0 for a
// sentinel key. The tile of a live key is the one of its sorted fused key,
// which equals the slot decode (dkey < 2^dbits). A thread takes one
// position, so a warp's stores to a row are 128 consecutive bytes and
// the most threads keep their dependent gathers (perm, owner, the point)
// in flight. perm is read as the int64 the sort returns: a cast to int32
// would cost a launch and more bytes than it saves.
//
// Both read the (10, N) row-major point columns with non-finite entries
// as 0, so the caller needs no pass of its own to clean them. K1b gathers
// a key's point at random: ten 32-byte sectors a key (a point-major
// layout would take two, but the attribute stage would have to build it
// with strided writes).
//
// Bound on the H100: bytes. Per key K1a writes 8 bytes and K1b reads 12
// (perm, fused) and writes 64; the point columns are read once.
//
// Rounding: built with -fmad=false, and every expression keeps the
// operation order of the plain PyTorch version (ops/expand.py), so the
// cull decisions and the table agree with it bit for bit. The rectangle
// minimum is csrc/conic_cull.cuh's, which the blend kernels share (a
// degenerate conic gives NaN and keeps its key).
#include <cuda_runtime.h>

#include "conic_cull.cuh"

namespace {

constexpr int kSlotThreads = 128;
constexpr int kSlotsPerThread = 4;
constexpr int kRun = kSlotThreads * kSlotsPerThread;  // slots a block
constexpr int kStage = 2048;  // offsets a block stages in shared memory
constexpr int kTableThreads = 256;

struct Columns {  // point p's column r, a non-finite value read as 0
  const float* __restrict__ attr;  // (10, n) row-major
  int n;
  __device__ float operator()(int r, int p) const {
    const float x = attr[(size_t)r * n + p];
    return isfinite(x) ? x : 0.0f;
  }
};

// The last p in [lo, hi) with offsets[p] <= key, given offsets[lo] <= key,
// by a 16-way search: lane j of a half-warp probes the (j+1)/17 point of
// the interval. Both half-warps run it at once, each for its own key; all
// 32 lanes call it.
__device__ int half_warp_owner(const int* __restrict__ offsets, int lo,
                               int hi, int key) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int j = lane & 15;
  while (__any_sync(0xffffffffu, hi - lo > 1)) {
    const int d = hi - lo;
    const int pos = lo + (int)((long long)(j + 1) * d / 17);
    const bool le = d > 1 && offsets[pos] <= key;
    const unsigned ballot = __ballot_sync(0xffffffffu, le);
    const int t = __popc((ballot >> (16 * half)) & 0xffffu);
    if (d > 1) {  // the trues are a prefix: offsets do not decrease
      const int pos_t1 = lo + (int)((long long)t * d / 17);  // probe t-1
      const int pos_t = lo + (int)((long long)(t + 1) * d / 17);
      if (t > 0) lo = pos_t1;
      if (t < 16) hi = pos_t;
    }
  }
  return lo;
}

// The last p in [lo, hi) with offs[p] <= key, given offs[lo] <= key.
__device__ int binary_owner(const int* offs, int lo, int hi, int key) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= key) lo = mid; else hi = mid;
  }
  return lo;
}

// Padding slots k0 .. k0 + kSlotsPerThread - 1 below total: the sentinel,
// owned by point 0.
__device__ void pad_slots(int k0, int total, int sentinel,
                          int* __restrict__ fused, int* __restrict__ owner) {
#pragma unroll
  for (int s = 0; s < kSlotsPerThread; ++s) {
    if (k0 + s < total) {
      fused[k0 + s] = sentinel;
      owner[k0 + s] = 0;
    }
  }
}

}  // namespace

__global__ void __launch_bounds__(kSlotThreads)
slot_keys_kernel(const int* __restrict__ offsets,
                 const int* __restrict__ dkey, const int* __restrict__ base,
                 const int* __restrict__ h, Columns col, int n, int total,
                 const long long* __restrict__ key_total, int tiles_u,
                 int tile_w, int tile_h, int dbits, int sentinel,
                 int exact_cull, float cull_bias, int* __restrict__ fused,
                 int* __restrict__ owner) {
  __shared__ int s_off[kStage];
  __shared__ int s_ends[2];
  // the slots that hold keys; the rest of the buffer is padding
  const int live =
      key_total ? (int)max(0LL, min(*key_total, (long long)total)) : total;
  const int run0 = blockIdx.x * kRun;
  if (run0 >= live) {  // the whole block is padding
    pad_slots(run0 + threadIdx.x * kSlotsPerThread, total, sentinel, fused,
              owner);
    return;
  }
  const int run_last = min(run0 + kRun, live) - 1;
  if (threadIdx.x < 32) {
    const int key = threadIdx.x < 16 ? run0 : run_last;
    const int p = half_warp_owner(offsets, 0, n, key);
    if ((threadIdx.x & 15) == 0) s_ends[threadIdx.x >> 4] = p;
  }
  __syncthreads();
  const int p_lo = s_ends[0];
  const int m = s_ends[1] - p_lo + 1;  // points of the run
  const bool staged = m <= kStage;
  if (staged) {
    for (int i = threadIdx.x; i < m; i += kSlotThreads)
      s_off[i] = offsets[p_lo + i];
  }
  __syncthreads();
  const int k0 = run0 + threadIdx.x * kSlotsPerThread;
  if (k0 >= live) {
    pad_slots(k0, total, sentinel, fused, owner);
    return;
  }
  const int* offs = staged ? s_off : offsets + p_lo;
  int i = binary_owner(offs, 0, m, k0);

  int out_key[kSlotsPerThread], out_owner[kSlotsPerThread];
  int cur = -1, off = 0, hh = 1, b = 0, dk = 0;
  float u = 0.f, v = 0.f, logro = 0.f;
  Conic c{0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kSlotsPerThread; ++s) {
    const int k = min(k0 + s, live - 1);  // the tail repeats a slot
    while (i + 1 < m && offs[i + 1] <= k) ++i;
    const int p = p_lo + i;
    if (p != cur) {
      cur = p;
      off = offs[i];
      hh = max(h[p], 1);
      b = base[p];
      dk = dkey[p];
      if (exact_cull) {
        u = col(0, p);
        v = col(1, p);
        c = Conic{col(2, p), col(3, p), col(4, p)};
        logro = col(5, p);
      }
    }
    const int j = k - off;
    const int du = j / hh;
    const int dv = j - du * hh;
    const int tid = b + du + dv * tiles_u;
    bool valid = true;
    if (exact_cull) {
      const float cx = (float)(tid % tiles_u) * (float)tile_w;
      const float cy = (float)(tid / tiles_u) * (float)tile_h;
      const float u_raw = u - cx;
      const float v_raw = v - cy;
      const float qmin = c.rect_min(0.5f - u_raw, ((float)tile_w - 0.5f) - u_raw,
                                    0.5f - v_raw, ((float)tile_h - 0.5f) - v_raw);
      valid = !(qmin > logro + cull_bias);
    }
    const bool key = k0 + s < live;  // else padding
    out_key[s] = key && valid ? (tid << dbits) + dk : sentinel;
    out_owner[s] = key ? p : 0;
  }
  if (k0 + kSlotsPerThread <= total) {
    *reinterpret_cast<int4*>(fused + k0) =
        make_int4(out_key[0], out_key[1], out_key[2], out_key[3]);
    *reinterpret_cast<int4*>(owner + k0) =
        make_int4(out_owner[0], out_owner[1], out_owner[2], out_owner[3]);
  } else {
#pragma unroll
    for (int s = 0; s < kSlotsPerThread; ++s) {
      if (k0 + s < total) {
        fused[k0 + s] = out_key[s];
        owner[k0 + s] = out_owner[s];
      }
    }
  }
}

__global__ void __launch_bounds__(kTableThreads)
sorted_table_kernel(const int* __restrict__ fused_s,
                    const long long* __restrict__ perm,
                    const int* __restrict__ owner, Columns col, int total,
                    int tiles_u, int tile_w, int tile_h, int dbits,
                    int sentinel, float* __restrict__ table) {
  const int i = blockIdx.x * kTableThreads + threadIdx.x;
  if (i >= total) return;
  const int f = fused_s[i];
  const int p = owner[perm ? perm[i] : (long long)i];
  const int tid = f >> dbits;
  const bool valid = f != sentinel;
  float* col_i = table + i;
  const size_t t = (size_t)total;
  const float cx = (float)(tid % tiles_u) * (float)tile_w;
  const float cy = (float)(tid / tiles_u) * (float)tile_h;
  col_i[0] = valid ? col(0, p) - cx : 0.0f;
  col_i[t] = valid ? col(1, p) - cy : 0.0f;
#pragma unroll
  for (int r = 2; r < 10; ++r) col_i[r * t] = col(r, p);
  col_i[10 * t] = (float)p;
#pragma unroll
  for (int r = 11; r < 16; ++r) col_i[r * t] = 0.0f;
}

// K1a. attr: (10, n) f32 point columns; fused, owner: (total,) i32.
// key_total: NULL (total is the key total), or the capped mode's (1,) i64
// key total on the device, which may exceed total. 0 <= total; n >= 1 when
// total > 0.
extern "C" int slot_keys_launch(const int* offsets, const int* dkey,
                                const int* base, const int* h,
                                const float* attr, int n, int total,
                                const long long* key_total, int tiles_u,
                                int tile_w, int tile_h, int dbits,
                                int sentinel, int exact_cull, float cull_bias,
                                int* fused, int* owner, cudaStream_t stream) {
  if (total == 0) return 0;
  const int blocks = (total + kRun - 1) / kRun;
  slot_keys_kernel<<<blocks, kSlotThreads, 0, stream>>>(
      offsets, dkey, base, h, Columns{attr, n}, n, total, key_total,
      tiles_u, tile_w, tile_h, dbits, sentinel, exact_cull, cull_bias, fused,
      owner);
  return (int)cudaGetLastError();
}

// K1b. fused_s: (total,) i32 sorted keys; perm: (total,) i64 pre-sort slot
// of each sorted key, or NULL for the identity; owner: (total,) i32 point
// of each slot; attr: (10, n) f32 point columns; table: (16, total) f32.
extern "C" int sorted_table_launch(const int* fused_s, const long long* perm,
                                   const int* owner, const float* attr,
                                   int n, int total, int tiles_u, int tile_w,
                                   int tile_h, int dbits, int sentinel,
                                   float* table, cudaStream_t stream) {
  if (total == 0) return 0;
  const int blocks = (total + kTableThreads - 1) / kTableThreads;
  sorted_table_kernel<<<blocks, kTableThreads, 0, stream>>>(
      fused_s, perm, owner, Columns{attr, n}, total, tiles_u, tile_w, tile_h,
      dbits, sentinel, table);
  return (int)cudaGetLastError();
}
