// Dispatch and event-loop reductions of the E2C engine, for Hopper (sm_90a).
//
// Replaces the five Pallas kernels of src/repro/kernels/sched_argmin.py:
//   masked_argmin       <- masked_argmin       (:89,  body _argmin_kernel)
//   fused_minmin        <- fused_minmin        (:227, body _minmin_kernel)
//   fused_maxmin        <- fused_maxmin        (:427, body _maxmin_kernel)
//   fused_start_pick    <- fused_start_pick    (:315, body _start_pick_kernel)
//   fused_event_bounds  <- fused_event_bounds  (:388, body _event_bounds_kernel)
//
// What bounds them on the H100: bytes, and below that, latency.  Each call
// reduces a few KB to a few hundred KB per replica and does a handful of
// compares per byte, far under the card's ops-per-byte balance; at the
// engine's shapes one launch moves well under a megabyte, so launch and
// tail latency dominate the byte time.
//
// Design.  The Pallas kernels walk the task axis as a *sequential* grid
// and carry the running winner in SMEM; CUDA blocks run in no order, so
// the carry is replaced by one CTA per replica (grid = R, the replica
// axis outermost): each thread scans a strided slice of the task axis in
// increasing index order, then the CTA reduces (value, index) pairs with
// warp shuffles.  The exact-equivalence contract of the reference is
// rebuilt in the pair order itself:
//   * ties go to the first flat index (a lower index wins an equal value,
//     and -0.0 == +0.0 counts as equal, as in argmin);
//   * masked cells take part as 1e30, so a valid cell >= 1e30 loses to
//     the first masked cell;
//   * an empty mask returns the sentinels (-1, 1e30) / (+inf).
// Max-Min keeps the larger score and the lower task index on equal
// scores, with the winner's own bits (-0.0 == +0.0 under comparison).
// The event-bound minima and Max-Min's row minima order -0.0 below +0.0,
// like XLA's min (the first through an order-preserving integer key).
// The only float arithmetic is the completion avail + eet of Min-Min and
// Max-Min, one correctly rounded add, so the
// kernels agree bit for bit with their plain PyTorch versions
// (kernels/ref.py).  The file is built with --fmad=false all the same.
//
// Every launcher returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// (value, index) argmin over the CTA; the result is valid in thread 0.
__device__ void block_argmin(float& v, int& i) {
  __shared__ float s_v[32];
  __shared__ int s_i[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmin(v, i);
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? s_v[lane] : INFINITY;
    i = lane < n_warps ? s_i[lane] : INT_MAX;
    warp_argmin(v, i);
  }
}

// Order-preserving float key: unsigned order == float order, -0.0 < +0.0.
__device__ __forceinline__ unsigned int float_key(float x) {
  const unsigned int u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Unsigned min over the CTA; the result is valid in thread 0.
__device__ unsigned int block_umin(unsigned int k) {
  __shared__ unsigned int s_k[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    k = min(k, __shfl_down_sync(0xffffffffu, k, off));
  if (lane == 0) s_k[warp] = k;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    k = lane < n_warps ? s_k[lane] : 0xffffffffu;
    for (int off = 16; off > 0; off >>= 1)
      k = min(k, __shfl_down_sync(0xffffffffu, k, off));
  }
  return k;
}

// ---------------------------------------------------------------------------
// masked_argmin: values f32 (R, len), mask u8 (R, len) -> idx i32 (R,),
// min f32 (R,).  len is the row-major flattening of one replica's (N, M).
// ---------------------------------------------------------------------------
__global__ void masked_argmin_kernel(const float* __restrict__ values,
                                     const uint8_t* __restrict__ mask,
                                     int len, int* __restrict__ out_idx,
                                     float* __restrict__ out_min) {
  const int64_t r = blockIdx.x;
  const float* v = values + r * len;
  const uint8_t* mk = mask + r * len;
  float bv = INFINITY;
  int bi = INT_MAX;
  int any = 0;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const bool ok = mk[j] != 0;
    const float x = ok ? v[j] : kBig;
    any |= ok;
    if (better(x, j, bv, bi)) {
      bv = x;
      bi = j;
    }
  }
  any = __syncthreads_or(any);
  block_argmin(bv, bi);
  if (threadIdx.x == 0) {
    out_idx[r] = any ? bi : -1;
    out_min[r] = any ? bv : kBig;
  }
}

// ---------------------------------------------------------------------------
// fused_minmin: avail f32 (R, M), in_batch u8 (R, N), room u8 (R, M),
// type_id i32 (R, N), eet_m f32 (R, T, M) -> flat idx i32 (R,), min (R,).
// The (N, M) completion matrix exists only in registers: one thread per
// task row, the machine row's avail/room staged in shared memory.
// ---------------------------------------------------------------------------
__global__ void fused_minmin_kernel(const float* __restrict__ avail,
                                    const uint8_t* __restrict__ in_batch,
                                    const uint8_t* __restrict__ room,
                                    const int* __restrict__ type_id,
                                    const float* __restrict__ eet_m, int n,
                                    int m, int t, int* __restrict__ out_idx,
                                    float* __restrict__ out_min) {
  extern __shared__ unsigned char smem[];
  float* s_avail = reinterpret_cast<float*>(smem);
  uint8_t* s_room = reinterpret_cast<uint8_t*>(s_avail + m);
  const int64_t r = blockIdx.x;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s_avail[j] = avail[r * m + j];
    s_room[j] = room[r * m + j];
  }
  __syncthreads();
  int any_room = 0;
  for (int j = 0; j < m; ++j) any_room |= s_room[j];
  const uint8_t* inb = in_batch + r * n;
  const int* tid = type_id + r * n;
  const float* eet = eet_m + r * static_cast<int64_t>(t) * m;
  float bv = INFINITY;
  int bi = INT_MAX;
  int any = 0;
  for (int row = threadIdx.x; row < n; row += blockDim.x) {
    const int base = row * m;
    if (!inb[row] || !any_room) {
      // every cell of the row is masked: its first cell is the row's best
      if (better(kBig, base, bv, bi)) {
        bv = kBig;
        bi = base;
      }
      continue;
    }
    any = 1;
    const float* e = eet + static_cast<int64_t>(tid[row]) * m;
    for (int col = 0; col < m; ++col) {
      const float x = s_room[col] ? __fadd_rn(s_avail[col], e[col]) : kBig;
      if (better(x, base + col, bv, bi)) {
        bv = x;
        bi = base + col;
      }
    }
  }
  any = __syncthreads_or(any);
  block_argmin(bv, bi);
  if (threadIdx.x == 0) {
    out_idx[r] = any ? bi : -1;
    out_min[r] = any ? bv : kBig;
  }
}

// ---------------------------------------------------------------------------
// fused_maxmin: the inputs of fused_minmin -> task i32 (R,), machine i32
// (R,), score f32 (R,).  Per in-batch task row, the masked row minimum
// (its first-index machine from a strict-< scan in increasing machine
// order) is the task's score; the CTA then takes the largest score, the
// lowest task index on equal scores.  A row outside the batch queue
// scores -BIG with machine 0 in O(1): only the first such row of a
// thread can still win, and only if every in-batch score is below -BIG.
// No valid (in_batch, room) pair -> (-1, -1, -BIG).
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool better_max(float v, int i, float bv,
                                           int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax3(float& v, int& i, int& j) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    int oj = __shfl_down_sync(0xffffffffu, j, off);
    if (better_max(ov, oi, v, i)) {
      v = ov;
      i = oi;
      j = oj;
    }
  }
}

__global__ void fused_maxmin_kernel(const float* __restrict__ avail,
                                    const uint8_t* __restrict__ in_batch,
                                    const uint8_t* __restrict__ room,
                                    const int* __restrict__ type_id,
                                    const float* __restrict__ eet_m, int n,
                                    int m, int t, int* __restrict__ out_task,
                                    int* __restrict__ out_mach,
                                    float* __restrict__ out_score) {
  extern __shared__ unsigned char smem[];
  float* s_avail = reinterpret_cast<float*>(smem);
  uint8_t* s_room = reinterpret_cast<uint8_t*>(s_avail + m);
  __shared__ float s_v[32];
  __shared__ int s_i[32];
  __shared__ int s_j[32];
  const int64_t r = blockIdx.x;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s_avail[j] = avail[r * m + j];
    s_room[j] = room[r * m + j];
  }
  __syncthreads();
  int any_room = 0;
  for (int j = 0; j < m; ++j) any_room |= s_room[j];
  const uint8_t* inb = in_batch + r * n;
  const int* tid = type_id + r * n;
  const float* eet = eet_m + r * static_cast<int64_t>(t) * m;
  float bv = -INFINITY;
  int bi = INT_MAX;
  int bm = 0;
  int any = 0;
  bool skipped = false;
  // without room no pair is valid and the sentinel is returned
  for (int row = threadIdx.x; any_room && row < n; row += blockDim.x) {
    if (!inb[row]) {
      if (!skipped && better_max(-kBig, row, bv, bi)) {
        bv = -kBig;
        bi = row;
        bm = 0;
      }
      skipped = true;
      continue;
    }
    any = 1;
    const float* e = eet + static_cast<int64_t>(tid[row]) * m;
    float rv = s_room[0] ? __fadd_rn(s_avail[0], e[0]) : kBig;
    int rm = 0;
    bool neg_zero = rv == 0.0f && signbit(rv);
    for (int col = 1; col < m; ++col) {
      const float x = s_room[col] ? __fadd_rn(s_avail[col], e[col]) : kBig;
      neg_zero |= x == 0.0f && signbit(x);
      if (x < rv) {
        rv = x;
        rm = col;
      }
    }
    if (rv == 0.0f && neg_zero) rv = -0.0f;
    if (better_max(rv, row, bv, bi)) {
      bv = rv;
      bi = row;
      bm = rm;
    }
  }
  any = __syncthreads_or(any);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax3(bv, bi, bm);
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
    s_j[warp] = bm;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    bv = lane < n_warps ? s_v[lane] : -INFINITY;
    bi = lane < n_warps ? s_i[lane] : INT_MAX;
    bm = lane < n_warps ? s_j[lane] : 0;
    warp_argmax3(bv, bi, bm);
    if (lane == 0) {
      out_task[r] = any ? bi : -1;
      out_mach[r] = any ? bm : -1;
      out_score[r] = any ? bv : -kBig;
    }
  }
}

// ---------------------------------------------------------------------------
// fused_start_pick: status/machine/seq i32 (R, N) -> pick i32 (R, M),
// has u8 (R, M).  Per machine the lowest (seq, task id) among tasks queued
// on it, by a 64-bit shared-memory atomicMin on (seq key << 32 | id).
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned long long pick_key(int seq, int i) {
  return (static_cast<unsigned long long>(static_cast<unsigned int>(seq) ^
                                          0x80000000u)
          << 32) |
         static_cast<unsigned int>(i);
}

__global__ void fused_start_pick_kernel(const int* __restrict__ status,
                                        const int* __restrict__ machine,
                                        const int* __restrict__ seq, int n,
                                        int m, int in_mq,
                                        int* __restrict__ pick,
                                        uint8_t* __restrict__ has) {
  extern __shared__ unsigned long long s_best[];
  const unsigned long long kNone = ~0ull;
  const int64_t r = blockIdx.x;
  for (int j = threadIdx.x; j < m; j += blockDim.x) s_best[j] = kNone;
  __syncthreads();
  const int* st = status + r * n;
  const int* mc = machine + r * n;
  const int* sq = seq + r * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int mi = mc[i];
    if (st[i] == in_mq && mi >= 0 && mi < m)
      atomicMin(&s_best[mi], pick_key(sq[i], i));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const unsigned long long k = s_best[j];
    const bool h = k != kNone;
    int p = 0;  // argmin of an all-INT_MAX column is row 0
    if (h) {
      p = static_cast<int>(k & 0xffffffffull);
      const int s = static_cast<int>(static_cast<unsigned int>(k >> 32) ^
                                     0x80000000u);
      if (s == INT_MAX) {
        // a queued seq of INT_MAX ties with every task not queued here
        // (masked as INT_MAX): the first such row wins, as in argmin
        for (int i = 0; i < p; ++i) {
          if (!(st[i] == in_mq && mc[i] == j)) {
            p = i;
            break;
          }
        }
      }
    }
    pick[r * m + j] = p;
    has[r * m + j] = h ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// fused_event_bounds: status i32, arrival f32, deadline f32 (R, N) ->
// t_arr f32 (R,), t_dl f32 (R,): min arrival over NOT_ARRIVED tasks and
// min deadline over the live status range, +inf when empty.
// ---------------------------------------------------------------------------
__global__ void fused_event_bounds_kernel(const int* __restrict__ status,
                                          const float* __restrict__ arrival,
                                          const float* __restrict__ deadline,
                                          int n, int not_arrived, int live_lo,
                                          int live_hi,
                                          float* __restrict__ t_arr,
                                          float* __restrict__ t_dl) {
  const int64_t r = blockIdx.x;
  const int* st = status + r * n;
  const float* ar = arrival + r * n;
  const float* dl = deadline + r * n;
  const unsigned int inf_key = float_key(INFINITY);
  unsigned int ka = inf_key;
  unsigned int kd = inf_key;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = st[i];
    if (s == not_arrived) ka = min(ka, float_key(ar[i]));
    if (s >= live_lo && s <= live_hi) kd = min(kd, float_key(dl[i]));
  }
  ka = block_umin(ka);
  __syncthreads();  // block_umin's shared scratch is reused below
  kd = block_umin(kd);
  if (threadIdx.x == 0) {
    t_arr[r] = key_float(ka);
    t_dl[r] = key_float(kd);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int e2c_masked_argmin(const void* values, const void* mask, int r, int len,
                      void* out_idx, void* out_min, void* stream) {
  masked_argmin_kernel<<<r, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const uint8_t*>(mask),
      len, static_cast<int*>(out_idx), static_cast<float*>(out_min));
  return static_cast<int>(cudaGetLastError());
}

int e2c_fused_minmin(const void* avail, const void* in_batch,
                     const void* room, const void* type_id, const void* eet_m,
                     int r, int n, int m, int t, void* out_idx, void* out_min,
                     void* stream) {
  const size_t smem = static_cast<size_t>(m) * (sizeof(float) + 1);
  cudaError_t err = allow_smem(fused_minmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_minmin_kernel<<<r, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(avail), static_cast<const uint8_t*>(in_batch),
      static_cast<const uint8_t*>(room), static_cast<const int*>(type_id),
      static_cast<const float*>(eet_m), n, m, t, static_cast<int*>(out_idx),
      static_cast<float*>(out_min));
  return static_cast<int>(cudaGetLastError());
}

int e2c_fused_maxmin(const void* avail, const void* in_batch,
                     const void* room, const void* type_id, const void* eet_m,
                     int r, int n, int m, int t, void* out_task,
                     void* out_mach, void* out_score, void* stream) {
  const size_t smem = static_cast<size_t>(m) * (sizeof(float) + 1);
  cudaError_t err = allow_smem(fused_maxmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_maxmin_kernel<<<r, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(avail), static_cast<const uint8_t*>(in_batch),
      static_cast<const uint8_t*>(room), static_cast<const int*>(type_id),
      static_cast<const float*>(eet_m), n, m, t, static_cast<int*>(out_task),
      static_cast<int*>(out_mach), static_cast<float*>(out_score));
  return static_cast<int>(cudaGetLastError());
}

int e2c_fused_start_pick(const void* status, const void* machine,
                         const void* seq, int r, int n, int m, int in_mq,
                         void* pick, void* has, void* stream) {
  const size_t smem = static_cast<size_t>(m) * sizeof(unsigned long long);
  cudaError_t err = allow_smem(fused_start_pick_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_start_pick_kernel<<<r, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(status), static_cast<const int*>(machine),
      static_cast<const int*>(seq), n, m, in_mq, static_cast<int*>(pick),
      static_cast<uint8_t*>(has));
  return static_cast<int>(cudaGetLastError());
}

int e2c_fused_event_bounds(const void* status, const void* arrival,
                           const void* deadline, int r, int n,
                           int not_arrived, int live_lo, int live_hi,
                           void* t_arr, void* t_dl, void* stream) {
  fused_event_bounds_kernel<<<r, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(status), static_cast<const float*>(arrival),
      static_cast<const float*>(deadline), n, not_arrived, live_lo, live_hi,
      static_cast<float*>(t_arr), static_cast<float*>(t_dl));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
