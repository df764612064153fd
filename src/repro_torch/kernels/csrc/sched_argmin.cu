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
// tail latency dominate the byte time.  The designs therefore aim at one
// round trip to memory per call, few barriers and a single wave of CTAs;
// e2c_noop, an empty kernel at a given grid, measures the floor
// (chip_smoke.py, phase 6, gives each kernel's time beside it).
//
// Design.  The Pallas kernels walk the task axis as a *sequential* grid
// and carry the running winner in SMEM; CUDA blocks run in no order, so
// the carry is replaced by a reduction over (value, index) pairs inside
// one replica's warp or CTA, the replica axis outermost.  The wrapper
// picks each kernel's layout on the host from the shapes:
//   * masked_argmin, rows of len <= 1024 (the engine's drain calls it on
//     (R, 1, M) rows): a warp per replica, 8 replicas a CTA; each lane
//     scans a contiguous chunk in index order (16-byte loads where the
//     wrapper found len % 4 == 0 and aligned rows), then a five-step
//     shuffle reduction; no shared memory and no barrier.  Longer rows:
//     a 256-thread CTA per replica, strided slices, a two-level shuffle
//     reduction through shared memory.
//   * fused_minmin and fused_maxmin, one template: a task's completion row
//     depends on its type only, so a CTA per replica first reduces each
//     of the T types over the machines (a warp per type, lanes over
//     machines), keeps (minimum, machine) of every type in shared memory,
//     then scans the tasks (4 a thread with 16-byte type_id loads,
//     prefetched before the type phase) for the first-index argmin
//     (Min-Min) or argmax (Max-Min): T x M + N work in place of N x M.
//     Its reductions are two redux.sync each, the least order-preserving
//     key and then the least index among the lanes holding it.  Where
//     T > N, or the table would not fit in 48 KB, the wrapper picks the
//     per-task layouts: each thread walks whole task rows.
//   * fused_start_pick, M <= 767: a warp per replica, 8 replicas a CTA;
//     the lanes read the statuses whole (16-byte loads where n % 4 == 0
//     and the rows are aligned), and load machine and seq only for
//     queued tasks, four of a lane's at once, into a per-warp table of
//     64-bit (seq, id) keys in shared memory.  More machines: a
//     256-thread CTA per replica.
//   * fused_event_bounds: a 256-thread CTA per replica over strided
//     slices of the task axis.
// The exact-equivalence contract of the reference is rebuilt in the pair
// order itself:
//   * ties go to the first flat index (a lower index wins an equal value,
//     and -0.0 == +0.0 counts as equal, as in argmin);
//   * masked cells take part as 1e30, so a valid cell >= 1e30 loses to
//     the first masked cell;
//   * an empty mask returns the sentinels (-1, 1e30) / (+inf).
// An argmin returns the winning cell's own bits (+0.0 for [+0.0, -0.0]).
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
constexpr int kRowWarps = 8;  // replicas a CTA in the warp-per-replica layout

// One cell of a lane's in-order scan: masked cells take part as BIG.
__device__ __forceinline__ void argmin_cell(float x, uint8_t ok, int j,
                                            float& bv, int& bi, int& any) {
  const float v = ok ? x : kBig;
  any |= ok;
  if (better(v, j, bv, bi)) {
    bv = v;
    bi = j;
  }
}

// A warp per replica: lane l scans the contiguous chunk [l * chunk,
// (l + 1) * chunk) in index order, then a five-step shuffle reduction.
// kVec: len % 4 == 0 and 16-byte aligned rows, chunks of whole float4s.
template <bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
    masked_argmin_warp_kernel(const float* __restrict__ values,
                              const uint8_t* __restrict__ mask, int rows,
                              int len, int* __restrict__ out_idx,
                              float* __restrict__ out_min) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float* v = values + r * len;
  const uint8_t* mk = mask + r * len;
  const int chunk = kVec ? ((len + 127) >> 7) << 2 : (len + 31) >> 5;
  const int lo = lane * chunk;
  const int hi = min(lo + chunk, len);
  float bv = INFINITY;
  int bi = INT_MAX;
  int any = 0;
  if (kVec) {
    for (int j = lo; j < hi; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(v + j);
      const uchar4 ok = *reinterpret_cast<const uchar4*>(mk + j);
      argmin_cell(x.x, ok.x, j, bv, bi, any);
      argmin_cell(x.y, ok.y, j + 1, bv, bi, any);
      argmin_cell(x.z, ok.z, j + 2, bv, bi, any);
      argmin_cell(x.w, ok.w, j + 3, bv, bi, any);
    }
  } else {
    for (int j = lo; j < hi; ++j) argmin_cell(v[j], mk[j], j, bv, bi, any);
  }
  warp_argmin(bv, bi);
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) {
    out_idx[r] = any ? bi : -1;
    out_min[r] = any ? bv : kBig;
  }
}

// A CTA per replica, for rows longer than the warp layout takes.
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
// The (N, M) completion matrix is never stored.  Per-type layout: see
// fused_type below.  Per-task layout (T > N, or a type table too
// large for shared memory): one thread per task row, the machine row's
// avail/room staged in shared memory.
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
// (R,), score f32 (R,).  An in-batch task's score is the masked minimum of
// its completion row (-0.0 where that minimum is zero and a cell is -0.0)
// on the row's first-index machine; the CTA takes the largest score, the
// lowest task index on equal scores.  A task outside the batch queue
// scores -BIG on machine 0: it wins only if every in-batch score is below
// -BIG.  No valid (in_batch, room) pair -> (-1, -1, -BIG).
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool better_max(float v, int i, float bv,
                                           int bi) {
  return v > bv || (v == bv && i < bi);
}

// Order-preserving key under which -0.0 and +0.0 are equal, as they are
// under the comparisons of argmin and argmax.
__device__ __forceinline__ unsigned int tie_key(float x) {
  return float_key(x == 0.0f ? 0.0f : x);
}

// Lexicographic (key, index) minimum over the warp in two redux.sync: the
// least key, then the least index among the lanes that hold it.  Every
// lane gets the pair; the return value is a lane that holds it.
__device__ __forceinline__ int warp_min_pair(unsigned int& key, int& idx) {
  const unsigned int k = __reduce_min_sync(0xffffffffu, key);
  const int i = __reduce_min_sync(0xffffffffu, key == k ? idx : INT_MAX);
  const int src = __ffs(__ballot_sync(0xffffffffu, key == k && idx == i)) - 1;
  key = k;
  idx = i;
  return src;
}

// (value, index, payload) argmin (kMax: argmax) over the CTA, valid in
// thread 0: the least value (largest: the least complemented key), the
// lowest index on equal values, the winner's own bits and payload
// shuffled from its lane.  The one barrier also ORs `any` over the CTA,
// which it returns.
template <bool kMax>
__device__ int block_best(float& v, int& i, int& j, int any) {
  __shared__ float s_v[32];
  __shared__ int s_i[32];
  __shared__ int s_j[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned int k = kMax ? ~tie_key(v) : tie_key(v);
  int src = warp_min_pair(k, i);
  v = __shfl_sync(0xffffffffu, v, src);
  j = __shfl_sync(0xffffffffu, j, src);
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
    s_j[warp] = j;
  }
  any = __syncthreads_or(any);
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? s_v[lane] : (kMax ? -INFINITY : INFINITY);
    i = lane < n_warps ? s_i[lane] : INT_MAX;
    j = lane < n_warps ? s_j[lane] : 0;
    k = kMax ? ~tie_key(v) : tie_key(v);
    src = warp_min_pair(k, i);
    v = __shfl_sync(0xffffffffu, v, src);
    j = __shfl_sync(0xffffffffu, j, src);
  }
  return any;
}

__device__ __forceinline__ void store_maxmin(int64_t r, int ok, float bv,
                                             int bi, int bm,
                                             int* __restrict__ out_task,
                                             int* __restrict__ out_mach,
                                             float* __restrict__ out_score) {
  out_task[r] = ok ? bi : -1;
  out_mach[r] = ok ? bm : -1;
  out_score[r] = ok ? bv : -kBig;
}

// One task of the scan, its type's (minimum, machine) read from the table
// for in-batch tasks only.  Outside the batch queue a Max-Min task scores
// -BIG on machine 0; a Min-Min task is a row of BIG cells whose first,
// flat index task * M, is its best.  Max-Min's index is the task,
// Min-Min's the flat cell task * M + machine.
template <bool kMax>
__device__ __forceinline__ void type_task(int task, unsigned int in,
                                          int type, int m,
                                          const float* s_min,
                                          const int* s_mach, float& bv,
                                          int& bi, int& bm, int& any) {
  float v = kMax ? -kBig : kBig;
  int mach = 0;
  if (in) {
    v = s_min[type];
    mach = s_mach[type];
    any = 1;
  }
  const int idx = kMax ? task : task * m + mach;
  if (kMax ? better_max(v, idx, bv, bi) : better(v, idx, bv, bi)) {
    bv = v;
    bi = idx;
    bm = mach;
  }
}

// This thread's group g of tasks: 4 (tasks 4g..4g+3) with kVec, else 1.
template <bool kVec>
__device__ __forceinline__ void load_tasks(const uint8_t* inb,
                                           const int* tid, int g,
                                           unsigned int& in, int4& type) {
  if (kVec) {
    in = *reinterpret_cast<const unsigned int*>(inb + 4 * g);
    type = *reinterpret_cast<const int4*>(tid + 4 * g);
  } else {
    in = inb[g];
    type.x = tid[g];
  }
}

// Per-type layout of Min-Min (kMax false) and Max-Min (kMax true).
// (a) A warp per type: lanes over machines, each lane in increasing
// machine order over cells room ? avail + eet : BIG, then a (key,
// machine) redux reduction; the type's (minimum, machine) goes to shared
// memory.  (b) The task scan: each thread's first group of tasks is
// loaded before (a), the next one while the current one is scanned,
// then block_best.  kVec: n % 4 == 0 and 16-byte aligned type_id rows, 4
// tasks a thread and load.  Min-Min differs from Max-Min in three places:
//   * the table's value: Min-Min keeps the winning cell's own bits,
//     shuffled from the winner's lane (+0.0 for a row [+0.0, -0.0];
//     key_float would give +0.0 for any zero), Max-Min the row minimum
//     with -0.0 below +0.0 (XLA's min): key_float, then -0.0 where a
//     lane saw a -0.0 zero;
//   * the task scan: Min-Min is an argmin over (value, task * M +
//     machine), an out-of-batch task taking part as (BIG, task * M);
//     Max-Min an argmax over (score, task), out-of-batch at -BIG;
//   * the outputs: (flat index, minimum) or (-1, BIG), against (task,
//     machine, score) or (-1, -1, -BIG).  Both are found where
//     any(in_batch) && any(room).
template <bool kVec, bool kMax>
__device__ __forceinline__ void fused_type(
    const float* __restrict__ avail, const uint8_t* __restrict__ in_batch,
    const uint8_t* __restrict__ room, const int* __restrict__ type_id,
    const float* __restrict__ eet_m, int n, int m, int t,
    int* __restrict__ out_idx, int* __restrict__ out_mach,
    float* __restrict__ out_val) {
  extern __shared__ float s_type_min[];
  int* s_type_mach = reinterpret_cast<int*>(s_type_min + t);
  constexpr int kPer = kVec ? 4 : 1;
  const int64_t r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_groups = n / kPer;  // kVec: n % 4 == 0
  const uint8_t* inb = in_batch + r * n;
  const int* tid = type_id + r * n;
  int g = threadIdx.x;
  unsigned int in = 0;
  int4 type = make_int4(0, 0, 0, 0);
  if (g < n_groups) load_tasks<kVec>(inb, tid, g, in, type);

  const float* av = avail + r * m;
  const uint8_t* rm = room + r * m;
  const float* eet = eet_m + r * static_cast<int64_t>(t) * m;
  int any_room = 0;  // read in warp 0, which reduces type 0 (T = 0: no
                     // task can be in the batch, and 0 gives the sentinel)
  for (int ty = warp; ty < t; ty += n_warps) {
    const float* e = eet + static_cast<int64_t>(ty) * m;
    float v = INFINITY;
    int mach = INT_MAX;
    int neg_zero = 0;
    for (int col = lane; col < m; col += 32) {
      // all three loads unconditional, so they share one round trip
      const uint8_t ok = rm[col];
      const float a = av[col];
      const float c = e[col];
      const float x = ok ? __fadd_rn(a, c) : kBig;
      any_room |= ok;
      if (kMax) neg_zero |= x == 0.0f && signbit(x);
      if (better(x, col, v, mach)) {
        v = x;
        mach = col;
      }
    }
    unsigned int key = tie_key(v);
    const int src = warp_min_pair(key, mach);
    if (kMax) {
      neg_zero = __any_sync(0xffffffffu, neg_zero);
      v = key_float(key);  // a zero minimum comes back as +0.0
      v = v == 0.0f && neg_zero ? -0.0f : v;
    } else {
      v = __shfl_sync(0xffffffffu, v, src);
    }
    if (lane == 0) {
      s_type_min[ty] = v;
      s_type_mach[ty] = mach;
    }
  }
  any_room = __any_sync(0xffffffffu, any_room);
  __syncthreads();

  float bv = kMax ? -INFINITY : INFINITY;
  int bi = INT_MAX;
  int bm = 0;
  int any = 0;
  for (; g < n_groups; g += blockDim.x) {
    const unsigned int in_g = in;
    const int4 type_g = type;
    if (g + static_cast<int>(blockDim.x) < n_groups)
      load_tasks<kVec>(inb, tid, g + blockDim.x, in, type);
    if (kVec) {
      const int task = 4 * g;
      type_task<kMax>(task, in_g & 0xffu, type_g.x, m, s_type_min,
                      s_type_mach, bv, bi, bm, any);
      type_task<kMax>(task + 1, (in_g >> 8) & 0xffu, type_g.y, m,
                      s_type_min, s_type_mach, bv, bi, bm, any);
      type_task<kMax>(task + 2, (in_g >> 16) & 0xffu, type_g.z, m,
                      s_type_min, s_type_mach, bv, bi, bm, any);
      type_task<kMax>(task + 3, in_g >> 24, type_g.w, m, s_type_min,
                      s_type_mach, bv, bi, bm, any);
    } else {
      type_task<kMax>(g, in_g, type_g.x, m, s_type_min, s_type_mach, bv,
                      bi, bm, any);
    }
  }
  any = block_best<kMax>(bv, bi, bm, any) && any_room;
  if (threadIdx.x != 0) return;
  if (kMax) {
    store_maxmin(r, any, bv, bi, bm, out_idx, out_mach, out_val);
  } else {
    out_idx[r] = any ? bi : -1;
    out_val[r] = any ? bv : kBig;
  }
}

// The two entry points, named for their pair in profiles.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) fused_minmin_type_kernel(
    const float* __restrict__ avail, const uint8_t* __restrict__ in_batch,
    const uint8_t* __restrict__ room, const int* __restrict__ type_id,
    const float* __restrict__ eet_m, int n, int m, int t,
    int* __restrict__ out_idx, float* __restrict__ out_min) {
  fused_type<kVec, false>(avail, in_batch, room, type_id, eet_m, n, m, t,
                          out_idx, nullptr, out_min);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) fused_maxmin_type_kernel(
    const float* __restrict__ avail, const uint8_t* __restrict__ in_batch,
    const uint8_t* __restrict__ room, const int* __restrict__ type_id,
    const float* __restrict__ eet_m, int n, int m, int t,
    int* __restrict__ out_task, int* __restrict__ out_mach,
    float* __restrict__ out_score) {
  fused_type<kVec, true>(avail, in_batch, room, type_id, eet_m, n, m, t,
                         out_task, out_mach, out_score);
}

// Per-task layout (T > N, or a type table too large for shared memory):
// each thread walks whole task rows, a strict-< scan in increasing
// machine order.  A row outside the batch queue costs O(1): only the
// first such row of a thread can still win.
__global__ void fused_maxmin_task_kernel(const float* __restrict__ avail,
                                         const uint8_t* __restrict__ in_batch,
                                         const uint8_t* __restrict__ room,
                                         const int* __restrict__ type_id,
                                         const float* __restrict__ eet_m,
                                         int n, int m, int t,
                                         int* __restrict__ out_task,
                                         int* __restrict__ out_mach,
                                         float* __restrict__ out_score) {
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
  any = block_best<true>(bv, bi, bm, any);
  if (threadIdx.x == 0)
    store_maxmin(r, any, bv, bi, bm, out_task, out_mach, out_score);
}

__global__ void noop_kernel() {}

// ---------------------------------------------------------------------------
// fused_start_pick: status/machine/seq i32 (R, N) -> pick i32 (R, M),
// has u8 (R, M).  Per machine the lowest (seq, task id) among tasks queued
// on it, by a 64-bit shared-memory atomicMin on (seq key << 32 | id).  A
// task not queued on a machine counts as seq INT_MAX there, so a column
// whose least queued seq is INT_MAX holds INT_MAX in every row: its
// argmin is row 0, as is an empty column's.
// ---------------------------------------------------------------------------
constexpr unsigned long long kNoTask = ~0ull;
constexpr int kPickWarps = 8;  // replicas a CTA in the warp-per-replica layout

__device__ __forceinline__ unsigned long long pick_key(int seq, int i) {
  return (static_cast<unsigned long long>(static_cast<unsigned int>(seq) ^
                                          0x80000000u)
          << 32) |
         static_cast<unsigned int>(i);
}

// Queued task i on machine mi at seq q.  A machine outside [0, M) goes
// to the spare entry best[M], so no branch on the machine stands between
// the loads of mi and q: they share one round trip.
__device__ __forceinline__ void pick_update(unsigned long long* best, int m,
                                            int mi, int q, int i) {
  const bool on = static_cast<unsigned int>(mi) < static_cast<unsigned int>(m);
  atomicMin(&best[on ? mi : m], pick_key(q, i));
}

// A machine's (pick, has) from its least key: seq key 0xffffffff is a
// least seq of INT_MAX, or no queued task at all (kNoTask).
__device__ __forceinline__ void store_pick(unsigned long long k, int64_t at,
                                           int* __restrict__ pick,
                                           uint8_t* __restrict__ has) {
  pick[at] = (k >> 32) == 0xffffffffull ? 0 : static_cast<int>(k);
  has[at] = k != kNoTask;
}

// A warp per replica, 8 replicas a CTA, each warp with its own table of
// M + 1 keys in shared memory; no barrier but __syncwarp.  Machine and
// seq are loaded only for queued tasks: a call reads the statuses whole
// and the other two columns only where a task waits in a machine queue,
// few at a time.  Per batch, (1) each lane reads its statuses coalesced,
// kBatch loads (16-byte loads with kVec: n % 4 == 0 and aligned rows),
// into one bit per queued task; (2) it takes its queued tasks kGather
// at a time, all their machine and seq loads out before the first
// atomic: one round trip for up to kGather queued tasks, where a branch
// per task would take one each.
constexpr int kGather = 4;

template <bool kVec>
__global__ void __launch_bounds__(kPickWarps * 32)
    fused_start_pick_warp_kernel(const int* __restrict__ status,
                                 const int* __restrict__ machine,
                                 const int* __restrict__ seq, int rows,
                                 int n, int m, int in_mq,
                                 int* __restrict__ pick,
                                 uint8_t* __restrict__ has) {
  extern __shared__ unsigned long long s_keys[];
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kBatch = kVec ? 8 : 16;  // loads a batch: 32 or 16 tasks
  static_assert(kBatch * kPer <= 32, "one bit of `hits` per status");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kPickWarps + warp;
  if (r >= rows) return;  // the whole warp leaves together
  unsigned long long* best = s_keys + warp * (m + 1);
  for (int j = lane; j <= m; j += 32) best[j] = kNoTask;
  __syncwarp();
  const int* st = status + r * n;
  const int* mc = machine + r * n;
  const int* sq = seq + r * n;
  const int groups = n / kPer;  // kVec: n % 4 == 0
  for (int base = lane; base < groups; base += 32 * kBatch) {
    // bit u * kPer + k: task kPer * (base + 32 u) + k is queued
    unsigned int hits = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = base + 32 * u;
      if (g < groups) {
        if constexpr (kVec) {
          const int4 x = reinterpret_cast<const int4*>(st)[g];
          hits |= (static_cast<unsigned int>(x.x == in_mq) |
                   static_cast<unsigned int>(x.y == in_mq) << 1 |
                   static_cast<unsigned int>(x.z == in_mq) << 2 |
                   static_cast<unsigned int>(x.w == in_mq) << 3)
                  << (4 * u);
        } else {
          hits |= static_cast<unsigned int>(st[g] == in_mq) << u;
        }
      }
    }
    while (hits) {
      int id[kGather], mi[kGather], q[kGather];
#pragma unroll
      for (int c = 0; c < kGather; ++c) {
        const int b = __ffs(hits) - 1;  // -1: no task left
        hits &= hits - 1;
        id[c] = b < 0 ? -1 : kPer * (base + 32 * (b / kPer)) + b % kPer;
      }
#pragma unroll
      for (int c = 0; c < kGather; ++c) {
        if (id[c] >= 0) {
          mi[c] = mc[id[c]];
          q[c] = sq[id[c]];
        }
      }
#pragma unroll
      for (int c = 0; c < kGather; ++c)
        if (id[c] >= 0) pick_update(best, m, mi[c], q[c], id[c]);
    }
  }
  __syncwarp();
  for (int j = lane; j < m; j += 32) store_pick(best[j], r * m + j, pick, has);
}

// A CTA per replica, for more machines than the per-warp tables take.
__global__ void fused_start_pick_kernel(const int* __restrict__ status,
                                        const int* __restrict__ machine,
                                        const int* __restrict__ seq, int n,
                                        int m, int in_mq,
                                        int* __restrict__ pick,
                                        uint8_t* __restrict__ has) {
  extern __shared__ unsigned long long s_best[];
  const int64_t r = blockIdx.x;
  for (int j = threadIdx.x; j <= m; j += blockDim.x) s_best[j] = kNoTask;
  __syncthreads();
  const int* st = status + r * n;
  const int* mc = machine + r * n;
  const int* sq = seq + r * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (st[i] == in_mq) pick_update(s_best, m, mc[i], sq[i], i);
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    store_pick(s_best[j], r * m + j, pick, has);
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

// Dynamic shared memory of the per-type layout: the (minimum, machine)
// table.  The wrapper keeps it and block_best's 384 static bytes within
// 48 KB, so no opt-in is needed.
size_t type_smem(int t) {
  return static_cast<size_t>(t) * (sizeof(float) + sizeof(int));
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// layout: 0 a CTA per replica, 1 a warp per replica, 2 a warp per
// replica with 16-byte loads (the wrapper's choice, from len and the
// rows' alignment).
int e2c_masked_argmin(const void* values, const void* mask, int r, int len,
                      int layout, void* out_idx, void* out_min,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  int* idx = static_cast<int*>(out_idx);
  float* vmin = static_cast<float*>(out_min);
  const int grid = (r + kRowWarps - 1) / kRowWarps;
  if (layout == 2)
    masked_argmin_warp_kernel<true><<<grid, kRowWarps * 32, 0, s>>>(
        v, mk, r, len, idx, vmin);
  else if (layout == 1)
    masked_argmin_warp_kernel<false><<<grid, kRowWarps * 32, 0, s>>>(
        v, mk, r, len, idx, vmin);
  else
    masked_argmin_kernel<<<r, kThreads, 0, s>>>(v, mk, len, idx, vmin);
  return static_cast<int>(cudaGetLastError());
}

// layout (fused_minmin, fused_maxmin): 0 per task, 1 per type, 2 per type
// with 16-byte task loads (the wrapper's choice, from N, T and the rows'
// alignment).
int e2c_fused_minmin(const void* avail, const void* in_batch,
                     const void* room, const void* type_id, const void* eet_m,
                     int r, int n, int m, int t, int layout, void* out_idx,
                     void* out_min, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* av = static_cast<const float*>(avail);
  const uint8_t* inb = static_cast<const uint8_t*>(in_batch);
  const uint8_t* rm = static_cast<const uint8_t*>(room);
  const int* tid = static_cast<const int*>(type_id);
  const float* eet = static_cast<const float*>(eet_m);
  int* idx = static_cast<int*>(out_idx);
  float* vmin = static_cast<float*>(out_min);
  if (layout == 0) {
    const size_t smem = static_cast<size_t>(m) * (sizeof(float) + 1);
    const cudaError_t err = allow_smem(fused_minmin_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_minmin_kernel<<<r, kThreads, smem, s>>>(av, inb, rm, tid, eet, n,
                                                   m, t, idx, vmin);
  } else if (layout == 2) {
    fused_minmin_type_kernel<true><<<r, kThreads, type_smem(t), s>>>(
        av, inb, rm, tid, eet, n, m, t, idx, vmin);
  } else {
    fused_minmin_type_kernel<false><<<r, kThreads, type_smem(t), s>>>(
        av, inb, rm, tid, eet, n, m, t, idx, vmin);
  }
  return static_cast<int>(cudaGetLastError());
}

int e2c_fused_maxmin(const void* avail, const void* in_batch,
                     const void* room, const void* type_id, const void* eet_m,
                     int r, int n, int m, int t, int layout, void* out_task,
                     void* out_mach, void* out_score, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* av = static_cast<const float*>(avail);
  const uint8_t* inb = static_cast<const uint8_t*>(in_batch);
  const uint8_t* rm = static_cast<const uint8_t*>(room);
  const int* tid = static_cast<const int*>(type_id);
  const float* eet = static_cast<const float*>(eet_m);
  int* task = static_cast<int*>(out_task);
  int* mach = static_cast<int*>(out_mach);
  float* score = static_cast<float*>(out_score);
  if (layout == 0) {
    const size_t smem = static_cast<size_t>(m) * (sizeof(float) + 1);
    const cudaError_t err = allow_smem(fused_maxmin_task_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_maxmin_task_kernel<<<r, kThreads, smem, s>>>(
        av, inb, rm, tid, eet, n, m, t, task, mach, score);
  } else if (layout == 2) {
    fused_maxmin_type_kernel<true><<<r, kThreads, type_smem(t), s>>>(
        av, inb, rm, tid, eet, n, m, t, task, mach, score);
  } else {
    fused_maxmin_type_kernel<false><<<r, kThreads, type_smem(t), s>>>(
        av, inb, rm, tid, eet, n, m, t, task, mach, score);
  }
  return static_cast<int>(cudaGetLastError());
}

// layout: 0 a CTA per replica, 1 a warp per replica, 2 a warp per
// replica with 16-byte status loads (the wrapper's choice, from M, N and
// the rows' alignment).
int e2c_fused_start_pick(const void* status, const void* machine,
                         const void* seq, int r, int n, int m, int in_mq,
                         int layout, void* pick, void* has, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(status);
  const int* mc = static_cast<const int*>(machine);
  const int* sq = static_cast<const int*>(seq);
  int* p = static_cast<int*>(pick);
  uint8_t* h = static_cast<uint8_t*>(has);
  if (layout == 0) {
    const size_t smem =
        static_cast<size_t>(m + 1) * sizeof(unsigned long long);
    const cudaError_t err = allow_smem(fused_start_pick_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_start_pick_kernel<<<r, kThreads, smem, s>>>(st, mc, sq, n, m,
                                                       in_mq, p, h);
  } else {
    // the wrapper keeps the 8 warps' tables within 48 KB (M <= 767)
    const size_t smem = static_cast<size_t>(kPickWarps) * (m + 1) *
                        sizeof(unsigned long long);
    const int grid = (r + kPickWarps - 1) / kPickWarps;
    if (layout == 2)
      fused_start_pick_warp_kernel<true><<<grid, kPickWarps * 32, smem, s>>>(
          st, mc, sq, r, n, m, in_mq, p, h);
    else
      fused_start_pick_warp_kernel<false><<<grid, kPickWarps * 32, smem, s>>>(
          st, mc, sq, r, n, m, in_mq, p, h);
  }
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

// An empty kernel at the given grid: the floor a launch of that size
// cannot go under.
int e2c_noop(int blocks, int threads, void* stream) {
  noop_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
