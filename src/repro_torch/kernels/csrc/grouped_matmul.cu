// Grouped matrix product of the MoE expert FFN for Hopper (sm_90a):
// out[g] = lhs[g] @ rhs[g] for G groups, where only the first
// group_sizes[g] rows of each group hold tokens; f32 accumulation, output
// in the input type, rows at or past the size exactly 0.
//
// Replaces src/repro/kernels/grouped_matmul.py::grouped_matmul (:50, body
// _gmm_kernel :29, pallas_call :70).
//
// What bounds it on this card: bytes, in both of its regimes, once f32
// products run on the tensor cores as 3xTF32 (tensor_core.cuh, 495 / 3 =
// 165 TFLOP/s).  Every live group's rhs must be read once.  In prefill
// (deepseek-moe-16b's w_in call: 64 groups x 2048 x 2816 f32 weights,
// 4506 live rows of 7680) that is 0.478 ms of bytes at 3.35 TB/s against
// 0.315 ms of 3xTF32 operations.  In decode (one token: 6 of 64 groups
// with one row each) it is two operations per rhs value read, and the
// empty groups' rhs must not be read at all.
//
// Three kernels behind the one entry point, chosen on the host from the
// shapes, the type and the pointers' alignment alone (C <= 16 and G <=
// 1024 is decode), so group_sizes is never read to the host.
//
// Prefill (tiled).  One CTA of 8 warps per (row tile, group, column
// tile) of 128 x 128 outputs, two CTAs a SM, the row tiles of one
// (group, column tile) adjacent in launch order (they share its rhs slab
// through L2) and the groups next, so that each wave holds tiles of many
// groups.  The CTA reads group_sizes[g] first; a tile at or past the
// size writes its zeros and loads nothing, so an empty group costs no
// rhs bytes, and lhs rows past the size are zero-filled without being
// read (masked before the product, as in _gmm_kernel).  f32 with 16-byte
// rows runs on warpgroup products (wgmma, "prefill, f32" below): each of
// two warpgroups owns 64 rows, takes its lhs fragments from global
// memory into registers and rhs through two shared-memory stages, and a
// warpgroup of padding rows issues no products.  bf16, and f32 whose
// rows are not 16-byte multiples, run on mma.sync: a 3-stage ring of
// 16-byte cp.async copies (scalar copies for odd rows), each warp owning
// a 32 x 64 block of the output, mma.m16n8k8 TF32 as 3xTF32 for f32 and
// mma.m16n8k16 for bf16, a warp's second 16-row fragment skipping its
// products when past the size.  For f32 the k order within a k-step is
// permuted in both operands and the n-tiles interleaved, so that each
// fragment read is one 8-byte pair and each output store 16 bytes; rows
// of the slices are padded (40 and 132 floats, 40 and 136 bf16) so that
// fragment reads are free of bank conflicts.
//
// Decode (split D).  A persistent grid of two CTAs a SM; each lists
// the live groups from group_sizes and walks work items (live group,
// 128-row slice of D, column tile of 32 lanes x 16 bytes): every lane
// keeps 16 loads of 16 bytes of rhs in flight and folds them into the
// live rows with f32 multiply-adds (two operations a byte: the tensor
// cores would only wait).  So 6 live groups are cut into 1056 (w_out)
// to 2112 (w_in) items over 132 SMs, and only they are read.  Each item writes its
// partial sums of the live rows to a scratch buffer that the wrapper
// allocates; a second kernel adds the D slices in order and writes the
// whole output, zeros in every padding row.  Every sum is taken in a
// fixed order with no atomics: results are equal bit for bit from run to
// run.
//
// Every launcher returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

using namespace e2c;

// ---------------------------------------------------------------- prefill
constexpr int kThreads = 256;   // 8 warps: 4 (rows) x 2 (columns)
constexpr int BM = 128;         // rows a tile
constexpr int BN = 128;         // columns a tile
constexpr int BKD = 32;         // depth of a slice
constexpr int STAGES = 3;

// Row strides of the slices, chosen so that fragment reads are free of
// bank conflicts: f32 reads lhs and rhs as 8-byte pairs (40, 132 floats),
// bf16 reads lhs as 4-byte pairs and rhs as single values (40, 136).
template <typename T>
struct Ring {
  static constexpr int LDA = BKD + 8;                            // lhs rows
  static constexpr int LDB = is_f32<T>() ? BN + 4 : BN + 8;      // rhs rows
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BKD * LDB;
  static constexpr size_t bytes = size_t(STAGES) * STAGE_ELEMS * sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
grouped_matmul_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                      const int* __restrict__ sizes, T* __restrict__ out,
                      int n_groups, int c, int d, int f) {
  using R = Ring<T>;
  constexpr int LDA = R::LDA, LDB = R::LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int n_rt = (c + BM - 1) / BM;
  int idx = blockIdx.x;
  const int rt = idx % n_rt;
  idx /= n_rt;
  const int g = idx % n_groups;
  const int ft = idx / n_groups;
  const int row0 = rt * BM, col0 = ft * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  T* ob = out + size_t(g) * c * f;
  const int live = min(sizes[g], c) - row0;   // live rows of this tile

  if (live <= 0) {
    for (int i = tid; i < BM * BN; i += kThreads) {
      const int r = row0 + i / BN, cc = col0 + i % BN;
      if (r < c && cc < f) ob[size_t(r) * f + cc] = from_f32<T>(0.f);
    }
    return;
  }

  const T* lb = lhs + (size_t(g) * c + row0) * d;
  const T* rb = rhs + size_t(g) * d * f;
  const bool vec = (d * sizeof(T)) % 16 == 0 && (f * sizeof(T)) % 16 == 0 &&
                   aligned16(lhs) && aligned16(rhs);
  // This thread's 16-byte chunks of a slice, the same in every slice:
  // lhs rows ar0 + RA j at column ac, rhs rows br0 + RB j at column bc.
  constexpr int CH = 16 / sizeof(T);
  constexpr int CPR_A = BKD / CH, RA = kThreads / CPR_A, NA = BM / RA;
  constexpr int CPR_B = BN / CH, RB = kThreads / CPR_B, NB = BKD / RB;
  const int ar0 = tid / CPR_A, ac = (tid % CPR_A) * CH;
  const int br0 = tid / CPR_B, bc = (tid % CPR_B) * CH;
  const T* a_src = lb + size_t(ar0) * d + ac;
  const T* b_src = rb + size_t(br0) * f + col0 + bc;
  const bool b_col = col0 + bc < f;

  auto load = [&](int stage, int k0) {
    T* as = smem + stage * R::STAGE_ELEMS;
    T* bs = as + R::A_ELEMS;
    if (vec) {
      const bool a_k = k0 + ac < d;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const bool in = a_k && ar0 + RA * j < live;
        cp_async16(as + (ar0 + RA * j) * LDA + ac,
                   in ? a_src + size_t(RA * j) * d + k0 : lb, in ? 16 : 0);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const bool in = b_col && k0 + br0 + RB * j < d;
        cp_async16(bs + (br0 + RB * j) * LDB + bc,
                   in ? b_src + size_t(k0 + RB * j) * f : rb, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * BKD; i += kThreads) {
        const int r = i / BKD, kk = i % BKD;
        as[r * LDA + kk] = (r < live && k0 + kk < d)
                               ? lb[size_t(r) * d + k0 + kk]
                               : from_f32<T>(0.f);
      }
      for (int i = tid; i < BKD * BN; i += kThreads) {
        const int kk = i / BN, cc = i % BN;
        bs[kk * LDB + cc] = (k0 + kk < d && col0 + cc < f)
                                ? rb[size_t(k0 + kk) * f + col0 + cc]
                                : from_f32<T>(0.f);
      }
    }
  };

  const int wm = 32 * (warp & 3), wn = 64 * (warp >> 2);
  const bool mt_live[2] = {wm < live, wm + 16 < live};
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int n_k = (d + BKD - 1) / BKD;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s * BKD);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice kt landed; slice kt - 1's stage is free
    if (kt + STAGES - 1 < n_k)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BKD);
    cp_async_commit();
    if (!mt_live[0]) continue;
    const T* as = smem + (kt % STAGES) * R::STAGE_ELEMS;
    const T* bs = as + R::A_ELEMS;
    // The second 16-row fragment's liveness, decided once a slice so that
    // no mma sits under a per-fragment branch.
    auto slice = [&](auto both) {
      constexpr bool BOTH = decltype(both)::value;
      if constexpr (is_f32<T>()) {
        // k order within a k-step permuted (slot t <- 2t, t + 4 <- 2t +
        // 1) in A and B alike, and n-tiles 2p, 2p + 1 taking the even and
        // odd columns of 16, so that every fragment read is one 8-byte
        // pair.
#pragma unroll
        for (int kk = 0; kk < BKD; kk += 8) {
          uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
          for (int mi = 0; mi < (BOTH ? 2 : 1); ++mi) {
            const T* ar = as + (wm + 16 * mi + gq) * LDA + kk + 2 * t;
            const float2 lo = *reinterpret_cast<const float2*>(ar);
            const float2 hi = *reinterpret_cast<const float2*>(ar + 8 * LDA);
            split(lo.x, a_big[mi][0], a_small[mi][0]);
            split(hi.x, a_big[mi][1], a_small[mi][1]);
            split(lo.y, a_big[mi][2], a_small[mi][2]);
            split(hi.y, a_big[mi][3], a_small[mi][3]);
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            // rows kk + 2t and kk + 2t + 1, columns 2 gq (tile 2p) and
            // 2 gq + 1 (tile 2p + 1) of the pair's 16
            const T* br = bs + (kk + 2 * t) * LDB + wn + 16 * p + 2 * gq;
            const float2 r0 = *reinterpret_cast<const float2*>(br);
            const float2 r1 = *reinterpret_cast<const float2*>(br + LDB);
            uint32_t ev_big[2], ev_small[2], od_big[2], od_small[2];
            split(r0.x, ev_big[0], ev_small[0]);
            split(r1.x, ev_big[1], ev_small[1]);
            split(r0.y, od_big[0], od_small[0]);
            split(r1.y, od_big[1], od_small[1]);
#pragma unroll
            for (int mi = 0; mi < (BOTH ? 2 : 1); ++mi) {
              mma_3xtf32(acc[mi][2 * p], a_big[mi], a_small[mi], ev_big,
                         ev_small);
              mma_3xtf32(acc[mi][2 * p + 1], a_big[mi], a_small[mi], od_big,
                         od_small);
            }
          }
        }
      } else {
        const uint32_t* aw = reinterpret_cast<const uint32_t*>(as);
        constexpr int LWA = LDA / 2;
#pragma unroll
        for (int kk = 0; kk < BKD; kk += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < (BOTH ? 2 : 1); ++mi) {
            const uint32_t* ar = aw + (wm + 16 * mi + gq) * LWA + kk / 2 + t;
            a[mi][0] = ar[0];
            a[mi][1] = ar[8 * LWA];
            a[mi][2] = ar[4];
            a[mi][3] = ar[8 * LWA + 4];
          }
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const T* br = bs + (kk + 2 * t) * LDB + wn + 8 * ni + gq;
            const uint32_t b0 = pack_bf16(br[0], br[LDB]);
            const uint32_t b1 = pack_bf16(br[8 * LDB], br[9 * LDB]);
#pragma unroll
            for (int mi = 0; mi < (BOTH ? 2 : 1); ++mi)
              mma_bf16(acc[mi][ni], a[mi], b0, b1);
          }
        }
      }
    };
    if (mt_live[1])
      slice(std::true_type{});
    else
      slice(std::false_type{});
  }
  cp_async_wait<0>();

  if constexpr (is_f32<T>()) {
    // Thread columns wn + 16 p + 4 t .. + 3 of rows r: tiles 2p, 2p + 1
    // interleaved, one 16-byte store.
    const bool vec_out = f % 4 == 0 && aligned16(out);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + 16 * mi + gq + 8 * h;
          const int cc = col0 + wn + 16 * p + 4 * t;
          if (row0 + r >= c || cc >= f) continue;
          const bool on = r < live;
          const float4 v4 = make_float4(
              on ? acc[mi][2 * p][2 * h] : 0.f,
              on ? acc[mi][2 * p + 1][2 * h] : 0.f,
              on ? acc[mi][2 * p][2 * h + 1] : 0.f,
              on ? acc[mi][2 * p + 1][2 * h + 1] : 0.f);
          T* dst = ob + size_t(row0 + r) * f + cc;
          if (vec_out && cc + 4 <= f) {
            *reinterpret_cast<float4*>(dst) = v4;
          } else {
            const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
            for (int u = 0; u < 4 && cc + u < f; ++u) dst[u] = vs[u];
          }
        }
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm + 16 * mi + gq + (e >= 2 ? 8 : 0);
          const int cc = col0 + wn + 8 * ni + 2 * t + (e & 1);
          if (row0 + r < c && cc < f)
            ob[size_t(row0 + r) * f + cc] =
                from_f32<T>(r < live ? acc[mi][ni][e] : 0.f);
        }
  }
}

// ------------------------------------------------------- prefill, f32
// The f32 tiles with 16-byte rows take warpgroup products instead:
// two warpgroups of a CTA own 64 rows each of the 128 x 128 tile and run
// wgmma.m64n128k8 as 3xTF32, lhs from registers and rhs from shared
// memory.  Each thread loads its lhs fragment of a 16-deep slice straight
// from global memory (4 adjacent depths of two rows, one 16-byte load
// each) and splits it in registers; the depth order within the slice is
// permuted to make that so (product slot t of step s holds depth 4 t + 2 s,
// slot t + 4 depth 4 t + 2 s + 1), and rhs is stored in the same order.
// rhs is loaded one slice ahead into registers, split and stored K-major
// (transposed) in core matrices of 8 columns x 4 depths, 128 bytes, no
// swizzle, in two stages: each warpgroup waits for a slice's products
// before the barrier that precedes the next slice's, so a stage is free
// again two slices later.  The other CTA on the SM fills the wait.  A
// warpgroup whose 64 rows are all padding issues no products.
constexpr int WG_BK = 16;                           // depth of a slice
constexpr int WG_OPERAND = BN * WG_BK;              // floats of rhs big
constexpr int WG_STAGE = 2 * WG_OPERAND;            // rhs big and small
constexpr int WG_STAGES = 2;
constexpr size_t WG_SMEM = size_t(WG_STAGES) * WG_STAGE * sizeof(float);

// Float offset of (column n, depth group q) of a K-major rhs stage: 4
// depths of one column are one 16-byte row of a core matrix.
__device__ __forceinline__ int core_offset(int n, int q) {
  return (q * 16 + (n >> 3)) * 32 + (n & 7) * 4;
}

// Shared-memory matrix descriptor of a K-major operand, no swizzle: core
// matrices 128 bytes apart along the columns (stride byte offset) and
// 2048 bytes (16 core matrices) apart along the depth (leading byte
// offset).
__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return uint64_t((a & 0x3ffff) >> 4) | (uint64_t(2048 >> 4) << 16) |
         (uint64_t(128 >> 4) << 32);
}

// d += A B on one warpgroup: A 64 x 8 tf32 in registers (the mma.m16n8k8
// A fragment of each warp's 16 rows), B 8 x 128 tf32 in shared memory;
// d in the m64n128 f32 accumulator layout.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers in place around the asynchronous products, so that the
// compiler moves none of them while a product is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

__device__ __forceinline__ float4 split4(float4 x, float4& small) {
  uint32_t b[4], s[4];
  split(x.x, b[0], s[0]);
  split(x.y, b[1], s[1]);
  split(x.z, b[2], s[2]);
  split(x.w, b[3], s[3]);
  small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                      __uint_as_float(s[2]), __uint_as_float(s[3]));
  return make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                     __uint_as_float(b[2]), __uint_as_float(b[3]));
}

// Needs d % 4 == 0, f % 2 == 0, 16-byte aligned lhs and rhs and 8-byte
// aligned out.
__global__ void __launch_bounds__(kThreads, 2)
grouped_matmul_wgmma_kernel(const float* __restrict__ lhs,
                            const float* __restrict__ rhs,
                            const int* __restrict__ sizes,
                            float* __restrict__ out, int n_groups, int c,
                            int d, int f) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  float* smem = reinterpret_cast<float*>(wg_smem);

  const int n_rt = (c + BM - 1) / BM;
  int idx = blockIdx.x;
  const int rt = idx % n_rt;
  idx /= n_rt;
  const int g = idx % n_groups;
  const int ft = idx / n_groups;
  const int row0 = rt * BM, col0 = ft * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ob = out + size_t(g) * c * f;
  const int live = min(sizes[g], c) - row0;   // live rows of this tile

  if (live <= 0) {
    for (int i = tid; i < BM * BN; i += kThreads) {
      const int r = row0 + i / BN, cc = col0 + i % BN;
      if (r < c && cc < f) ob[size_t(r) * f + cc] = 0.f;
    }
    return;
  }

  // lhs: rows ar and ar + 8 (this warp's 16 of its warpgroup's 64) at
  // depths 4 (lane % 4) .. + 3.  rhs: depths br + 4 i at columns 2 bp and
  // 2 bp + 1.
  const int wg = warp >> 2, t = lane & 3;
  const int ar = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int br = warp >> 1, bp = (warp & 1) * 32 + lane;
  const float* lb = lhs + (size_t(g) * c + row0) * d + 4 * t;
  const float* rb = rhs + size_t(g) * d * f + col0 + 2 * bp;
  const bool b_col = col0 + 2 * bp < f;
  float4 a_raw[2];
  float2 b_raw[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ar + 8 * h;
      a_raw[h] = (r < live && k0 + 4 * t < d)
                     ? __ldg(reinterpret_cast<const float4*>(
                           lb + size_t(r) * d + k0))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + br + 4 * i;
      b_raw[i] = (b_col && k < d)
                     ? __ldg(reinterpret_cast<const float2*>(
                           rb + size_t(k) * f))
                     : make_float2(0.f, 0.f);
    }
  };
  // rhs depths br, br + 4, br + 8, br + 12 of a column are one 16-byte
  // row of depth group br: product step br / 2, slots (br % 2) * 4 .. + 3.
  auto store_b = [&](float* st) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 v = e == 0 ? make_float4(b_raw[0].x, b_raw[1].x,
                                            b_raw[2].x, b_raw[3].x)
                              : make_float4(b_raw[0].y, b_raw[1].y,
                                            b_raw[2].y, b_raw[3].y);
      const int o = core_offset(2 * bp + e, br);
      float4 small;
      const float4 big = split4(v, small);
      *reinterpret_cast<float4*>(st + o) = big;
      *reinterpret_cast<float4*>(st + WG_OPERAND + o) = small;
    }
  };
  // lhs fragments [step][register], big and small: depth 4 t + 2 s in
  // slot t of step s, 4 t + 2 s + 1 in slot t + 4.
  uint32_t a_big[2][4], a_small[2][4];
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // The test is made warp-uniform by shuffles: the compiler serializes
  // products under a branch it cannot prove uniform.
  const bool wg_live = 64 * __shfl_sync(0xffffffffu, wg, 0) <
                       __shfl_sync(0xffffffffu, live, 0);

  const int n_k = (d + WG_BK - 1) / WG_BK;
  load(0);
  for (int kt = 0; kt < n_k; ++kt) {
    float* st = smem + (kt % WG_STAGES) * WG_STAGE;
    store_b(st);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split(a_raw[h].x, a_big[0][h], a_small[0][h]);
      split(a_raw[h].y, a_big[0][h + 2], a_small[0][h + 2]);
      split(a_raw[h].z, a_big[1][h], a_small[1][h]);
      split(a_raw[h].w, a_big[1][h + 2], a_small[1][h + 2]);
    }
    if (kt + 1 < n_k) load((kt + 1) * WG_BK);
    // the generic-proxy stores become visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (!wg_live) continue;
    pin(acc);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      pin(a_big[s]);
      pin(a_small[s]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* b_big = st + 2 * s * 16 * 32;   // depth groups 2 s, 2 s + 1
      const float* b_small = b_big + WG_OPERAND;
      wgmma_tf32(acc, a_small[s], wg_desc(b_big));
      wgmma_tf32(acc, a_big[s], wg_desc(b_small));
      wgmma_tf32(acc, a_big[s], wg_desc(b_big));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }

  // acc[4 j + e]: row 16 (warp % 4) + lane / 4 (+ 8 for e >= 2) of this
  // warpgroup's 64, column 8 j + 2 (lane % 4) (+ 1 for odd e).
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ar + 8 * h;
      const int cc = col0 + 8 * j + 2 * t;
      if (row0 + r >= c || cc >= f) continue;
      const bool on = r < live;
      *reinterpret_cast<float2*>(ob + size_t(row0 + r) * f + cc) =
          make_float2(on ? acc[4 * j + 2 * h] : 0.f,
                      on ? acc[4 * j + 2 * h + 1] : 0.f);
    }
}

// ----------------------------------------------------------------- decode
constexpr int kDecodeThreads = 256;   // 8 warps, one row of D each a step
constexpr int DK = 128;               // rows of D an item
constexpr int DR = DK / 8;            // rhs loads in flight a lane
constexpr int kMaxDecodeGroups = 1024;
constexpr int kDecodeCtasPerSm = 2;

// rhs columns a work item covers: 32 lanes x 16 bytes.
template <typename T> __host__ __device__ constexpr int decode_cols() {
  return 32 * (16 / int(sizeof(T)));
}

// Element u of a 16-byte chunk of T values, as f32; and its setter.
template <typename T>
__device__ __forceinline__ float chunk_get(const uint4& v, int u) {
  if constexpr (is_f32<T>()) {
    return __uint_as_float((&v.x)[u]);
  } else {
    const uint32_t w = (&v.x)[u / 2];
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((u & 1) ? w >> 16 : w & 0xffffu)));
  }
}

template <typename T>
__device__ __forceinline__ void chunk_set(uint4& v, int u, T x) {
  if constexpr (is_f32<T>()) {
    (&v.x)[u] = __float_as_uint(x);
  } else {
    uint32_t& w = (&v.x)[u / 2];
    const uint32_t h = __bfloat16_as_ushort(x);
    w = (u & 1) ? (w & 0xffffu) | (h << 16) : (w & 0xffff0000u) | h;
  }
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(kDecodeThreads)
grouped_matmul_decode_kernel(const T* __restrict__ lhs,
                             const T* __restrict__ rhs,
                             const int* __restrict__ sizes,
                             float* __restrict__ part, int n_groups, int c,
                             int d, int f, int n_split) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int COLS = decode_cols<T>();
  __shared__ int live_g[kMaxDecodeGroups];
  __shared__ int n_live;
  __shared__ float ls[CMAX][DK];
  __shared__ float red[8][COLS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < n_groups; base += 32) {
      const int gi = base + lane;
      const bool on = gi < n_groups && sizes[gi] > 0;
      const uint32_t mask = __ballot_sync(0xffffffffu, on);
      if (on) live_g[cnt + __popc(mask & ((1u << lane) - 1))] = gi;
      cnt += __popc(mask);
    }
    if (lane == 0) n_live = cnt;
  }
  __syncthreads();

  const bool vec = (f * sizeof(T)) % 16 == 0 && aligned16(rhs);
  const int n_ft = (f + COLS - 1) / COLS;
  const long long items = (long long)n_live * n_split * n_ft;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int ft = int(w % n_ft);
    const int sp = int((w / n_ft) % n_split);
    const int g = live_g[w / ((long long)n_ft * n_split)];
    const int rows = min(sizes[g], c);
    const int d0 = sp * DK, dn = min(DK, d - d0);

    __syncthreads();   // the previous item is done with ls and red
    for (int i = tid; i < rows * DK; i += kDecodeThreads) {
      const int r = i / DK, kk = i % DK;
      ls[r][kk] = kk < dn ? to_f32(lhs[(size_t(g) * c + r) * d + d0 + kk])
                          : 0.f;
    }
    // This lane's rhs rows d0 + warp + 8 j and columns col .. col + VEC.
    const int col = ft * COLS + lane * VEC;
    const T* rp = rhs + (size_t(g) * d + d0 + warp) * f + col;
    uint4 x[DR];   // 16 bytes of rhs a row, in the input type
#pragma unroll
    for (int j = 0; j < DR; ++j) {
      x[j] = make_uint4(0, 0, 0, 0);
      if (warp + 8 * j >= dn) continue;
      const T* src = rp + size_t(8 * j) * f;
      if (vec && col + VEC <= f) {
        x[j] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          if (col + u < f) chunk_set<T>(x[j], u, src[u]);
      }
    }
    __syncthreads();   // ls is staged

    float acc[CMAX][VEC];
#pragma unroll
    for (int r = 0; r < CMAX; ++r)
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[r][u] = 0.f;
#pragma unroll
    for (int j = 0; j < DR; ++j)
#pragma unroll
      for (int r = 0; r < CMAX; ++r) {
        if (r >= rows) break;
        const float a = ls[r][warp + 8 * j];
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc[r][u] = fmaf(a, chunk_get<T>(x[j], u), acc[r][u]);
      }

    // Sum the 8 warps' rows in order, one live row at a time.
#pragma unroll
    for (int r = 0; r < CMAX; ++r) {
      if (r >= rows) break;
#pragma unroll
      for (int u = 0; u < VEC; ++u) red[warp][lane * VEC + u] = acc[r][u];
      __syncthreads();
      for (int cc = tid; cc < COLS; cc += kDecodeThreads) {
        float sum = red[0][cc];
#pragma unroll
        for (int ww = 1; ww < 8; ++ww) sum += red[ww][cc];
        const int gc = ft * COLS + cc;
        if (gc < f)
          part[((size_t(sp) * n_groups + g) * c + r) * f + gc] = sum;
      }
      __syncthreads();
    }
  }
}

// out[g][r] = sum over the D slices, in order, of the partial rows; 0 in
// every row at or past the size.
template <typename T>
__global__ void __launch_bounds__(256)
grouped_matmul_reduce_kernel(const float* __restrict__ part,
                             const int* __restrict__ sizes,
                             T* __restrict__ out, int n_groups, int c, int f,
                             int n_split) {
  const size_t total = size_t(n_groups) * c * f;
  const size_t plane = total;   // one D slice of partials
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t gr = i / f;
    const int r = int(gr % c), g = int(gr / c);
    float sum = 0.f;
    if (r < sizes[g])
      for (int sp = 0; sp < n_split; ++sp) sum += part[sp * plane + i];
    out[i] = from_f32<T>(sum);
  }
}

int sm_count() {
  static int cached = 0;
  if (!cached) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess && n > 0)
      cached = n;
    else
      return 132;
  }
  return cached;
}

bool is_decode(int g, int c) { return c <= 16 && g <= kMaxDecodeGroups; }

int n_split(int d) { return (d + DK - 1) / DK; }

// One CTA per (row tile, group, column tile) of a tiled prefill kernel,
// its shared-memory opt-in set on the first launch.
template <typename T,
          void (*Kernel)(const T*, const T*, const int*, T*, int, int, int,
                         int),
          size_t SMEM>
int launch_prefill(const void* lhs, const void* rhs, const void* sizes,
                   void* out, int g, int c, int d, int f,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(Kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const long long ctas =
      (long long)((c + BM - 1) / BM) * g * ((f + BN - 1) / BN);
  if (ctas >= (1ll << 31)) return int(cudaErrorInvalidValue);
  Kernel<<<unsigned(ctas), kThreads, SMEM, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<const int*>(sizes), static_cast<T*>(out), g, c, d, f);
  return int(cudaGetLastError());
}

template <typename T>
int launch_decode(const void* lhs, const void* rhs, const void* sizes,
                  void* out, float* part, int g, int c, int d, int f,
                  cudaStream_t stream) {
  const int splits = n_split(d);
  const long long items = (long long)g * splits *
                          ((f + decode_cols<T>() - 1) / decode_cols<T>());
  const long long ctas =
      std::min<long long>(items, (long long)kDecodeCtasPerSm * sm_count());
  if (ctas > 0) {
    if (c <= 8)
      grouped_matmul_decode_kernel<T, 8><<<unsigned(ctas), kDecodeThreads, 0,
                                           stream>>>(
          static_cast<const T*>(lhs), static_cast<const T*>(rhs),
          static_cast<const int*>(sizes), part, g, c, d, f, splits);
    else
      grouped_matmul_decode_kernel<T, 16><<<unsigned(ctas), kDecodeThreads,
                                            0, stream>>>(
          static_cast<const T*>(lhs), static_cast<const T*>(rhs),
          static_cast<const int*>(sizes), part, g, c, d, f, splits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  const size_t total = size_t(g) * c * f;
  const size_t blocks = std::min<size_t>((total + 255) / 256,
                                         size_t(8) * sm_count());
  grouped_matmul_reduce_kernel<T><<<unsigned(blocks), 256, 0, stream>>>(
      part, static_cast<const int*>(sizes), static_cast<T*>(out), g, c, f,
      splits);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of scratch the decode kernel needs for these shapes (its
// partial sums, one (G, C, F) plane per 128-row slice of D), 0 when the
// shapes take the tiled kernel.
long long e2c_grouped_matmul_scratch(int g, int c, int d, int f) {
  if (!is_decode(g, c)) return 0;
  return (long long)n_split(d) * g * c * f;
}

int e2c_grouped_matmul(const void* lhs, const void* rhs, const void* sizes,
                       void* out, void* scratch, int g, int c, int d, int f,
                       int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_decode(g, c)) {
    float* part = static_cast<float*>(scratch);
    if (part == nullptr && n_split(d) > 0) return int(cudaErrorInvalidValue);
    if (bf16)
      return launch_decode<__nv_bfloat16>(lhs, rhs, sizes, out, part, g, c,
                                          d, f, s);
    return launch_decode<float>(lhs, rhs, sizes, out, part, g, c, d, f, s);
  }
  using B16 = __nv_bfloat16;
  if (bf16)
    return launch_prefill<B16, grouped_matmul_kernel<B16>, Ring<B16>::bytes>(
        lhs, rhs, sizes, out, g, c, d, f, s);
  if (d % 4 == 0 && f % 2 == 0 && aligned16(lhs) && aligned16(rhs) &&
      (reinterpret_cast<uintptr_t>(out) & 7) == 0)
    return launch_prefill<float, grouped_matmul_wgmma_kernel, WG_SMEM>(
        lhs, rhs, sizes, out, g, c, d, f, s);
  return launch_prefill<float, grouped_matmul_kernel<float>,
                        Ring<float>::bytes>(lhs, rhs, sizes, out, g, c, d, f,
                                            s);
}

}  // extern "C"
