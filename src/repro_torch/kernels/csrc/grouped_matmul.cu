// Grouped matrix product of the MoE expert FFN for Hopper (sm_90a):
// out[g] = lhs[g] @ rhs[g] for G groups, where only the first
// group_sizes[g] rows of each group hold tokens; f32 accumulation, output
// in the input type, rows at or past the size exactly 0.
//
// Replaces src/repro/kernels/grouped_matmul.py::grouped_matmul (:50, body
// _gmm_kernel :29, pallas_call :70).
//
// What bounds it on this card depends on the rows a group holds.  In
// prefill (a few hundred live rows a group) it is operations: each rhs
// value read is used once per live row, above the float32 balance of
// about 20 operations per byte.  In decode (one token, 6 of 64 groups
// with one row each) it is bytes: the live groups' rhs must be read
// once, for two operations a value, and the empty groups' rhs not at all.
//
// Design.  One CTA per (g, 64-row tile, 64-column tile).  The CTA reads
// group_sizes[g] first; a tile whose first row is at or past the size
// writes its zeros and loads nothing, so an empty group costs no rhs
// bytes (the Pallas kernel's scalar-prefetched skip).  A live tile walks D
// in 32-deep slices staged in shared memory: the lhs slice with rows past
// the size loaded as 0 and not read (masked before the product, as in
// _gmm_kernel), the rhs slice read once by the CTA and used by all its
// live rows.  Each thread owns a 4 x 4 block of the output in registers;
// a warp owns 8 consecutive rows and skips the multiply-adds when all of
// them are past the size, so a decode tile with one live row runs one
// warp's arithmetic while all eight warps share the loads.  The epilogue
// writes 0 for rows past the size, as the oracle does.  f32 multiply-adds
// on the CUDA cores; no tensor-core instruction or load pipelining yet.
//
// Every launcher returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int BC = 64;          // rows a tile
constexpr int BF = 64;          // columns a tile
constexpr int BD = 32;          // depth of a shared-memory slice
constexpr int LD = 68;          // row stride of the slices (16-byte rows)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                      const int* __restrict__ sizes, T* __restrict__ out,
                      int c, int d, int f) {
  __shared__ __align__(16) float as[BD][LD];   // lhs slice, as[k][row]
  __shared__ __align__(16) float bs[BD][LD];   // rhs slice, bs[k][col]
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * BC;
  const int col0 = blockIdx.x * BF;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  T* ob = out + size_t(g) * c * f;
  const int live = min(sizes[g], c) - row0;   // live rows of this tile

  if (live <= 0) {
    for (int i = tid; i < BC * BF; i += kThreads) {
      const int r = row0 + i / BF, cc = col0 + i % BF;
      if (r < c && cc < f) ob[size_t(r) * f + cc] = from_f32<T>(0.f);
    }
    return;
  }

  const T* lb = lhs + (size_t(g) * c + row0) * d;
  const T* rb = rhs + size_t(g) * d * f;
  const bool warp_live = (tid / 32) * 8 < live;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BD) {
    for (int i = tid; i < BC * BD; i += kThreads) {
      const int r = i / BD, kk = i % BD, gk = k0 + kk;
      as[kk][r] = (r < live && gk < d) ? to_f32(lb[size_t(r) * d + gk]) : 0.f;
    }
    for (int i = tid; i < BD * BF; i += kThreads) {
      const int kk = i / BF, cc = i % BF, gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < d && gc < f) ? to_f32(rb[size_t(gk) * f + gc]) : 0.f;
    }
    __syncthreads();
    if (warp_live) {
#pragma unroll 8
      for (int kk = 0; kk < BD; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (row0 + r >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx * 4 + j;
      if (cc < f)
        ob[size_t(row0 + r) * f + cc] = from_f32<T>(r < live ? acc[i][j]
                                                             : 0.f);
    }
  }
}

template <typename T>
int launch(const void* lhs, const void* rhs, const void* sizes, void* out,
           int g, int c, int d, int f, cudaStream_t stream) {
  dim3 grid((f + BF - 1) / BF, (c + BC - 1) / BC, g);
  grouped_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<const int*>(sizes), static_cast<T*>(out), c, d, f);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int e2c_grouped_matmul(const void* lhs, const void* rhs, const void* sizes,
                       void* out, int g, int c, int d, int f, int bf16,
                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(lhs, rhs, sizes, out, g, c, d, f, s);
  return launch<float>(lhs, rhs, sizes, out, g, c, d, f, s);
}

}  // extern "C"
