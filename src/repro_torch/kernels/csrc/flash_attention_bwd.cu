// The backward of flash attention for Hopper (sm_90a): dQ, dK and dV of
// the online-softmax attention of flash_attention.cu, with its causal,
// sliding-window and key-length masks and its softcap, from Q, K, V, the
// output O, the row statistics lse = m + log(l) that the forward wrote,
// and dO.  Inputs f32 or bf16, f32 accumulation, gradients in the input
// type.
//
// Replaces no Pallas kernel: the JAX package trains through the XLA
// models/attention.py::flash_chunked (:117) and takes its gradient with
// jax.vjp; it has no backward kernel.  This is the gradient of that same
// function on the kernel route the port takes for every prefill.
//
// What bounds it on this card: operations.  A causal head of S rows at
// width hd takes five products of S * S / 2 * hd multiply-adds (S and dP
// again, dV, dK, dQ): 5 * 2 * S^2 * hd / 2 operations against some 8 * S
// * hd values moved, some S / 3 operations per byte read in f32.  The
// least time is that count at the tensor-core rate of the input type
// (989 TFLOP/s bf16, 165 TFLOP/s as 3xTF32 for f32).
//
// Design (FlashAttention-2, deterministic, no atomics).  This first form
// runs on the CUDA cores: every product is an f32 FMA from shared memory,
// register-tiled; wgmma and TMA are later work.
//   * preprocess: one warp a row, D = rowsum(dO * O) in f32;
//   * dK/dV: one CTA a (bh, block of BK keys), its K and V in shared
//     memory, looping over the query blocks whose causal or window band
//     reaches those keys.  For each it loads Q, dO, lse and D, computes
//     S = Q K^T and dP = dO V^T (16 logits of each a thread at hd 128,
//     float4 reads over hd), then P = exp(s - lse), dS = P (dP - D), times
//     1 - tanh^2 under a softcap, times hd^-0.5, into shared memory, and
//     accumulates dV += P^T dO and dK += dS^T Q in registers (a thread
//     owns BK / 16 keys x HD / 16 columns of each);
//   * dQ: one CTA a (bh, block of BQ queries), its Q, dO, lse and D in
//     shared memory, looping over the key blocks in the band: S and dP
//     again, dS, dQ += dS K.
// Each sum runs in a fixed order, so two launches on the same inputs give
// the same bits.  A row with no visible key (or past Sq) has P = 0 and
// so zero gradient; the forward writes lse 0 for it.  Shared rows are
// padded to HD + 4 floats (float4 reads of 8 neighbouring rows fall in
// distinct banks) and the P / dS tiles to BK + 16 (two query rows a warp
// 16 banks apart).  expf and tanhf, not the fast intrinsics.
//
// Every launcher returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "tensor_core.cuh"

namespace {

using namespace e2c;

constexpr int kThreads = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16

__device__ __forceinline__ bool visible(int qp, int kp, int sq, int sk,
                                        int causal, int window) {
  return qp < sq && kp < sk && (!causal || kp <= qp) &&
         (!window || qp - kp < window);
}

// Shared-memory layout of one instance: Q, dO (BQ rows), K, V (BK rows),
// P and dS (BQ x BK, the dQ kernel uses only dS), lse and D (BQ).
template <int HD, int BQ, int BK>
struct Tiles {
  static constexpr int LD = HD + 4;     // row stride of Q, dO, K, V
  static constexpr int LP = BK + 16;    // row stride of P and dS
  static constexpr size_t floats =
      size_t(2 * BQ + 2 * BK) * LD + size_t(2) * BQ * LP + 2 * BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

// rows [row0, row0 + R) of a (n, hd) matrix into shared memory as f32,
// zeros past n and past hd.  Every thread issues its loads before it
// stores any: 16-byte loads where the rows are 16-byte multiples (a bf16
// chunk is 8 values, widened to two float4 stores), else one value a
// load.
template <typename T, int HD, int R, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int n, int hd) {
  constexpr int CH = 16 / sizeof(T);    // values a 16-byte chunk
  constexpr int CPR = HD / CH;          // chunks a row
  static_assert((R * CPR) % kThreads == 0 && (R * HD) % kThreads == 0,
                "tile size");
  if (hd % CH == 0 && aligned16(src)) {
    constexpr int PER = R * CPR / kThreads;
    uint4 x[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / CPR, c = (i % CPR) * CH, gr = row0 + r;
      x[j] = gr < n && c < hd
                 ? *reinterpret_cast<const uint4*>(src + size_t(gr) * hd + c)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * kThreads;
      float* d = dst + (i / CPR) * LD + (i % CPR) * CH;
      if constexpr (is_f32<T>()) {
        *reinterpret_cast<uint4*>(d) = x[j];
      } else {
        const uint32_t w[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
        float f[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {   // the lower value in the low half
          f[2 * u] = __uint_as_float(w[u] << 16);
          f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
        }
        *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(f[4], f[5], f[6], f[7]);
      }
    }
    return;
  }
  constexpr int PER = R * HD / kThreads;
  float x[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / HD, c = i % HD, gr = row0 + r;
    x[j] = gr < n && c < hd ? to_f32(src[size_t(gr) * hd + c]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * kThreads;
    dst[(i / HD) * LD + i % HD] = x[j];
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// S = Q K^T and dP = dO V^T for this thread's rows ty + 16 a and keys
// tx + 16 b, then P and dS of the block into shared memory.
template <int HD, int BQ, int BK>
__device__ __forceinline__ void probs(const float* qs, const float* dos,
                                      const float* ks, const float* vs,
                                      const float* lse_s, const float* d_s,
                                      float* ps, float* dss, int q0, int k0,
                                      int sq, int sk, int hd, int causal,
                                      int window, float scale,
                                      float softcap) {
  using L = Tiles<HD, BQ, BK>;
  constexpr int LD = L::LD, LP = L::LP;
  constexpr int NA = BQ / 16, NB = BK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[NA][NB], dp[NA][NB];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 x[NA], y[NB];
#pragma unroll
    for (int a = 0; a < NA; ++a)
      x[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      y[b] = *reinterpret_cast<const float4*>(ks + (tx + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) s[a][b] = dot4(x[a], y[b], s[a][b]);
  }
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 x[NA], y[NB];
#pragma unroll
    for (int a = 0; a < NA; ++a)
      x[a] = *reinterpret_cast<const float4*>(dos + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      y[b] = *reinterpret_cast<const float4*>(vs + (tx + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) dp[a][b] = dot4(x[a], y[b], dp[a][b]);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int r = ty + 16 * a;
    const float lse = lse_s[r], dd = d_s[r];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int c = tx + 16 * b;
      float p = 0.f, ds = 0.f;
      if (visible(q0 + r, k0 + c, sq, sk, causal, window)) {
        float x = s[a][b] * scale, dcap = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(x / softcap);
          x = softcap * t;
          dcap = 1.f - t * t;
        }
        p = expf(x - lse);
        ds = p * (dp[a][b] - dd) * dcap * scale;
      }
      ps[r * LP + c] = p;
      dss[r * LP + c] = ds;
    }
  }
}

// Grid (bh, key blocks): dK and dV of BK keys.
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int hd, int causal,
                      int window, float scale, float softcap) {
  using L = Tiles<HD, BQ, BK>;
  constexpr int LD = L::LD, LP = L::LP;
  constexpr int NK = BK / 16, NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;
  float* dss = ps + BQ * LP;
  float* lse_s = dss + BQ * LP;
  float* d_s = lse_s + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const T* qb = q + bh * sq * hd;
  const T* dob = dout + bh * sq * hd;
  load_rows<T, HD, BK, LD>(ks, k + bh * sk * hd, k0, sk, hd);
  load_rows<T, HD, BK, LD>(vs, v + bh * sk * hd, k0, sk, hd);

  // Query rows that see any of keys k0 .. k0 + BK - 1.
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(sq, k0 + BK - 1 + window) : sq;
  float4 acc_k[NK][NC], acc_v[NK][NC];
#pragma unroll
  for (int a = 0; a < NK; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc_k[a][c] = acc_v[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int q0 = q_lo / BQ * BQ; q0 < q_hi; q0 += BQ) {
    __syncthreads();   // the previous block's tiles are read
    load_rows<T, HD, BQ, LD>(qs, qb, q0, sq, hd);
    load_rows<T, HD, BQ, LD>(dos, dob, q0, sq, hd);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < sq;
      lse_s[r] = in ? lse[bh * sq + q0 + r] : 0.f;
      d_s[r] = in ? delta[bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();
    probs<HD, BQ, BK>(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, sq, sk,
                      hd, causal, window, scale, softcap);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: keys ty + 16 a, columns 4 tx + 64 c.
    for (int r = 0; r < BQ; ++r) {
      float4 o4[NC], q4[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o4[c] = *reinterpret_cast<const float4*>(dos + r * LD + 4 * tx +
                                                 64 * c);
        q4[c] = *reinterpret_cast<const float4*>(qs + r * LD + 4 * tx +
                                                 64 * c);
      }
#pragma unroll
      for (int a = 0; a < NK; ++a) {
        const float p = ps[r * LP + ty + 16 * a];
        const float ds = dss[r * LP + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          axpy4(acc_v[a][c], p, o4[c]);
          axpy4(acc_k[a][c], ds, q4[c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NK; ++a) {
    const int kr = k0 + ty + 16 * a;
    if (kr >= sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      const float gk[4] = {acc_k[a][c].x, acc_k[a][c].y, acc_k[a][c].z,
                           acc_k[a][c].w};
      const float gv[4] = {acc_v[a][c].x, acc_v[a][c].y, acc_v[a][c].z,
                           acc_v[a][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < hd) {
          dk[(bh * sk + kr) * hd + col + e] = from_f32<T>(gk[e]);
          dv[(bh * sk + kr) * hd + col + e] = from_f32<T>(gv[e]);
        }
    }
  }
}

// Grid (bh, query blocks), the block index reversed so that causal
// blocks with the most keys start first: dQ of BQ rows.
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int hd, int causal, int window,
                    float scale, float softcap) {
  using L = Tiles<HD, BQ, BK>;
  constexpr int LD = L::LD, LP = L::LP;
  constexpr int NA = BQ / 16, NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;     // written by probs, unread here
  float* dss = ps + BQ * LP;
  float* lse_s = dss + BQ * LP;
  float* d_s = lse_s + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* kb = k + bh * sk * hd;
  const T* vb = v + bh * sk * hd;
  load_rows<T, HD, BQ, LD>(qs, q + bh * sq * hd, q0, sq, hd);
  load_rows<T, HD, BQ, LD>(dos, dout + bh * sq * hd, q0, sq, hd);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? lse[bh * sq + q0 + r] : 0.f;
    d_s[r] = in ? delta[bh * sq + q0 + r] : 0.f;
  }

  // Keys any row of the block can see: [k_lo, k_hi).
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  float4 acc[NA][NC];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous block's tiles are read
    load_rows<T, HD, BK, LD>(ks, kb, k0, sk, hd);
    load_rows<T, HD, BK, LD>(vs, vb, k0, sk, hd);
    __syncthreads();
    probs<HD, BQ, BK>(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, sq, sk,
                      hd, causal, window, scale, softcap);
    __syncthreads();
    // dQ += dS K: rows ty + 16 a, columns 4 tx + 64 c.
    for (int j = 0; j < BK; ++j) {
      float4 k4[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        k4[c] = *reinterpret_cast<const float4*>(ks + j * LD + 4 * tx +
                                                 64 * c);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float ds = dss[(ty + 16 * a) * LP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) axpy4(acc[a][c], ds, k4[c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int qr = q0 + ty + 16 * a;
    if (qr >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      const float g[4] = {acc[a][c].x, acc[a][c].y, acc[a][c].z,
                          acc[a][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < hd) dq[(bh * sq + qr) * hd + col + e] = from_f32<T>(g[e]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ o,
                            const T* __restrict__ dout,
                            float* __restrict__ delta, long long rows,
                            int hd) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32)
    s = fmaf(to_f32(dout[row * hd + d]), to_f32(o[row * hd + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  return err;
}

template <typename T, int HD, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, int hd, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  auto dkdv = flash_bwd_dkdv_kernel<T, HD, BQ, BK>;
  auto dqk = flash_bwd_dq_kernel<T, HD, BQ, BK>;
  constexpr size_t smem = Tiles<HD, BQ, BK>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(dkdv, smem);
    if (err == cudaSuccess) err = allow_smem(dqk, smem);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)bh * sq;
  const int per = kThreads / 32;
  flash_bwd_preprocess_kernel<T><<<(rows + per - 1) / per, kThreads, 0,
                                   stream>>>(static_cast<const T*>(o), dot,
                                             delta, rows, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dkdv<<<dim3(bh, (sk + BK - 1) / BK), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, hd, causal, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dqk<<<dim3(bh, (sq + BQ - 1) / BQ), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), sq, sk, hd, causal,
      window, scale, softcap);
  return int(cudaGetLastError());
}

// Tiles per head-width instance (query rows, keys a block): at hd <= 128
// 64 x 64 (shared memory 111 KB at hd 64, 177 KB at 128), at hd 256
// 32 x 32 (146 KB); all of it f32, whatever the input type.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int bh, int sq, int sk, int hd, int causal,
             int window, float scale, float softcap, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 bh, sq, sk, hd, causal, window, scale,
                                 softcap, stream);
  if (hd <= 128)
    return launch<T, 128, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  bh, sq, sk, hd, causal, window, scale,
                                  softcap, stream);
  if (hd <= 256)
    return launch<T, 256, 32, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  bh, sq, sk, hd, causal, window, scale,
                                  softcap, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o, dout, dq (bh, sq, hd); k, v, dk, dv (bh, sk, hd); lse and the
// scratch delta (bh, sq) f32.  Head widths 1 .. 256: shared rows are
// zero past hd, so the float4 reads over hd may run past it.
int e2c_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv,
                            int bh, int sq, int sk, int hd, int causal,
                            int window, float scale, float softcap, int bf16,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<float*>(delta);
  if (hd <= 0 || hd > 256 || bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0)
    return int(cudaErrorInvalidValue);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, l, d, dq, dk, dv, bh,
                                   sq, sk, hd, causal, window, scale,
                                   softcap, s);
  return dispatch<float>(q, k, v, o, dout, l, d, dq, dk, dv, bh, sq, sk, hd,
                         causal, window, scale, softcap, s);
}

}  // extern "C"
