// Flash attention for Hopper (sm_90a): online-softmax attention over
// (BH, S, hd) with causal, sliding-window and key-length masks and an
// optional softcap, f32 accumulation, output in the input type.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (:92,
// body _flash_kernel :28, pallas_call :122).
//
// What bounds it on this card: operations.  A causal prefill of S keys
// does 4 * hd * S * (S + 1) / 2 multiply-adds per head against
// 4 * S * hd values moved, some S / 4 operations per byte read in f32 --
// at S = 1024 about 64 times the 20 operations per byte at which the
// H100's float32 rate (67 TFLOP/s) overtakes its 3.35 TB/s.
//
// Design.  The Pallas kernel walks a (BH, q-block, k-block) grid whose
// last axis runs in order, carrying (m, l, acc) in VMEM scratch from one
// key block to the next, and skips blocks above the diagonal or left of
// the window band with pl.when.  CUDA blocks run in no order, so the
// sequential key axis becomes a loop inside the block: one CTA per
// (bh, query tile) stages its query tile in shared memory once, then
// walks key tiles in increasing order from the first tile the window band
// can reach to the diagonal tile (the Pallas block skip, rebuilt as loop
// bounds; a skipped tile is one whose every (q, k) pair is masked, so the
// skip is exact).  Each K/V tile is staged in shared memory and read by
// every query row of the tile, which is what keeps the kernel on the
// operations side of the roofline.  The logits tile goes to shared memory
// with masked logits at -1e30; one warp per row takes the row maximum,
// writes p = expf(s - m_new) (exactly 0 where masked) and folds alpha and
// the row sum into (m, l); then each thread adds its register block of
// p @ V into its slice of the f32 accumulator, which never leaves
// registers.  A row that saw no visible key has l == 0 and outputs 0.
// The products are f32 multiply-adds on the CUDA cores: no tensor-core
// instruction yet (wgmma, TMA and pipelining are later work).  Odd shared
// memory row strides keep the column reads of the logits loop free of
// bank conflicts.  expf and tanhf, not the fast intrinsics.
//
// Every launcher returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;   // a 16 x 8 grid of threads
constexpr float kNeg = -1e30f;

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

__device__ __forceinline__ bool visible(int qp, int kp, int sk, int causal,
                                        int window) {
  return kp < sk && (!causal || kp <= qp) && (!window || qp - kp < window);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, int BQ, int BK>
constexpr size_t smem_floats() {
  return size_t(BQ) * (HD + 1) + size_t(BK) * (HD + 1) + size_t(BK) * HD +
         size_t(BQ) * (BK + 1) + 3 * size_t(BQ);
}

// HD: the head width the instance is built for (hd <= HD); BQ query rows
// and BK key rows a tile.  Thread (ty, tx) = (tid / 8, tid % 8) owns query
// rows ty + 16 i, key columns tx + 8 j of the logits tile and head columns
// tx + 8 j of the accumulator.
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int sk, int hd, int causal, int window, float scale,
                       float softcap) {
  constexpr int LDQ = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int RQ = BQ / 16;
  constexpr int RK = BK / 8;
  constexpr int RD = HD / 8;
  static_assert(BQ % 16 == 0 && BK % 8 == 0 && HD % 8 == 0, "tile shape");
  extern __shared__ float smem[];
  float* qs = smem;                 // BQ x LDQ
  float* ks = qs + BQ * LDQ;        // BK x LDQ
  float* vs = ks + BK * LDQ;        // BK x HD
  float* ps = vs + BK * HD;         // BQ x LDP: logits, then p
  float* m_s = ps + BQ * LDP;       // BQ running maxima
  float* l_s = m_s + BQ;            // BQ running sums
  float* a_s = l_s + BQ;            // BQ rescale factors of this tile

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * sq * hd;
  const T* kb = k + bh * sk * hd;
  const T* vb = v + bh * sk * hd;
  T* ob = o + bh * sq * hd;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    qs[r * LDQ + d] = (qr < sq && d < hd) ? to_f32(qb[size_t(qr) * hd + d])
                                          : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  // Keys any row of this tile can see: [k_lo, k_hi).
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's p and V are consumed
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, kr = k0 + r;
      const bool in = kr < sk && d < hd;
      ks[r * LDQ + d] = in ? to_f32(kb[size_t(kr) * hd + d]) : 0.f;
      vs[r * HD + d] = in ? to_f32(vb[size_t(kr) * hd + d]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[RQ], b[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) b[j] = ks[(tx + 8 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int r = ty + 16 * i, c = tx + 8 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ps[r * LDP + c] = visible(q0 + r, k0 + c, sk, causal, window) ? x
                                                                      : kNeg;
      }
    __syncthreads();

    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int qp = q0 + r;
      float mx = kNeg;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, ps[r * LDP + c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = visible(qp, k0 + c, sk, causal, window)
                            ? expf(ps[r * LDP + c] - m_new)
                            : 0.f;
        ps[r * LDP + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
    // Keys at or past k_hi have p == 0 in every row: leave them out.
    const int kc = min(BK, k_hi - k0);
    for (int c = 0; c < kc; ++c) {
      float p[RQ], w[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) w[j] = vs[c * HD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    if (qp >= sq) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 8 * j;
      if (d < hd)
        ob[size_t(qp) * hd + d] =
            from_f32<T>(l > 0.f ? acc[i][j] / fmaxf(l, 1e-20f) : 0.f);
    }
  }
}

template <typename T, int HD, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int hd, int causal, int window, float scale,
           float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD, BQ, BK>;
  const size_t smem = smem_floats<HD, BQ, BK>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hd, causal,
      window, scale, softcap);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int sk, int hd, int causal, int window, float scale,
             float softcap, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64, 64, 64>(q, k, v, o, bh, sq, sk, hd, causal, window,
                                 scale, softcap, stream);
  if (hd <= 128)
    return launch<T, 128, 64, 64>(q, k, v, o, bh, sq, sk, hd, causal,
                                  window, scale, softcap, stream);
  if (hd <= 256)
    return launch<T, 256, 32, 32>(q, k, v, o, bh, sq, sk, hd, causal,
                                  window, scale, softcap, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int e2c_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int bh, int sq, int sk, int hd, int causal,
                        int window, float scale, float softcap, int bf16,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, hd, causal,
                                   window, scale, softcap, s);
  return dispatch<float>(q, k, v, o, bh, sq, sk, hd, causal, window, scale,
                         softcap, s);
}

}  // extern "C"
