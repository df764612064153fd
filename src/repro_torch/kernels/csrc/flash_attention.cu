// Flash attention for Hopper (sm_90a): online-softmax attention over
// (BH, S, hd) with causal, sliding-window and key-length masks and an
// optional softcap, f32 accumulation, output in the input type.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (:92,
// body _flash_kernel :28, pallas_call :122).
//
// What bounds it on this card: operations.  A causal prefill of S keys
// does 4 * hd * S * (S + 1) / 2 operations per head against 4 * S * hd
// values moved, some S / 4 operations per byte read in f32.  f32 inputs
// run on the tensor cores as 3xTF32 (tensor_core.cuh), three TF32
// products per f32 product, so the f32 rate is 495 / 3 = 165 TFLOP/s;
// at S = 1024 that is still some 5 times the balance point against
// 3.35 TB/s.  bf16 inputs run at the bf16 rate (989 TFLOP/s).
//
// Design (FlashAttention-2, with the key axis split across warps).  The
// Pallas kernel walks a (BH, q-block, k-block) grid whose last axis runs
// in order, carrying (m, l, acc) in VMEM and skipping blocks with
// pl.when.  Here one CTA takes 64 query rows of one (b, h) and loops over
// key stages in increasing order, from the first stage the window band
// can reach to the diagonal (the Pallas block skip as loop bounds, exact
// since a skipped stage is fully masked).  A prefill call has few query
// rows for the card (16 heads x 1024 rows is 1024 warps of 16 rows, some
// 8 a SM), so the CTA's warps are 4 row warps times KS key groups: each
// stage holds KS x BK keys, key group kg multiplies its BK of them, and
// the groups' (m, l, acc) are merged in group order at the end.  Each
// warp owns 16 query rows: the logits, the running (m, l) and the output
// accumulator stay in registers as mma fragments, a row's maximum takes
// two shuffles within its quad (the row sum stays per thread until the
// end), and a warp skips the products of keys none of its rows can see.
// Logits P go back into the P @ V product straight from their
// accumulator registers: for bf16 two logit fragments are one A
// fragment; for TF32 the A fragment's key order is permuted (slot t <-
// key 2t, slot t + 4 <- key 2t + 1) and V's rows are read in the same
// order.  For f32 the Q tile is split into (big, small) once per CTA; K
// and V are split as warps read their fragments, and the big*big and
// cross terms of QK^T go to separate accumulators (two mma chains, not
// one).  K and V stages are double-buffered in shared memory and loaded
// with 16-byte cp.async, each thread copying the same chunks of every
// stage, so stage j + 1 is in flight while stage j multiplies; rows are
// padded (hd + 4 floats, hd + 8 bf16) so that every fragment read is
// free of bank conflicts.  At hd 128 a CTA is 16 warps and one a SM
// (f32: 198 KB of shared memory, 16-key groups; bf16: 153 KB, 32-key
// groups).  The q-tile index is reversed so that causal tiles with the
// most keys start first.  Masked logits are -1e30 and their p exactly 0;
// a row that saw no visible key has l == 0 and outputs 0.  expf and
// tanhf, not the fast intrinsics.  Given an lse buffer (training), the
// epilogue also writes each row's m + log(l) in f32 (0 for a row with no
// visible key), which the backward (flash_attention_bwd.cu) reads; with
// a null pointer (serving) it writes nothing more and the output's
// arithmetic is the same.
//
// Decode (Sq <= kDecodeMaxSq; a cross-attention step has Sq = 1) takes
// another route.  The tiled kernel gives one CTA to a (bh, 64-row query
// tile), which walks all keys in turn: at Sq = 1 that is 16 CTAs on 132
// SMs, each a serial loop over 1024 keys, 63 of its 64 rows idle.  One
// query row has no tile for the tensor cores and uses each K and V
// element once, so the call is bound by bytes: the decode kernel splits
// the keys instead (flash decoding).  Grid (BH, key blocks, Sq), a block
// 64, 32 or 16 keys at hd <= 64, 128, 256 (32 KB of f32 K and V).  A CTA
// first puts every 16-byte chunk of its block's K and V in flight with
// cp.async (a row read as a warp reaches its key keeps too few bytes in
// flight to approach the HBM rate), then computes the logits in f32 on the CUDA cores (warp w takes keys w,
// w + 4, ..., a lane columns lane + 32 c, one shuffle reduction a key);
// one warp reduces the block's maximum m and sum l with shuffles; P V
// takes a thread an output column (at hd 64 two threads a column, each
// half of the keys).  It writes (acc, m, l) to the caller's scratch.
// The reduce kernel merges a row's blocks in block order, rescaling each
// by expf(m_block - m), and writes acc / l; no load waits on another
// (a branch on l would make each one wait for the last).
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

constexpr int kRowWarps = 4;
constexpr int BQ = 16 * kRowWarps;   // query rows a CTA, 16 a warp
constexpr float kNeg = -1e30f;

// Shared-memory layout of one instance: Q (BQ rows), then two stages of
// K and two of V (KS x BK rows each).  f32 keeps Q as (big, small)
// pairs.  After the key loop the same memory holds the key groups'
// (acc, m, l) for their merge.
template <typename T, int HD, int BK, int KS>
struct Layout {
  static constexpr int LD = is_f32<T>() ? HD + 4 : HD + 8;  // row stride
  using QElem = typename std::conditional<is_f32<T>(), float2, T>::type;
  static constexpr size_t q_bytes = size_t(BQ) * LD * sizeof(QElem);
  static constexpr size_t tile_elems = size_t(KS) * BK * LD;
  static constexpr size_t merge_floats = size_t(kRowWarps) * (HD / 2 + 4) * 32;
  static constexpr size_t loop_bytes = q_bytes + 4 * tile_elems * sizeof(T);
  static constexpr size_t bytes = loop_bytes > merge_floats * 4
                                      ? loop_bytes : merge_floats * 4;
};

__device__ __forceinline__ bool visible(int qp, int kp, int sk, int causal,
                                        int window) {
  return kp < sk && (!causal || kp <= qp) && (!window || qp - kp < window);
}

template <typename T> __device__ __forceinline__ T zero() {
  return from_f32<T>(0.f);
}

// HD: the head width the instance is built for (hd <= HD); each stage
// holds KS x BK keys, and warp group kg (warps 4 kg .. 4 kg + 3, one per
// 16 query rows) takes keys kg BK .. kg BK + BK - 1 of every stage.
// Grid (BH, query tiles), the tile index reversed.
template <typename T, int HD, int BK, int KS>
__global__ void __launch_bounds__(32 * kRowWarps * KS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int hd,
                       int causal, int window, float scale, float softcap) {
  using L = Layout<T, HD, BK, KS>;
  using QElem = typename L::QElem;
  constexpr int kThreads = 32 * kRowWarps * KS;
  constexpr int LD = L::LD;
  constexpr int KSTAGE = KS * BK;               // keys a stage
  constexpr int KSTEP = is_f32<T>() ? 8 : 16;   // depth of one mma
  constexpr int NS = BK / 8;                    // logit fragments a row
  constexpr int ND = HD / 8;                    // output fragments a row
  static_assert(BK % (is_f32<T>() ? 8 : 16) == 0 && HD % 32 == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  QElem* qs = reinterpret_cast<QElem*>(smem);
  T* kv = reinterpret_cast<T*>(smem + L::q_bytes);  // K0, K1, V0, V1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % kRowWarps, kg = warp / kRowWarps;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * sq * hd;
  const T* kb = k + bh * sk * hd;
  const T* vb = v + bh * sk * hd;
  T* ob = o + bh * sq * hd;
  const bool vec = (hd * sizeof(T)) % 16 == 0 && aligned16(k) &&
                   aligned16(v);

  // Columns past hd of the K/V stages: zero once, never loaded.
  if (hd < HD)
    for (int i = tid; i < 4 * KSTAGE * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      if (c >= hd) kv[r * LD + c] = zero<T>();
    }
  // This thread's 16-byte chunks of a Q tile or a K/V stage, the same in
  // every stage: rows lr0 + RP j at column lc.
  constexpr int CH = 16 / sizeof(T);
  constexpr int CPR = HD / CH, RP = kThreads / CPR, NP = KSTAGE / RP;
  static_assert(kThreads % CPR == 0 && KSTAGE % RP == 0 && BQ % RP == 0,
                "tile chunks");
  const int lr0 = tid / CPR, lc = (tid % CPR) * CH;

  // The Q tile, split once for f32.
  if (vec && aligned16(q)) {
#pragma unroll
    for (int j = 0; j < BQ / RP; ++j) {
      const int r = lr0 + RP * j, qr = q0 + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (qr < sq && lc < hd)
        raw = *reinterpret_cast<const uint4*>(qb + size_t(qr) * hd + lc);
      if constexpr (is_f32<T>()) {
        const float x[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                            __uint_as_float(raw.z), __uint_as_float(raw.w)};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t big, small;
          split(x[u], big, small);
          qs[r * LD + lc + u] = make_float2(__uint_as_float(big),
                                            __uint_as_float(small));
        }
      } else {
        *reinterpret_cast<uint4*>(qs + r * LD + lc) = raw;
      }
    }
  } else {
    for (int i = tid; i < BQ * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, qr = q0 + r;
      const bool in = qr < sq && c < hd;
      if constexpr (is_f32<T>()) {
        uint32_t big, small;
        split(in ? qb[size_t(qr) * hd + c] : 0.f, big, small);
        qs[r * LD + c] = make_float2(__uint_as_float(big),
                                     __uint_as_float(small));
      } else {
        qs[r * LD + c] = in ? qb[size_t(qr) * hd + c] : zero<T>();
      }
    }
  }

  auto load_kv = [&](int stage, int k0) {
    T* kd = kv + stage * L::tile_elems;
    T* vd = kv + (2 + stage) * L::tile_elems;
    if (vec) {
      if (lc >= hd) return;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int r = lr0 + RP * j, kr = k0 + r;
        const size_t off = size_t(min(kr, sk - 1)) * hd + lc;
        const int n = kr < sk ? 16 : 0;
        cp_async16(kd + r * LD + lc, kb + off, n);
        cp_async16(vd + r * LD + lc, vb + off, n);
      }
    } else {
      for (int i = tid; i < KSTAGE * HD; i += kThreads) {
        const int r = i / HD, c = i % HD, kr = k0 + r;
        const bool in = kr < sk && c < hd;
        const size_t off = size_t(kr) * hd + c;
        kd[r * LD + c] = in ? kb[off] : zero<T>();
        vd[r * LD + c] = in ? vb[off] : zero<T>();
      }
    }
  };

  // Keys any row of this CTA can see: [k_lo, k_hi); of this warp's rows:
  // [w_lo, w_hi) (empty when all its rows are past sq).
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int kstart = k_lo / KSTAGE * KSTAGE;
  const int n_tiles =
      k_hi > kstart ? (k_hi - kstart + KSTAGE - 1) / KSTAGE : 0;
  const int wq0 = q0 + 16 * wr;
  const int w_lo = window ? max(0, wq0 - window + 1) : 0;
  const int w_hi = wq0 >= sq ? w_lo
                   : causal ? min(sk, min(wq0 + 15, sq - 1) + 1)
                            : sk;
  const int r0 = 16 * wr + g;   // this thread's rows r0 and r0 + 8

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  if (n_tiles > 0) load_kv(0, kstart);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kstart + it * KSTAGE;
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, k0 + KSTAGE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile it has landed for every thread
    const int kq = k0 + kg * BK;   // this warp group's keys kq .. kq + BK
    const T* kt = kv + (it & 1) * L::tile_elems + kg * BK * LD;
    const T* vt = kv + (2 + (it & 1)) * L::tile_elems + kg * BK * LD;

    if (kq < w_hi && kq + BK > w_lo) {
      // S = Q K^T, 16 x BK a warp.  f32: the big*big and the cross terms
      // go to two sets of accumulators, two independent mma chains a
      // logit fragment.
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (is_f32<T>()) {
        float sb[NS][4], sx[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[j][e] = sx[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / KSTEP; ++kk) {
          if (kk * KSTEP >= hd) break;
          const int c0 = kk * KSTEP;
          const float2 x0 = qs[r0 * LD + c0 + t];
          const float2 x1 = qs[(r0 + 8) * LD + c0 + t];
          const float2 x2 = qs[r0 * LD + c0 + t + 4];
          const float2 x3 = qs[(r0 + 8) * LD + c0 + t + 4];
          const uint32_t ab[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                  __float_as_uint(x2.x), __float_as_uint(x3.x)};
          const uint32_t as[4] = {__float_as_uint(x0.y), __float_as_uint(x1.y),
                                  __float_as_uint(x2.y), __float_as_uint(x3.y)};
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const T* kr = kt + (8 * j + g) * LD + c0 + t;
            uint32_t bb[2], bs[2];
            split(kr[0], bb[0], bs[0]);
            split(kr[4], bb[1], bs[1]);
            mma_tf32(sx[j], as, bb[0], bb[1]);
            mma_tf32(sx[j], ab, bs[0], bs[1]);
            mma_tf32(sb[j], ab, bb[0], bb[1]);
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = sx[j][e] + sb[j][e];
      } else {
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs);
        const uint32_t* kw = reinterpret_cast<const uint32_t*>(kt);
        constexpr int LW = LD / 2;
#pragma unroll
        for (int kk = 0; kk < HD / KSTEP; ++kk) {
          if (kk * KSTEP >= hd) break;
          const int cw = kk * KSTEP / 2 + t;
          const uint32_t a[4] = {qw[r0 * LW + cw], qw[(r0 + 8) * LW + cw],
                                 qw[r0 * LW + cw + 4],
                                 qw[(r0 + 8) * LW + cw + 4]};
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const uint32_t* kr = kw + (8 * j + g) * LW + cw;
            mma_bf16(s[j], a, kr[0], kr[4]);
          }
        }
      }

      // Scale, softcap, mask; then the online softmax of rows r0, r0 + 8.
      const bool full = kq + BK <= sk && (!causal || kq + BK - 1 <= wq0) &&
                        (!window || wq0 + 15 - kq < window);
      uint32_t vis = 0xffffffffu;   // bit 4 j + e: element (j, e) visible
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (!full) {
            const int qp = wq0 + g + (e >= 2 ? 8 : 0);
            const int kp = kq + 8 * j + 2 * t + (e & 1);
            if (!visible(qp, kp, sk, causal, window)) {
              x = kNeg;
              vis &= ~(1u << (4 * j + e));
            }
          }
          s[j][e] = x;
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m_run[i];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = expf(m_run[i] - mx);
        m_run[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = (vis >> (4 * j + e)) & 1u ? expf(s[j][e] - mx)
                                                      : 0.f;
            s[j][e] = p;
            sum += p;
          }
        l_run[i] = l_run[i] * alpha[i] + sum;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V.  Keys outside [w_lo, w_hi) have p == 0 in every row of
      // the warp: leave their fragments out.
      if constexpr (is_f32<T>()) {
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
          const int kp0 = kq + 8 * kk;
          if (kp0 >= w_hi) break;
          if (kp0 + 8 <= w_lo) continue;
          uint32_t pb[4], ps[4];   // slot t <- key 2t, slot t + 4 <- 2t + 1
          split(s[kk][0], pb[0], ps[0]);
          split(s[kk][2], pb[1], ps[1]);
          split(s[kk][1], pb[2], ps[2]);
          split(s[kk][3], pb[3], ps[3]);
          const T* vr = vt + (8 * kk + 2 * t) * LD + g;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            if (8 * n >= hd) break;
            uint32_t bb[2], bs[2];
            split(vr[8 * n], bb[0], bs[0]);
            split(vr[LD + 8 * n], bb[1], bs[1]);
            mma_3xtf32(acc[n], pb, ps, bb, bs);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          const int kp0 = kq + 16 * kk;
          if (kp0 >= w_hi) break;
          if (kp0 + 16 <= w_lo) continue;
          const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2],
                                           s[2 * kk + 1][3])};
          const T* vr = vt + (16 * kk + 2 * t) * LD + g;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            if (8 * n >= hd) break;
            const T* vc = vr + 8 * n;
            mma_bf16(acc[n], a, pack_bf16(vc[0], vc[LD]),
                     pack_bf16(vc[8 * LD], vc[9 * LD]));
          }
        }
      }
    }
    __syncthreads();   // stage it & 1 is free for tile it + 2
  }
  cp_async_wait<0>();

  // Merge the key groups' states into group 0, in group order: m the
  // larger, acc and l rescaled by expf(m_group - m).
  float* mb = reinterpret_cast<float*>(smem) + wr * (4 * ND + 4) * 32 + lane;
#pragma unroll 1
  for (int src = 1; src < KS; ++src) {
    __syncthreads();
    if (kg == src) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mb[(4 * ND + i) * 32] = m_run[i];
        mb[(4 * ND + 2 + i) * 32] = l_run[i];
      }
    }
    __syncthreads();
    if (kg == 0) {
      float a_own[2], a_src[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_src = mb[(4 * ND + i) * 32];
        const float mx = fmaxf(m_run[i], m_src);
        a_own[i] = expf(m_run[i] - mx);
        a_src[i] = expf(m_src - mx);
        m_run[i] = mx;
        l_run[i] = l_run[i] * a_own[i] + mb[(4 * ND + 2 + i) * 32] * a_src[i];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * a_own[e >> 1] +
                      mb[(4 * n + e) * 32] * a_src[e >> 1];
    }
  }
  if (kg != 0) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = wq0 + g + (e >= 2 ? 8 : 0);
      const int d = 8 * n + 2 * t + (e & 1);
      const float l = l_run[e >> 1];
      if (qp < sq && d < hd)
        ob[size_t(qp) * hd + d] =
            from_f32<T>(l > 0.f ? acc[n][e] / fmaxf(l, 1e-20f) : 0.f);
    }
  if (lse != nullptr && t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = wq0 + g + 8 * i;
      if (qp < sq)
        lse[bh * sq + qp] =
            l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : 0.f;
    }
}

constexpr int kDecodeMaxSq = 4;      // query rows that take the decode route
constexpr int kDecodeThreads = 128;

// Keys a decode CTA takes: 32 KB of f32 K and V at every head width.
__host__ __device__ constexpr int decode_keys(int hd) {
  return hd <= 64 ? 64 : hd <= 128 ? 32 : 16;
}

// Scratch of the decode route, per (bh, query row, key block): hd
// accumulator columns, then m and l.
long long decode_scratch(int bh, int sq, int sk, int hd) {
  if (sq > kDecodeMaxSq || sk <= 0) return 0;
  const long long blocks = (sk + decode_keys(hd) - 1) / decode_keys(hd);
  return (long long)bh * sq * blocks * (hd + 2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDecodeThreads)
flash_attention_decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              float* __restrict__ part, int sq, int sk,
                              int hd, int causal, int window, float scale,
                              float softcap) {
  constexpr int KB = decode_keys(HD);
  constexpr int NW = kDecodeThreads / 32;
  constexpr int DP = HD < kDecodeThreads ? HD : kDecodeThreads;  // columns
  constexpr int KP = kDecodeThreads / DP;   // threads a column
  constexpr int NC = HD / DP;               // columns a thread
  __shared__ __align__(16) T ks[KB * HD];
  __shared__ __align__(16) T vs[KB * HD];
  __shared__ float qs[HD];
  __shared__ float ps[KB];
  __shared__ float red[KP][DP];
  __shared__ float ml[2];   // the block's m and l
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = blockIdx.x;
  const int qp = blockIdx.z, k0 = blockIdx.y * KB;
  const int nk = min(KB, sk - k0);
  const T* kb = k + (bh * sk + k0) * hd;
  const T* vb = v + (bh * sk + k0) * hd;

  // Stage the block's keys and values in shared memory, every 16-byte
  // chunk of both in flight at once (rows past nk zero).
  if ((hd * sizeof(T)) % 16 == 0 && aligned16(k) && aligned16(v)) {
    constexpr int CH = 16 / sizeof(T);
    const int cpr = hd / CH;
    for (int i = tid; i < KB * cpr; i += kDecodeThreads) {
      const int r = i / cpr, c = (i % cpr) * CH;
      const size_t off = size_t(min(r, nk - 1)) * hd + c;
      const int n = r < nk ? 16 : 0;
      cp_async16(ks + r * HD + c, kb + off, n);
      cp_async16(vs + r * HD + c, vb + off, n);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < KB * hd; i += kDecodeThreads) {
      const int r = i / hd, c = i % hd;
      ks[r * HD + c] = r < nk ? kb[size_t(r) * hd + c] : zero<T>();
      vs[r * HD + c] = r < nk ? vb[size_t(r) * hd + c] : zero<T>();
    }
  }
  for (int d = tid; d < HD; d += kDecodeThreads)
    qs[d] = d < hd ? to_f32(q[(bh * sq + qp) * hd + d]) : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // Logits, scaled, softcapped and masked (-inf: not visible).
#pragma unroll
  for (int i = 0; i < KB / NW; ++i) {
    const int j = warp + NW * i;
    float s = 0.f;
    if (j < nk) {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) s = fmaf(qs[d], to_f32(ks[j * HD + d]), s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      float x = s * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      ps[j] = j < nk && visible(qp, k0 + j, sk, causal, window) ? x
                                                                : -INFINITY;
    }
  }
  __syncthreads();
  // The block's maximum m and sum l, one warp: lane t holds keys t + 32 i.
  if (warp == 0) {
    constexpr int NL = (KB + 31) / 32;
    float x[NL], m = -INFINITY, l = 0.f;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      x[i] = lane + 32 * i < KB ? ps[lane + 32 * i] : -INFINITY;
      m = fmaxf(m, x[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const float p = x[i] > -INFINITY ? expf(x[i] - m) : 0.f;
      if (lane + 32 * i < KB) ps[lane + 32 * i] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      ml[0] = m > -INFINITY ? m : kNeg;
      ml[1] = l;
    }
  }
  __syncthreads();

  // P V: thread (kp, d0) takes keys kp, kp + KP, ... of columns d0 + DP c.
  const int d0 = tid % DP, kp = tid / DP;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
#pragma unroll 8
  for (int j = kp; j < nk; j += KP) {
    const float p = ps[j];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = d0 + DP * c;
      if (d < hd) acc[c] = fmaf(p, to_f32(vs[j * HD + d]), acc[c]);
    }
  }
  if constexpr (KP > 1) {
    red[kp][d0] = acc[0];
    __syncthreads();
    if (kp == 0)
      for (int i = 1; i < KP; ++i) acc[0] += red[i][d0];
  }
  float* out = part + ((bh * sq + qp) * gridDim.y + blockIdx.y) * (hd + 2);
  if (kp == 0)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = d0 + DP * c;
      if (d < hd) out[d] = acc[c];
    }
  if (tid == 0) {
    out[hd] = ml[0];
    out[hd + 1] = ml[1];
  }
}

// One CTA a (bh, query row): the row's key blocks merged in order.  A
// block with no visible key has m = -1e30, l = 0 and acc = 0, so it adds
// nothing and needs no branch: every load of the loops is independent.
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
flash_attention_reduce_kernel(const float* __restrict__ part,
                              T* __restrict__ o, int n_blocks, int hd) {
  const size_t row = blockIdx.x;
  const float* pr = part + row * n_blocks * (hd + 2);
  float mx = kNeg;
#pragma unroll 8
  for (int b = 0; b < n_blocks; ++b) mx = fmaxf(mx, pr[b * (hd + 2) + hd]);
  for (int d = threadIdx.x; d < hd; d += kDecodeThreads) {
    float a = 0.f, l = 0.f;
#pragma unroll 8
    for (int b = 0; b < n_blocks; ++b) {
      const float* pb = pr + b * (hd + 2);
      const float w = expf(pb[hd] - mx);
      a = fmaf(w, pb[d], a);
      l = fmaf(w, pb[hd + 1], l);
    }
    o[row * hd + d] = from_f32<T>(l > 0.f ? a / fmaxf(l, 1e-20f) : 0.f);
  }
}

template <typename T, int HD>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* scratch, int bh, int sq, int sk, int hd, int causal,
                  int window, float scale, float softcap,
                  cudaStream_t stream) {
  constexpr int KB = decode_keys(HD);
  const int n_blocks = (sk + KB - 1) / KB;
  flash_attention_decode_kernel<T, HD>
      <<<dim3(bh, n_blocks, sq), kDecodeThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), scratch, sq, sk, hd, causal, window,
          scale, softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_attention_reduce_kernel<T>
      <<<bh * sq, kDecodeThreads, 0, stream>>>(scratch, static_cast<T*>(o),
                                               n_blocks, hd);
  return int(cudaGetLastError());
}

template <typename T, int HD, int BK, int KS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, int hd, int causal, int window,
           float scale, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD, BK, KS>;
  constexpr size_t smem = Layout<T, HD, BK, KS>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  dim3 grid(bh, (sq + BQ - 1) / BQ);
  kernel<<<grid, 32 * kRowWarps * KS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, hd, causal,
      window, scale, softcap);
  return int(cudaGetLastError());
}

// Tiles per head-width instance (keys a warp group takes from a stage,
// key groups): one CTA a SM, of 16 warps at hd <= 128 (f32 102 and 198
// KB of shared memory, bf16 81 and 153 KB) and of 8 at hd 256 (f32 195
// KB, bf16 99 KB).
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* scratch, float* lse, int bh, int sq, int sk, int hd,
             int causal, int window, float scale, float softcap,
             cudaStream_t stream) {
  constexpr bool f32 = is_f32<T>();
  if (decode_scratch(bh, sq, sk, hd) > 0) {
    // the split-key route is not a training shape: no lse there
    if (lse != nullptr) return int(cudaErrorInvalidValue);
    if (hd <= 64)
      return launch_decode<T, 64>(q, k, v, o, scratch, bh, sq, sk, hd,
                                  causal, window, scale, softcap, stream);
    if (hd <= 128)
      return launch_decode<T, 128>(q, k, v, o, scratch, bh, sq, sk, hd,
                                   causal, window, scale, softcap, stream);
    if (hd <= 256)
      return launch_decode<T, 256>(q, k, v, o, scratch, bh, sq, sk, hd,
                                   causal, window, scale, softcap, stream);
    return int(cudaErrorInvalidValue);
  }
  if (hd <= 64)
    return launch<T, 64, f32 ? 16 : 32, 4>(q, k, v, o, lse, bh, sq, sk,
                                           hd, causal, window, scale,
                                           softcap, stream);
  if (hd <= 128)
    return launch<T, 128, f32 ? 16 : 32, 4>(q, k, v, o, lse, bh, sq, sk,
                                            hd, causal, window, scale,
                                            softcap, stream);
  if (hd <= 256)
    return launch<T, 256, f32 ? 8 : 16, 2>(q, k, v, o, lse, bh, sq, sk,
                                           hd, causal, window, scale,
                                           softcap, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of scratch a call needs (the decode route's partial blocks; 0
// for the tiled kernel).
long long e2c_flash_attention_scratch(int bh, int sq, int sk, int hd) {
  return decode_scratch(bh, sq, sk, hd);
}

// lse: null, or (bh, sq) f32 for each row's m + log(l) (the tiled route
// only: a call of at most kDecodeMaxSq rows with lse is refused).
int e2c_flash_attention(const void* q, const void* k, const void* v, void* o,
                        void* scratch, void* lse, int bh, int sq, int sk,
                        int hd, int causal, int window, float scale,
                        float softcap, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto ws = static_cast<float*>(scratch);
  auto ls = static_cast<float*>(lse);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, ws, ls, bh, sq, sk, hd,
                                   causal, window, scale, softcap, s);
  return dispatch<float>(q, k, v, o, ws, ls, bh, sq, sk, hd, causal, window,
                         scale, softcap, s);
}

}  // extern "C"
