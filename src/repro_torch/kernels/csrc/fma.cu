// The learned policies' multiply-add: out = x * w + acc, float32,
// rounded once (__fmaf_rn), over broadcast operands.
//
// The reference's forward pass (repro/core/neural.py, compiled by XLA)
// sums each score as chains and lanes of fused multiply-adds, one
// rounding each.  core/neural.py copies those association orders term by
// term; this kernel is its one multiply-add step on the card, and
// kernels/ref.py::fma_ref (reduce.fma, exact in float64 with round to
// odd) is its plain version on the CPU: both give the correctly rounded
// x * w + acc, so the two devices agree bit for bit.
//
// Operands arrive as strided views of up to four dimensions, broadcast
// to the output's shape (a stride of 0 on a broadcast axis), so a call
// is one launch and no operand is copied or expanded first.  The output
// is contiguous.  One thread an element, a grid-stride loop, 32-bit
// index arithmetic: the launcher refuses a call whose element count or
// operand offsets do not fit (the forward pass's largest call has some
// 8.4M elements).  The work is a few bytes an element, bound by memory
// and at the forward pass's shapes by launch latency.

#include <cuda_runtime.h>

// Passed by value from Python (kernels/build.py::FmaGeom), so it lives
// outside the anonymous namespace: a type with internal linkage would
// give the extern "C" launcher internal linkage too, and no symbol.
struct E2cFmaGeom {
  long long n;          // elements of the output
  long long shape[4];   // output shape, leading axes padded with 1
  long long sx[4];      // element strides of x, w, acc on those axes
  long long sw[4];
  long long sa[4];
};

namespace {

// 32-bit index arithmetic (the divisions of the index into coordinates
// are 32-bit ones); the launcher checks that every index and offset fits.
__global__ void fma_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ acc,
                           float* __restrict__ out, E2cFmaGeom g) {
  unsigned shape[4], sx[4], sw[4], sa[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    shape[d] = static_cast<unsigned>(g.shape[d]);
    sx[d] = static_cast<unsigned>(g.sx[d]);
    sw[d] = static_cast<unsigned>(g.sw[d]);
    sa[d] = static_cast<unsigned>(g.sa[d]);
  }
  const unsigned n = static_cast<unsigned>(g.n);
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    unsigned rest = i, ox = 0, ow = 0, oa = 0;
#pragma unroll
    for (int d = 3; d >= 0; --d) {
      const unsigned c = rest % shape[d];
      rest /= shape[d];
      ox += c * sx[d];
      ow += c * sw[d];
      oa += c * sa[d];
    }
    out[i] = __fmaf_rn(x[ox], w[ow], acc[oa]);
  }
}

// The largest element offset an operand with strides s reaches.
long long max_offset(const E2cFmaGeom& g, const long long* s) {
  long long off = 0;
  for (int d = 0; d < 4; ++d) off += (g.shape[d] - 1) * s[d];
  return off;
}

}  // namespace

extern "C" {

const char* e2c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int e2c_fma(const float* x, const float* w, const float* acc, float* out,
            E2cFmaGeom g, void* stream) {
  if (g.n <= 0) return 0;
  const int threads = 256;
  long long blocks = (g.n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 CTAs an SM, then stride
  const long long lim = (1LL << 31) - 1 - static_cast<long long>(blocks)
                                                 * threads;
  const bool fits = g.n <= lim && max_offset(g, g.sx) <= lim
                    && max_offset(g, g.sw) <= lim
                    && max_offset(g, g.sa) <= lim;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  fma_kernel<<<static_cast<int>(blocks), threads, 0,
               static_cast<cudaStream_t>(stream)>>>(x, w, acc, out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
