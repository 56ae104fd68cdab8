// Fused softmax cross-entropy for Hopper (sm_90a): forward and backward,
// one CTA per row of logits.
//
// Replaces: paddle_tpu/ops/fused_ce.py::_ce_fwd_impl (pallas_call at
// fused_ce.py:159) and ::_ce_bwd_impl (pallas_call at :200).
//   forward:  lse_i = log Σ_j exp(x_ij) (online max/sum, fp32),
//             pick_i = x_i,label_i (0 for a label outside [0, V)),
//             loss_i = lse_i − pick_i; lse is saved for the backward;
//   backward: dx_ij = (exp(x_ij − lse_i) − [j == label_i]) · dloss_i, in
//             x's dtype.
// Neither pass writes a [N, V] softmax: the forward reads the logits once
// and writes two [N] vectors, the backward reads them once and writes dx.
//
// What bounds it on an H100: bytes.  At the train path's loss head
// (N = 2048 rows, V = 50304, bf16) the forward reads 206 MB and does a few
// operations per element; the backward reads 206 MB and writes 206 MB.
// So the design is a streaming one: each thread walks its row with 16-byte
// loads (8 bf16 or 4 fp32), consecutive threads on consecutive addresses,
// keeps a running (max, sum) in registers and merges it across the CTA at
// the end; the label logit is read once, by one thread, in the same pass.
// Rows whose length or base address is not a multiple of 16 bytes take a
// scalar walk instead.  The TPU kernel's vocab-block divisibility and row
// padding do not apply: any N and V work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_vec.cuh"

namespace {

using row_vec::from_f;
using row_vec::loadv;
using row_vec::storev;
using row_vec::to_f;
using row_vec::Vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

// Merge a running (max m, sum l of exp(x − m)) with another.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse, int V) {
  constexpr int NV = Vec<T>::n;
  const int row = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + (size_t)row * V;
  float m = kNeg, l = 0.f;
  if (VEC) {
#pragma unroll 4
    for (int j = tid * NV; j < V; j += kThreads * NV) {
      float e[NV];
      loadv(xr + j, e);
      float mv = e[0];
#pragma unroll
      for (int i = 1; i < NV; ++i) mv = fmaxf(mv, e[i]);
      const float mn = fmaxf(m, mv);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) s += expf(e[i] - mn);
      l = l * expf(m - mn) + s;
      m = mn;
    }
  } else {
    for (int j = tid; j < V; j += kThreads) {
      const float e = to_f(xr[j]);
      const float mn = fmaxf(m, e);
      l = l * expf(m - mn) + expf(e - mn);
      m = mn;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
  }
  __shared__ float sm[kWarps], sl[kWarps];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) merge(m, l, sm[w], sl[w]);
    const float ls = m + logf(l);
    const long long lab = labels[row];
    const float pick = (lab >= 0 && lab < V) ? to_f(xr[lab]) : 0.f;
    lse[row] = ls;
    loss[row] = ls - pick;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ dloss,
              T* __restrict__ dx, int V) {
  constexpr int NV = Vec<T>::n;
  const int row = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)row * V;
  const float ls = lse[row], dl = dloss[row];
  const long long lab = labels[row];
  if (VEC) {
#pragma unroll 4
    for (int j = tid * NV; j < V; j += kThreads * NV) {
      float e[NV];
      loadv(x + base + j, e);
#pragma unroll
      for (int i = 0; i < NV; ++i)
        e[i] = (expf(e[i] - ls) - (j + i == lab ? 1.f : 0.f)) * dl;
      storev(dx + base + j, e);
    }
  } else {
    for (int j = tid; j < V; j += kThreads) {
      const float p = expf(to_f(x[base + j]) - ls);
      from_f(dx + base + j, (p - (j == lab ? 1.f : 0.f)) * dl);
    }
  }
}

template <typename T>
cudaError_t fwd(const void* x, const void* labels, void* loss, void* lse,
                int N, int V, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const long long* lt = static_cast<const long long*>(labels);
  float *lo = static_cast<float*>(loss), *ls = static_cast<float*>(lse);
  if (row_vec::aligned<T>(V, x))
    ce_fwd_kernel<T, true><<<N, kThreads, 0, st>>>(xt, lt, lo, ls, V);
  else
    ce_fwd_kernel<T, false><<<N, kThreads, 0, st>>>(xt, lt, lo, ls, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* labels, const void* lse,
                const void* dloss, void* dx, int N, int V, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const long long* lt = static_cast<const long long*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dloss);
  T* dt = static_cast<T*>(dx);
  if (row_vec::aligned<T>(V, x, dx))
    ce_bwd_kernel<T, true><<<N, kThreads, 0, st>>>(xt, lt, ls, dl, dt, V);
  else
    ce_bwd_kernel<T, false><<<N, kThreads, 0, st>>>(xt, lt, ls, dl, dt, V);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (logits and dx).  logits [N, V] and dx
// contiguous, labels [N] int64, loss / lse / dloss [N] float32.  Each
// returns cudaGetLastError() after its launch.
extern "C" int ce_fwd(const void* x, const void* labels, void* loss,
                      void* lse, int N, int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)fwd<float>(x, labels, loss, lse, N, V, st);
  if (dtype == 1) return (int)fwd<__nv_bfloat16>(x, labels, loss, lse, N, V, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ce_bwd(const void* x, const void* labels, const void* lse,
                      const void* dloss, void* dx, int N, int V, int dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)bwd<float>(x, labels, lse, dloss, dx, N, V, st);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(x, labels, lse, dloss, dx, N, V, st);
  return (int)cudaErrorInvalidValue;
}
