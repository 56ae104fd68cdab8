// Fused LayerNorm for Hopper (sm_90a): the forward, and the backward with
// its dgamma / dbeta column sums.
//
// Replaces: paddle_tpu/ops/fused_norm.py::_ln_fwd_impl (pallas_call at
// fused_norm.py:144) and ::_ln_bwd_impl (pallas_call at :202).
//   forward:  per row of x [N, F]: mu = mean(x), rstd = rsqrt(mean((x −
//             mu)²) + eps) — two passes in fp32, as the Pallas body — and
//             y = ((x − mu)·rstd)·g + b in fp32, written in x's dtype; mu
//             and rstd [N] fp32 are saved for the backward;
//   backward: xhat = (x − mu)·rstd, w = dy·g, c1 = mean(w), c2 =
//             mean(w·xhat), dx = (w − c1 − xhat·c2)·rstd in x's dtype;
//             dg = Σ_rows dy·xhat and db = Σ_rows dy in fp32.
//
// What bounds it on an H100: bytes.  At the train path's shape (N = 2048
// rows of F = 2048, bf16 x) the forward reads x and writes y (16.8 MB), the
// backward reads x and dy and writes dx (25.2 MB); each does tens of
// operations per element, far under the card's rate.  So each CTA holds a
// whole row in registers — every element is read from device memory once —
// with 16-byte loads (8 bf16 or 4 fp32 a thread, consecutive threads on
// consecutive addresses), and a scalar walk for rows whose length or base
// is not a multiple of 16 bytes.  A thread holds KV of those accesses, KV in
// {1, 2, 4, 8} picked by F, so F up to kMaxF = 8192 is taken (the JAX
// package's widest preset, gpt_13b, has F = 5120); a wider row is refused.
//
// The TPU sums dg and db across its sequential grid in one VMEM block.  CTAs
// run in no order here, so the backward is two kernels: each CTA of the
// first normalises R consecutive rows (dx; for rows of up to 2 accesses a
// thread, the next row's loads are started before the current row's
// reductions) and sums their dy·xhat and dy per
// column in registers, writing one fp32 partial row of each to a
// [nblocks, F] scratch; the second sums the partials of each column in
// block order.  No float atomics: the result is the same on every run.  R
// is chosen by the caller so that the first kernel has a few CTAs per SM.

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
constexpr int kMaxF = 8192;
constexpr int kSumThreads = 128;

// The column of a thread's element (k, i): access k of KV, element i of an
// access.  Vector walk: access k covers NV consecutive columns; scalar walk:
// consecutive threads take consecutive columns.
template <int NV, bool VEC>
__device__ __forceinline__ int col(int k, int i) {
  return VEC ? (threadIdx.x + k * kThreads) * NV + i
             : (k * NV + i) * kThreads + threadIdx.x;
}

// Load a row's elements of this thread (0 past F).
template <typename T, int KV, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ r, int F,
                                         float* v) {
  constexpr int NV = Vec<T>::n;
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    if (VEC) {
      const int j = col<NV, VEC>(k, 0);
      if (j < F) {
        loadv(r + j, v + k * NV);
      } else {
#pragma unroll
        for (int i = 0; i < NV; ++i) v[k * NV + i] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = col<NV, VEC>(k, i);
        v[k * NV + i] = j < F ? to_f(r[j]) : 0.f;
      }
    }
  }
}

template <typename T, int KV, bool VEC>
__device__ __forceinline__ void store_row(T* __restrict__ r, int F,
                                          const float* v) {
  constexpr int NV = Vec<T>::n;
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    if (VEC) {
      const int j = col<NV, VEC>(k, 0);
      if (j < F) storev(r + j, v + k * NV);
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = col<NV, VEC>(k, i);
        if (j < F) from_f(r + j, v[k * NV + i]);
      }
    }
  }
}

// The parameters (g or b, dtype W) at this thread's columns, as fp32.
template <typename W, int NV, int KV, bool VEC>
__device__ __forceinline__ void load_param(const W* __restrict__ p, int F,
                                           float* v) {
#pragma unroll
  for (int k = 0; k < KV; ++k)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = col<NV, VEC>(k, i);
      v[k * NV + i] = j < F ? to_f(p[j]) : 0.f;
    }
}

// Sums of a and b over the CTA, in a fixed order; every thread gets them.
__device__ __forceinline__ float2 block_sum(float a, float b, float2* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 t = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    t.x += sh[w].x;
    t.y += sh[w].y;
  }
  __syncthreads();               // sh is free for the next call
  return t;
}

template <typename T, typename W, int KV, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ g,
              const W* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mu, float* __restrict__ rstd, int F,
              float eps) {
  constexpr int NV = Vec<T>::n, E = KV * NV;
  __shared__ float2 sh[kWarps];
  const size_t base = (size_t)blockIdx.x * F;
  float v[E];
  load_row<T, KV, VEC>(x + base, F, v);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += v[e];
  const float m = block_sum(s, 0.f, sh).x / (float)F;
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = col<NV, VEC>(e / NV, e % NV);
    const float c = j < F ? v[e] - m : 0.f;
    q += c * c;
  }
  const float r = rsqrtf(block_sum(q, 0.f, sh).x / (float)F + eps);
  float gv[E], bv[E];
  load_param<W, NV, KV, VEC>(g, F, gv);
  load_param<W, NV, KV, VEC>(b, F, bv);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = ((v[e] - m) * r) * gv[e] + bv[e];
  store_row<T, KV, VEC>(y + base, F, v);
  if (threadIdx.x == 0) {
    mu[blockIdx.x] = m;
    rstd[blockIdx.x] = r;
  }
}

template <typename T, typename W, int KV, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ g,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ dg_part, float* __restrict__ db_part, int N,
              int F, int R) {
  constexpr int NV = Vec<T>::n, E = KV * NV;
  __shared__ float2 sh[kWarps];
  float gv[E], dga[E], dba[E];
  load_param<W, NV, KV, VEC>(g, F, gv);
#pragma unroll
  for (int e = 0; e < E; ++e) dga[e] = dba[e] = 0.f;
  const int r0 = blockIdx.x * R, r1 = min(r0 + R, N);
  // with registers to spare (rows of up to 2 accesses a thread), the next
  // row's loads stay in flight through this row's reductions
  constexpr bool PF = KV <= 2;
  float xh[E], d[E], xn[PF ? E : 1], dn[PF ? E : 1];
  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * F;
    if constexpr (PF) {
      if (row == r0) {
        load_row<T, KV, VEC>(x + base, F, xh);
        load_row<T, KV, VEC>(dy + base, F, d);
      }
      if (row + 1 < r1) {
        load_row<T, KV, VEC>(x + base + F, F, xn);
        load_row<T, KV, VEC>(dy + base + F, F, dn);
      }
    } else {
      load_row<T, KV, VEC>(x + base, F, xh);
      load_row<T, KV, VEC>(dy + base, F, d);
    }
    const float m = mu[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      xh[e] = (xh[e] - m) * r;
      const float w = d[e] * gv[e];      // 0 past F: d is
      s1 += w;
      s2 += w * xh[e];
    }
    const float2 c = block_sum(s1, s2, sh);
    const float c1 = c.x / (float)F, c2 = c.y / (float)F;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dga[e] += d[e] * xh[e];
      dba[e] += d[e];
      d[e] = (d[e] * gv[e] - c1 - xh[e] * c2) * r;
    }
    store_row<T, KV, VEC>(dx + base, F, d);
    if constexpr (PF) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xh[e] = xn[e];
        d[e] = dn[e];
      }
    }
  }
  const size_t pb = (size_t)blockIdx.x * F;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = col<NV, VEC>(e / NV, e % NV);
    if (j < F) {
      dg_part[pb + j] = dga[e];
      db_part[pb + j] = dba[e];
    }
  }
}

// dg[j] = Σ_blocks dg_part[blk, j] (and db), summed in block order.
__global__ void __launch_bounds__(kSumThreads)
ln_bwd_sum_kernel(const float* __restrict__ dg_part,
                  const float* __restrict__ db_part, float* __restrict__ dg,
                  float* __restrict__ db, int nb, int F) {
  const int j = blockIdx.x * kSumThreads + threadIdx.x;
  if (j >= F) return;
  float sg = 0.f, sb = 0.f;
  for (int blk = 0; blk < nb; ++blk) {
    sg += dg_part[(size_t)blk * F + j];
    sb += db_part[(size_t)blk * F + j];
  }
  dg[j] = sg;
  db[j] = sb;
}

// Accesses per thread for a row of F elements: 1, 2, 4 or 8 (0 = too wide).
template <typename T>
int accesses(int F) {
  const int per = kThreads * Vec<T>::n;
  for (int kv = 1; kv <= 8; kv *= 2)
    if (F <= kv * per) return kv;
  return 0;
}

template <typename T, typename W, int KV, bool VEC>
cudaError_t fwd_at(const void* x, const void* g, const void* b, void* y,
                   void* mu, void* rstd, int N, int F, float eps,
                   cudaStream_t st) {
  ln_fwd_kernel<T, W, KV, VEC><<<N, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(g),
      static_cast<const W*>(b), static_cast<T*>(y), static_cast<float*>(mu),
      static_cast<float*>(rstd), F, eps);
  return cudaGetLastError();
}

template <typename T, typename W, bool VEC>
cudaError_t fwd_vec(const void* x, const void* g, const void* b, void* y,
                    void* mu, void* rstd, int N, int F, float eps,
                    cudaStream_t st) {
  switch (accesses<T>(F)) {
    case 1: return fwd_at<T, W, 1, VEC>(x, g, b, y, mu, rstd, N, F, eps, st);
    case 2: return fwd_at<T, W, 2, VEC>(x, g, b, y, mu, rstd, N, F, eps, st);
    case 4: return fwd_at<T, W, 4, VEC>(x, g, b, y, mu, rstd, N, F, eps, st);
    case 8:   // fp32 only: a bf16 row of kMaxF takes 4 accesses
      if constexpr (4 * kThreads * Vec<T>::n < kMaxF)
        return fwd_at<T, W, 8, VEC>(x, g, b, y, mu, rstd, N, F, eps, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
cudaError_t fwd(const void* x, const void* g, const void* b, void* y,
                void* mu, void* rstd, int N, int F, float eps,
                cudaStream_t st) {
  if (row_vec::aligned<T>(F, x, y))
    return fwd_vec<T, W, true>(x, g, b, y, mu, rstd, N, F, eps, st);
  return fwd_vec<T, W, false>(x, g, b, y, mu, rstd, N, F, eps, st);
}

template <typename T, typename W, int KV, bool VEC>
cudaError_t bwd_at(const void* x, const void* g, const void* mu,
                   const void* rstd, const void* dy, void* dx, void* dg_part,
                   void* db_part, void* dg, void* db, int N, int F, int R,
                   cudaStream_t st) {
  const int nb = (N + R - 1) / R;
  ln_bwd_kernel<T, W, KV, VEC><<<nb, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(g),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), N, F, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_sum_kernel<<<(F + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                      st>>>(static_cast<const float*>(dg_part),
                            static_cast<const float*>(db_part),
                            static_cast<float*>(dg), static_cast<float*>(db),
                            nb, F);
  return cudaGetLastError();
}

template <typename T, typename W, bool VEC>
cudaError_t bwd_vec(const void* x, const void* g, const void* mu,
                    const void* rstd, const void* dy, void* dx,
                    void* dg_part, void* db_part, void* dg, void* db, int N,
                    int F, int R, cudaStream_t st) {
  switch (accesses<T>(F)) {
    case 1: return bwd_at<T, W, 1, VEC>(x, g, mu, rstd, dy, dx, dg_part,
                                        db_part, dg, db, N, F, R, st);
    case 2: return bwd_at<T, W, 2, VEC>(x, g, mu, rstd, dy, dx, dg_part,
                                        db_part, dg, db, N, F, R, st);
    case 4: return bwd_at<T, W, 4, VEC>(x, g, mu, rstd, dy, dx, dg_part,
                                        db_part, dg, db, N, F, R, st);
    case 8:
      if constexpr (4 * kThreads * Vec<T>::n < kMaxF)
        return bwd_at<T, W, 8, VEC>(x, g, mu, rstd, dy, dx, dg_part,
                                    db_part, dg, db, N, F, R, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
cudaError_t bwd(const void* x, const void* g, const void* mu,
                const void* rstd, const void* dy, void* dx, void* dg_part,
                void* db_part, void* dg, void* db, int N, int F, int R,
                cudaStream_t st) {
  if (row_vec::aligned<T>(F, x, dy, dx))
    return bwd_vec<T, W, true>(x, g, mu, rstd, dy, dx, dg_part, db_part, dg,
                               db, N, F, R, st);
  return bwd_vec<T, W, false>(x, g, mu, rstd, dy, dx, dg_part, db_part, dg,
                              db, N, F, R, st);
}

bool shape_ok(int N, int F) { return N > 0 && F > 0 && F <= kMaxF; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; xdtype for x, y, dy and dx,
// wdtype for g and b.  x / y / dy / dx [N, F] contiguous, g and b [F],
// mu / rstd [N] float32, dg / db [F] float32, dg_part / db_part
// [ceil(N / R), F] float32 scratch.  F <= kMaxF = 8192.  Each returns
// cudaGetLastError() after its launches.
extern "C" int ln_fwd(const void* x, const void* g, const void* b, void* y,
                      void* mu, void* rstd, int N, int F, float eps,
                      int xdtype, int wdtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, F)) return (int)cudaErrorInvalidValue;
  if (xdtype == 0 && wdtype == 0)
    return (int)fwd<float, float>(x, g, b, y, mu, rstd, N, F, eps, st);
  if (xdtype == 0 && wdtype == 1)
    return (int)fwd<float, __nv_bfloat16>(x, g, b, y, mu, rstd, N, F, eps, st);
  if (xdtype == 1 && wdtype == 0)
    return (int)fwd<__nv_bfloat16, float>(x, g, b, y, mu, rstd, N, F, eps, st);
  if (xdtype == 1 && wdtype == 1)
    return (int)fwd<__nv_bfloat16, __nv_bfloat16>(x, g, b, y, mu, rstd, N, F,
                                                  eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ln_bwd(const void* x, const void* g, const void* mu,
                      const void* rstd, const void* dy, void* dx,
                      void* dg_part, void* db_part, void* dg, void* db, int N,
                      int F, int R, int xdtype, int wdtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, F) || R <= 0) return (int)cudaErrorInvalidValue;
  if (xdtype == 0 && wdtype == 0)
    return (int)bwd<float, float>(x, g, mu, rstd, dy, dx, dg_part, db_part,
                                  dg, db, N, F, R, st);
  if (xdtype == 0 && wdtype == 1)
    return (int)bwd<float, __nv_bfloat16>(x, g, mu, rstd, dy, dx, dg_part,
                                          db_part, dg, db, N, F, R, st);
  if (xdtype == 1 && wdtype == 0)
    return (int)bwd<__nv_bfloat16, float>(x, g, mu, rstd, dy, dx, dg_part,
                                          db_part, dg, db, N, F, R, st);
  if (xdtype == 1 && wdtype == 1)
    return (int)bwd<__nv_bfloat16, __nv_bfloat16>(
        x, g, mu, rstd, dy, dx, dg_part, db_part, dg, db, N, F, R, st);
  return (int)cudaErrorInvalidValue;
}
