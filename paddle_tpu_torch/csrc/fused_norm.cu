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
// operations per element, far under the card's rate.  So a CTA holds
// whole rows in registers — every element is read from device memory once —
// with 16-byte loads (8 bf16 or 4 fp32 a thread, consecutive threads on
// consecutive addresses), and a scalar walk for rows whose length or base
// is not a multiple of 16 bytes.  A thread holds KV of those accesses, KV in
// {1, 2, 4, 8} picked by F, so F up to kMaxF = 8192 is taken (the JAX
// package's widest preset, gpt_13b, has F = 5120); a wider row is refused.
//
// The TPU sums dg and db across its sequential grid in one VMEM block.  CTAs
// run in no order here, so the backward is two kernels, both in a fixed
// order (no float atomics: the result is the same on every run):
//  * the row pass: at most one CTA per SM (the caller picks R consecutive
//    rows a CTA, ops/fused_norm.py `bwd_plan`), so at most one fp32 partial
//    row of dg and of db per SM — 128 × 2048 × 8 bytes = 2.1 MB at the
//    train shape, written and read back through L2 (it was 256 rows, 4.2
//    MB).  A CTA walks its rows in groups of RB (4 at F = 2048, bf16): the
//    next group's x and dy loads (32 KB a CTA) fly while this group is
//    reduced; the 2·RB row sums c1, c2 go through warp shuffles and one
//    barrier a group, not two a row.  dy·xhat and dy accumulate per column
//    in registers.
//  * the column pass: 32 columns a CTA (64 CTAs a sum at F = 2048), each
//    warp adding every 8th partial row, the 8 warp sums added in order.
// Registers (the row pass, 256 threads): RB·KV·NV = 32 values of x and dy
// each, the next group's raw 16-byte words (rows of up to 16 values a
// thread), and g, dg, db at the thread's KV·NV columns: 210 at F = 2048
// bf16 (ptxas), no spill.  A warp holding a whole 2048-wide row and its dg/db sums would need
// 64 values of each of four arrays a lane, over 255 registers, so a row
// stays spread over the CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The backward's rows a thread keeps in flight: RB rows of x and dy, at
// most 4 and RB·KV·NV <= 32 values each (1 row from 32 values a thread).
template <typename T, int KV>
__host__ __device__ constexpr int group_rows() {
  constexpr int fit = 32 / (KV * Vec<T>::n);
  return fit > 4 ? 4 : fit > 0 ? fit : 1;
}

// A row's elements of this thread as loaded: raw 16-byte words on the
// vector walk (converted when used, so the loads stay in flight), fp32 on
// the scalar walk.
template <typename T, int KV, bool VEC>
struct RowIn {
  static constexpr int NV = Vec<T>::n, E = KV * NV;
  typename std::conditional<VEC, uint4, float>::type v[VEC ? KV : E];

  __device__ __forceinline__ void load(const T* __restrict__ r, int F,
                                       bool live) {
#pragma unroll
    for (int k = 0; k < (VEC ? KV : E); ++k) {
      if constexpr (VEC) {
        const int j = col<NV, true>(k, 0);
        v[k] = live && j < F ? *reinterpret_cast<const uint4*>(r + j)
                             : make_uint4(0, 0, 0, 0);
      } else {
        const int j = col<NV, false>(k / NV, k % NV);
        v[k] = live && j < F ? to_f(r[j]) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void get(float* o) const {
#pragma unroll
    for (int k = 0; k < (VEC ? KV : E); ++k) {
      if constexpr (!VEC) {
        o[k] = v[k];
      } else if constexpr (std::is_same<T, float>::value) {
        o[4 * k] = __uint_as_float(v[k].x);
        o[4 * k + 1] = __uint_as_float(v[k].y);
        o[4 * k + 2] = __uint_as_float(v[k].z);
        o[4 * k + 3] = __uint_as_float(v[k].w);
      } else {
        const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // bf16 pair: low half first
          o[8 * k + 2 * e] = __uint_as_float(w[e] << 16);
          o[8 * k + 2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
        }
      }
    }
  }
};

// Row pass: CTA b normalises rows [b·R, min((b + 1)·R, N)) in groups of RB
// rows (dx), summing dy·xhat and dy per column in registers, and writes one
// fp32 partial row of each.  The next group's loads fly through this
// group's math (rows of up to 16 values a thread); the RB rows' c1/c2 sums
// go through warp shuffles and one barrier a group (double-buffered
// shared memory, so no second barrier).
template <typename T, typename W, int KV, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
ln_bwd_rows_kernel(const T* __restrict__ x, const W* __restrict__ g,
                   const float* __restrict__ mu,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ dg_part,
                   float* __restrict__ db_part, int N, int F, int R) {
  constexpr int NV = Vec<T>::n, E = KV * NV, RB = group_rows<T, KV>();
  constexpr bool PF = E <= 16;           // prefetch the next group
  __shared__ __align__(16) float red[2][kWarps][2 * RB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float gv[E], dga[E], dba[E];
  load_param<W, NV, KV, VEC>(g, F, gv);
#pragma unroll
  for (int e = 0; e < E; ++e) dga[e] = dba[e] = 0.f;
  const int r0 = blockIdx.x * R, r1 = min(r0 + R, N);

  RowIn<T, KV, VEC> xin[RB], din[RB];
  float min_[RB], rin[RB];
  auto fetch = [&](int row0) {
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int row = row0 + rb;
      const bool live = row < r1;
      xin[rb].load(x + (size_t)row * F, F, live);
      din[rb].load(dy + (size_t)row * F, F, live);
      min_[rb] = live ? mu[row] : 0.f;
      rin[rb] = live ? rstd[row] : 0.f;
    }
  };
  if (PF) fetch(r0);
  int buf = 0;
  for (int row0 = r0; row0 < r1; row0 += RB) {
    if (!PF) fetch(row0);
    float xh[RB][E], d[RB][E], r[RB], s[2 * RB];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      xin[rb].get(xh[rb]);
      din[rb].get(d[rb]);
      const float m = min_[rb];
      r[rb] = rin[rb];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xh[rb][e] = (xh[rb][e] - m) * r[rb];
        const float w = d[rb][e] * gv[e];   // 0 past F and past r1: d is
        s1 += w;
        s2 += w * xh[rb][e];
      }
      s[2 * rb] = s1;
      s[2 * rb + 1] = s2;
    }
    if (PF && row0 + RB < r1) fetch(row0 + RB);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < 2 * RB; ++k)
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 2 * RB; ++k) red[buf][warp][k] = s[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2 * RB; ++k) {   // warp order: the same every run
      float t = red[buf][0][k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += red[buf][w][k];
      s[k] = t;
    }
    buf ^= 1;
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      if (row0 + rb >= r1) break;
      const float c1 = s[2 * rb] / (float)F, c2 = s[2 * rb + 1] / (float)F;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dga[e] += d[rb][e] * xh[rb][e];
        dba[e] += d[rb][e];
        d[rb][e] = (d[rb][e] * gv[e] - c1 - xh[rb][e] * c2) * r[rb];
      }
      store_row<T, KV, VEC>(dx + (size_t)(row0 + rb) * F, F, d[rb]);
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

// Column pass: dg[j] = Σ_blocks dg_part[blk, j] (blockIdx.y = 0) and db
// (1).  A CTA takes 32 columns; its 8 warps sum every 8th partial row each,
// then warp 0 adds the 8 sums in warp order — a fixed order, no atomics.
__global__ void __launch_bounds__(kThreads)
ln_bwd_cols_kernel(const float* __restrict__ dg_part,
                   const float* __restrict__ db_part, float* __restrict__ dg,
                   float* __restrict__ db, int nb, int F) {
  __shared__ float sums[kWarps][32];
  const float* part = blockIdx.y ? db_part : dg_part;
  const int c = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + c;
  float t = 0.f;
  if (j < F) {
#pragma unroll 16          // every partial row's load in flight at once
    for (int blk = w; blk < nb; blk += kWarps) t += part[(size_t)blk * F + j];
  }
  sums[w][c] = t;
  __syncthreads();
  if (w == 0 && j < F) {
#pragma unroll
    for (int v = 1; v < kWarps; ++v) t += sums[v][c];
    (blockIdx.y ? db : dg)[j] = t;
  }
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

// The backward's operands: x / dy / dx [N, F], g [F], mu / rstd [N],
// dg_part / db_part [nb, F] fp32 scratch (nb = ceil(N / R)), dg / db [F].
struct BwdArgs {
  const void *x, *g, *mu, *rstd, *dy;
  void *dx, *dg_part, *db_part, *dg, *db;
  int N, F, R;
};

template <typename T, typename W, int KV, bool VEC>
cudaError_t bwd_at(const BwdArgs& a, cudaStream_t st) {
  const int nb = (a.N + a.R - 1) / a.R;
  ln_bwd_rows_kernel<T, W, KV, VEC><<<nb, kThreads, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const W*>(a.g),
      static_cast<const float*>(a.mu), static_cast<const float*>(a.rstd),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx),
      static_cast<float*>(a.dg_part), static_cast<float*>(a.db_part), a.N,
      a.F, a.R);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_cols_kernel<<<dim3((a.F + 31) / 32, 2), kThreads, 0, st>>>(
      static_cast<const float*>(a.dg_part),
      static_cast<const float*>(a.db_part), static_cast<float*>(a.dg),
      static_cast<float*>(a.db), nb, a.F);
  return cudaGetLastError();
}

template <typename T, typename W, bool VEC>
cudaError_t bwd_vec(const BwdArgs& a, cudaStream_t st) {
  switch (accesses<T>(a.F)) {
    case 1: return bwd_at<T, W, 1, VEC>(a, st);
    case 2: return bwd_at<T, W, 2, VEC>(a, st);
    case 4: return bwd_at<T, W, 4, VEC>(a, st);
    case 8:
      if constexpr (4 * kThreads * Vec<T>::n < kMaxF)
        return bwd_at<T, W, 8, VEC>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
cudaError_t bwd(const BwdArgs& a, cudaStream_t st) {
  if (row_vec::aligned<T>(a.F, a.x, a.dy, a.dx))
    return bwd_vec<T, W, true>(a, st);
  return bwd_vec<T, W, false>(a, st);
}

bool shape_ok(int N, int F) { return N > 0 && F > 0 && F <= kMaxF; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; xdtype for x, y, dy and dx,
// wdtype for g and b.  x / y / dy / dx [N, F] contiguous, g and b [F],
// mu / rstd [N] float32, dg / db [F] float32, dg_part / db_part
// [ceil(N / R), F] float32 scratch.  F <= kMaxF = 8192.  ln_bwd launches
// the row pass, then the column pass.  Each returns cudaGetLastError()
// after its launches.
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
  const BwdArgs a{x, g, mu, rstd, dy, dx, dg_part, db_part, dg, db,
                  N, F, R};
  if (xdtype == 0 && wdtype == 0) return (int)bwd<float, float>(a, st);
  if (xdtype == 0 && wdtype == 1)
    return (int)bwd<float, __nv_bfloat16>(a, st);
  if (xdtype == 1 && wdtype == 0)
    return (int)bwd<__nv_bfloat16, float>(a, st);
  if (xdtype == 1 && wdtype == 1)
    return (int)bwd<__nv_bfloat16, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
