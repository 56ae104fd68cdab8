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
// operations per element, far under the card's rate.  So every element is
// read from device memory once and held in registers, with 16-byte loads
// (8 bf16 or 4 fp32 a thread, consecutive threads on consecutive
// addresses), and a scalar walk for rows whose length or base is not a
// multiple of 16 bytes.  F up to kMaxF = 8192 is taken (the JAX package's
// widest preset, gpt_13b, has F = 5120); a wider row is refused.
//
// The forward: persistent CTAs (at most two an SM, `fwd_at`) walk the
// rows with a grid stride.  A CTA stages g and b once, as fp32 in shared
// memory, while its first rows' loads fly.  A row belongs to a group of RW
// warps — one warp up to 1024 bf16 / 512 fp32 columns, 2, 4 or 8 warps
// past that (`fwd_shape`) — holding at most kFwdKV = 4 16-byte accesses a
// thread (8 only for an fp32 row past 4096), kept as raw words and
// converted at each of the row's three walks.  The row's two sums go
// through warp shuffles, and through shared memory in warp order (two
// barriers a row) when RW > 1.  The next row's loads are issued before
// this row is reduced and stored.  On an H100 at N = F = 2048 bf16, 4
// accesses a thread (2 warps a row) ran 13.0 µs against 13.9 with 8 (one
// warp, 178 registers) and 14.2 with 2; the sums in the 256-thread order
// below, which keep the bits of the forward before the row groups, cost
// about 0.4 µs more (PERF.md, PR 8).

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
constexpr int kMaxDevices = 64;   // cards per process the launcher tracks
constexpr int kFwdCtasPerSm = 2;  // the forward's persistent CTAs an SM
constexpr int kFwdKV = 4;         // the forward's 16-byte accesses a thread

// The column of element (k, i) — access k of KV, element i of an access —
// of thread t of the TPR threads that share a row.  Vector walk: access k
// covers NV consecutive columns; scalar walk: consecutive threads take
// consecutive columns.
template <int NV, bool VEC, int TPR = kThreads>
__device__ __forceinline__ int col_of(int t, int k, int i) {
  return VEC ? (t + k * TPR) * NV + i : (k * NV + i) * TPR + t;
}

template <int NV, bool VEC>
__device__ __forceinline__ int col(int k, int i) {
  return col_of<NV, VEC>(threadIdx.x, k, i);
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

// A row's elements of this thread (thread t of the TPR sharing the row) as
// loaded: raw 16-byte words on the vector walk (converted when used, so
// the loads stay in flight), fp32 on the scalar walk; 0 past F and for a
// row that is not live.
template <typename T, int KV, bool VEC, int TPR = kThreads>
struct RowIn {
  static constexpr int NV = Vec<T>::n, E = KV * NV;
  typename std::conditional<VEC, uint4, float>::type v[VEC ? KV : E];

  __device__ __forceinline__ void load(const T* __restrict__ r, int F,
                                       bool live, int t) {
#pragma unroll
    for (int k = 0; k < (VEC ? KV : E); ++k) {
      if constexpr (VEC) {
        const int j = col_of<NV, true, TPR>(t, k, 0);
        v[k] = live && j < F ? *reinterpret_cast<const uint4*>(r + j)
                             : make_uint4(0, 0, 0, 0);
      } else {
        const int j = col_of<NV, false, TPR>(t, k / NV, k % NV);
        v[k] = live && j < F ? to_f(r[j]) : 0.f;
      }
    }
  }

  // Element e (access e / NV, element e % NV) as fp32; e is a constant
  // once the callers' loops unroll.
  __device__ __forceinline__ float at(int e) const {
    if constexpr (VEC)
      return row_vec::unpack<T>(v[e / NV], e % NV);
    else
      return v[e];
  }

  __device__ __forceinline__ void get(float* o) const {
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = at(e);
  }

  // An empty asm that "changes" the raw words: what was converted from
  // them before it is not reused after it, so a caller that walks the
  // row several times holds 16-byte words, not KV·NV floats, between
  // the walks.
  __device__ __forceinline__ void refresh() {
#pragma unroll
    for (int k = 0; k < (VEC ? KV : E); ++k) {
      if constexpr (VEC)
        asm volatile("" : "+r"(v[k].x), "+r"(v[k].y), "+r"(v[k].z),
                     "+r"(v[k].w));
      else
        asm volatile("" : "+f"(v[k]));
    }
  }
};

// A row's sum in the order of a 256-thread CTA that holds the whole row
// (the order of the forward before the row groups, so its bits stay):
// virtual thread vt sums its elements in turn, each virtual warp sums its
// 32 threads by a shuffle butterfly, and the 8 warp sums are added in warp
// order.  A lane of real warp wr (of the RW of its row group) holds the
// virtual threads lane + 32·(wr + RW·a), a < 8 / RW, whose running sums
// are p[a].  RW > 1 passes one CTA barrier (all threads of the CTA call it
// together); `red` holds 8 floats a row group and must not be written
// again before the next barrier.
template <int RW>
__device__ __forceinline__ float cta_order_sum(float* p, float* red) {
  constexpr int A = kWarps / RW;
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      p[a] += __shfl_xor_sync(0xffffffffu, p[a], o);
  if constexpr (RW == 1) {
    float t = p[0];
#pragma unroll
    for (int a = 1; a < A; ++a) t += p[a];
    return t;
  } else {
    const int warp = threadIdx.x >> 5, wr = warp % RW;
    float* r = red + (warp / RW) * kWarps;
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int a = 0; a < A; ++a) r[wr + RW * a] = p[a];
    __syncthreads();
    float t = r[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += r[w];
    return t;
  }
}

// g and b as fp32 into gb[0, F) and gb[Fp, Fp + F), by the whole CTA —
// 16-byte loads where both are aligned, else one element a thread.
template <typename W>
__device__ __forceinline__ void stage_params(const W* __restrict__ g,
                                             const W* __restrict__ b,
                                             float* gb, int F, int Fp) {
  constexpr int NW = Vec<W>::n;
  if (F % NW == 0 && (((uintptr_t)g | (uintptr_t)b) & 15) == 0) {
    for (int c = threadIdx.x; c < F / NW; c += kThreads) {
      float t[NW];
      loadv(g + c * NW, t);
#pragma unroll
      for (int i = 0; i < NW; ++i) gb[c * NW + i] = t[i];
      loadv(b + c * NW, t);
#pragma unroll
      for (int i = 0; i < NW; ++i) gb[Fp + c * NW + i] = t[i];
    }
  } else {
    for (int j = threadIdx.x; j < F; j += kThreads) {
      gb[j] = to_f(g[j]);
      gb[Fp + j] = to_f(b[j]);
    }
  }
}

// Forward: CTA c normalises rows c·GR + grp, (c + gridDim.x)·GR + grp, ...
// (GR = kWarps / RW row groups a CTA, grp this thread's group).  Every
// thread runs every iteration (the loop bound is the CTA's), so a group
// whose row is past N computes on zeros and stores nothing.
template <typename T, typename W, int KV, int RW, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ g,
              const W* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mu, float* __restrict__ rstd, int N, int F,
              float eps) {
  constexpr int NV = Vec<T>::n, E = KV * NV, TPR = 32 * RW;
  constexpr int GR = kWarps / RW;
  extern __shared__ __align__(16) float gb[];   // g, then b at Fp
  __shared__ float red[2][kWarps * kWarps / RW];
  constexpr int A = kWarps / RW;   // virtual warps a lane's sums belong to
  const int grp = (threadIdx.x >> 5) / RW, t = threadIdx.x % TPR;
  const int Fp = (F + 3) & ~3;
  const int step = gridDim.x * GR;
  int row = blockIdx.x * GR + grp;
  RowIn<T, KV, VEC, TPR> cur, nxt;
  cur.load(x + (size_t)row * F, F, row < N, t);
  stage_params(g, b, gb, F, Fp);
  __syncthreads();
  for (int r0 = blockIdx.x * GR; r0 < N; r0 += step, row += step) {
    if (r0 + step < N)                      // the next row's loads fly
      nxt.load(x + (size_t)(row + step) * F, F, row + step < N, t);
    // element e of this lane belongs to virtual thread slot a: by access
    // (e / NV) on the vector walk, by element on the scalar walk
    float p[A] = {};
#pragma unroll
    for (int e = 0; e < E; ++e) p[(VEC ? e / NV : e) % A] += cur.at(e);
    const float m = cta_order_sum<RW>(p, red[0]) / (float)F;
    cur.refresh();
#pragma unroll
    for (int a = 0; a < A; ++a) p[a] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = col_of<NV, VEC, TPR>(t, e / NV, e % NV);
      const float c = j < F ? cur.at(e) - m : 0.f;
      p[(VEC ? e / NV : e) % A] += c * c;
    }
    const float r = rsqrtf(cta_order_sum<RW>(p, red[1]) / (float)F + eps);
    cur.refresh();
    if (row < N) {                 // each access normalised and stored
      T* yr = y + (size_t)row * F;
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        float o[NV];
        if constexpr (VEC) {         // g and b as 16-byte shared reads
          const int j = col_of<NV, true, TPR>(t, k, 0);
          if (j >= F) continue;
#pragma unroll
          for (int i = 0; i < NV; i += 4) {
            const float4 gg = *reinterpret_cast<const float4*>(gb + j + i);
            const float4 bb =
                *reinterpret_cast<const float4*>(gb + Fp + j + i);
            const float gw[4] = {gg.x, gg.y, gg.z, gg.w};
            const float bw[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
              o[i + u] = ((cur.at(k * NV + i + u) - m) * r) * gw[u] + bw[u];
          }
          storev(yr + j, o);
        } else {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int j = col_of<NV, false, TPR>(t, k, i);
            if (j < F)
              from_f(yr + j, ((cur.at(k * NV + i) - m) * r) * gb[j] +
                                 gb[Fp + j]);
          }
        }
      }
      if (t == 0) {
        mu[row] = m;
        rstd[row] = r;
      }
    }
    cur = nxt;
  }
}

// The backward's rows a thread keeps in flight: RB rows of x and dy, at
// most 4 and RB·KV·NV <= 32 values each (1 row from 32 values a thread).
template <typename T, int KV>
__host__ __device__ constexpr int group_rows() {
  constexpr int fit = 32 / (KV * Vec<T>::n);
  return fit > 4 ? 4 : fit > 0 ? fit : 1;
}

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
      xin[rb].load(x + (size_t)row * F, F, live, threadIdx.x);
      din[rb].load(dy + (size_t)row * F, F, live, threadIdx.x);
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

// The forward's row shape for F columns of T: RW warps a row — the fewest
// (up to kWarps) whose kFwdKV accesses a thread cover F — then KV
// accesses a thread, the fewest (up to 8) that cover F; KV = 0: too wide.
template <typename T>
void fwd_shape(int F, int* kv, int* rw) {
  const int per = 32 * Vec<T>::n;    // columns one access of a warp covers
  *rw = 1;
  while (*rw < kWarps && F > *rw * kFwdKV * per) *rw *= 2;
  *kv = 1;
  while (*kv < 8 && F > *kv * *rw * per) *kv *= 2;
  if (F > *kv * *rw * per) *kv = 0;
}

// Persistent grid of the forward: one CTA per GR rows, but no more than
// kFwdCtasPerSm (or as many as fit, if fewer) on each SM.  The SM count
// and the fit are asked once per card (and again when the shared memory
// of g and b grows).
template <typename T, typename W, int KV, int RW, bool VEC>
cudaError_t fwd_at(const void* x, const void* g, const void* b, void* y,
                   void* mu, void* rstd, int N, int F, float eps,
                   cudaStream_t st) {
  constexpr int GR = kWarps / RW;
  const auto kern = ln_fwd_kernel<T, W, KV, RW, VEC>;
  const size_t smem = 2 * (size_t)((F + 3) & ~3) * sizeof(float);
  static int fit[kMaxDevices], sms[kMaxDevices];
  static size_t fit_smem[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0 || smem > fit_smem[dev]) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
    }
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev], kern,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    fit_smem[dev] = smem;
  }
  const int per_sm = fit[dev] < kFwdCtasPerSm ? fit[dev] : kFwdCtasPerSm;
  const int want = (N + GR - 1) / GR, cap = per_sm * sms[dev];
  const int grid = want < cap ? want : cap > 0 ? cap : 1;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(g),
      static_cast<const W*>(b), static_cast<T*>(y), static_cast<float*>(mu),
      static_cast<float*>(rstd), N, F, eps);
  return cudaGetLastError();
}

template <typename T, typename W, bool VEC>
cudaError_t fwd_vec(const void* x, const void* g, const void* b, void* y,
                    void* mu, void* rstd, int N, int F, float eps,
                    cudaStream_t st) {
#define LN_FWD(KV, RW) \
  fwd_at<T, W, KV, RW, VEC>(x, g, b, y, mu, rstd, N, F, eps, st)
  int kv, rw;
  fwd_shape<T>(F, &kv, &rw);
  // below kWarps warps a row, more than one warp takes kFwdKV accesses
  if (rw == 1 && kv == 1) return LN_FWD(1, 1);
  if (rw == 1 && kv == 2) return LN_FWD(2, 1);
  if (rw == 1 && kv == 4) return LN_FWD(4, 1);
  if (rw == 1 && kv == 8) return LN_FWD(8, 1);
  if (rw == 2 && kv == kFwdKV) return LN_FWD(kFwdKV, 2);
  if (rw == 4 && kv == kFwdKV) return LN_FWD(kFwdKV, 4);
  if (rw == 8 && kv == 4) return LN_FWD(4, 8);
  if (rw == 8 && kv == 8) return LN_FWD(8, 8);
#undef LN_FWD
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
