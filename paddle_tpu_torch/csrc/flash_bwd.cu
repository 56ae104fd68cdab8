// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// Replaces: paddle_tpu/ops/flash_attention.py::_flash_bwd_impl — its two
// Pallas kernels, dq_kernel (pallas_call at flash_attention.py:249) and
// dkv_kernel (pallas_call at :302).  Both recompute the normalised
// probabilities p = exp(scale·q·k − lse) from q, k and the forward's
// per-row logsumexp, so the [T, S] matrix never reaches device memory:
//   dp = do·vᵀ,  ds = p ∘ (dp − δ),  δ_i = Σ_d do_id·o_id,
//   dq = scale·ds·k,  dk = scale·dsᵀ·q,  dv = pᵀ·do.
// A masked score is −1e30 in the Pallas bodies, so its p is exactly 0.
// The JAX package computes δ in XLA between its two kernels; here the dq
// kernel computes it from the o and do rows and writes it for the dk/dv
// kernel, which runs after it on the same stream.
//
// Two bodies, chosen statically by dtype and head dim
// (``flash_attention.route_bwd`` in the wrapper takes the same decision):
//  * bf16 at D = 64 or 128: the tensor-core bodies below, on the wgmma
//    primitives, swizzled tiles and cp.async ring of attn_tc.cuh.
//  * fp32 at any D, and bf16 at D = 256: the fp32-FMA body further below.
//    At D = 256 the dk/dv accumulators alone (dk and dv, D/2 each a
//    thread) would take all 255 registers of a one-warpgroup CTA.
//
// What bounds it on an H100: operations.  At the train path's shape
// (B = 1, T = 2048, H = 16, D = 128, causal; causal pairs only) dq does
// three products of 2·D flops a pair (S, dP, dS·K), 25.8 GFLOP, dk/dv four
// (S, dP, Pᵀ·dO, dSᵀ·Q), 34.4 GFLOP; each moves some 51 MB (six bf16
// [T, H, D] arrays, lse and δ): 0.0261 / 0.0348 ms at 989 TFLOP/s bf16
// against 0.0151 ms at 3.35 TB/s.  The FMA body ran these products on the CUDA cores
// (67 TFLOP/s at best); the tensor-core bodies run them as wgmma.
//
// Design of the tensor-core bodies (one warpgroup, 128 threads, a CTA):
//  * dq: a CTA owns 64 query rows (the grid walks q tiles from the last,
//    so the heaviest causal tiles start first).  Q and dO stay in shared
//    memory; 64-key K and V tiles go through attn_tc's 2-stage cp.async
//    ring.  Per tile, S = Q·Kᵀ and dP = dO·Vᵀ are wgmma chains with both
//    operands K-major in shared memory (the head dim is contiguous in every
//    row), issued as one group; p = ex2(S·scale·log2 e − lse·log2 e) and
//    dS = p∘(dP − δ) are taken in the accumulator layout, which is the A
//    operand's register layout, so dS goes to dQ += dS·K as registers, with
//    K read MN-major through the transpose bit from the same tile that S
//    read K-major.  δ and lse of the thread's two rows stay in registers.
//  * dk/dv: a CTA owns 64 keys; K and V stay in shared memory and 64-row
//    Q and dO tiles go through the ring with their 64 lse and δ values.
//    It computes the transposes, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ
//    come out in the A operand's layout (rows are keys) and no operand is
//    read MN-major as A: dV += Pᵀ·dO and dK += dSᵀ·Q read dO and Q MN-major
//    from the tiles the K-major products read.  A thread's columns are
//    query rows: it reads their lse and δ from shared memory.  A row past
//    the end of q gets lse = 1e30, so its p is 0.
//  * GQA: the dk/dv CTA walks the query rows of every head of its kv head's
//    group (h = hk·G + g) in one ring, so the group's sum happens in fp32
//    in registers: no repeated k/v, no atomics, one write per key.  The dq
//    CTA reads kv head h / G directly.
//  * Causal: dq walks key tiles up to its last row, dk/dv query tiles from
//    its first key (the first key tiles, the heaviest, are launched first);
//    only the diagonal tile is masked.  Rows and keys past the end are
//    zero-filled by cp.async and masked, so any T and S work.
//  * Rounding: p and dS are rounded to bf16 for their products, as the
//    forward rounds p for P·V: wgmma takes bf16 operands, and the products
//    accumulate in fp32.  What decides p and dS stays fp32 — the exponent
//    (score − lse), dP − δ and δ itself — because there a rounding would
//    move every element of a row the same way: δ is a sum of D products and
//    dP − δ cancels, so a bf16 δ would shift all dS of a row by up to
//    2^-9·|δ|, where an element's own rounding is 2^-9 of that element
//    and does not add up along the row.
//
// Shared memory: 1 KB alignment slack + 2 resident tiles + 2 stages of two
// 64-row tiles (128·D bytes each) [+ 2 stages of 64 lse and δ]: 97 KB (dq)
// and 98 KB (dk/dv) at D = 128, two CTAs an SM; 49 / 50 KB at D = 64.
// Registers at D = 128: dq holds dQ (64 a thread), S and dP (32 each);
// dk/dv dK and dV (64 each), Sᵀ and dPᵀ (32 each).
//
// Design of the FMA body:
//  * dq: one CTA per (b·h, 32-row q tile), 8 warps of 4 query rows, like
//    the forward's fp32 body (csrc/flash_fwd.cu).  The TPU kernel carries
//    the dq sum across sequential grid steps in VMEM scratch; here the
//    k-tile walk is a loop inside the CTA and dq lives in registers (fp32)
//    until it is written once.  A lane scores keys lane and lane+32 of each
//    staged 64-key tile (q·k and do·v from padded shared-memory rows), and
//    the ds·k product broadcasts ds with a warp shuffle.
//  * dk/dv: one CTA per (b·kv head, 32-key tile), 8 warps of 4 keys; the
//    walk stages 64 query rows at a time (q, do, lse, δ) and a lane takes
//    rows lane and lane+32.  dk and dv live in registers until written.
//    GQA and causal tiles as in the tensor-core bodies.
//  * D is 64, 128 or 256; at D = 256 the staged tiles take 193 KB of
//    shared memory (one CTA per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_tc.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                // rows (dq) or keys (dk/dv) per warp
constexpr int kBQ = kWarps * kRows;     // dq: query rows per CTA
constexpr int kBK = 64;                 // dq: keys per staged tile
constexpr int kBKc = kWarps * kRows;    // dk/dv: keys per CTA
constexpr int kBQc = 64;                // dk/dv: query rows per staged tile
constexpr int kMaxDevices = 64;         // cards per process the launcher tracks
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + n) of x [B, T, Hx, D] at head hx, as fp32 into
// dst[n][ld] (ld = D or D + 1); rows past T are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ x, float* dst,
                                      int ld, int b, int r0, int n, int Tx,
                                      int Hx, int hx) {
  for (int idx = threadIdx.x * 4; idx < n * D; idx += kThreads * 4) {
    const int j = idx / D, d = idx % D, t = r0 + j;
    float e4[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < Tx) load4(x + ((size_t)(b * Tx + t) * Hx + hx) * D + d, e4);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[j * ld + d + e] = e4[e];
  }
}

// dq and δ.  grid (ceil(Tq / kBQ), B·H).  dq is written as OT (T, or
// float for a caller that sums partial gradients).
template <typename T, int D, typename OT = T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, OT* __restrict__ dq, int Tq,
                    int S, int H, int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D]
  float* Ds = Qs + kBQ * D;               // [kBQ][D]   do
  float* Ks = Ds + kBQ * D;               // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);         // [kBK][D + 1]
  constexpr int NV = D / 32;              // output dims per lane

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;

  stage<T, D>(q, Qs, D, b, q0, kBQ, Tq, H, h);
  stage<T, D>(dout, Ds, D, b, q0, kBQ, Tq, H, h);
  __syncthreads();

  // δ_i = Σ_d do_id · o_id and lse_i for this warp's rows
  float dl[kRows], ls[kRows], acc[kRows][NV];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp * kRows + rr, i = q0 + r;
    float part = 0.f;
    if (i < Tq) {
      const T* orow = o + ((size_t)(b * Tq + i) * H + h) * D;
#pragma unroll
      for (int e = 0; e < NV; ++e)
        part = fmaf(Ds[r * D + lane + 32 * e], load1(orow + lane + 32 * e), part);
    }
    dl[rr] = warp_sum(part);
    ls[rr] = i < Tq ? lse[(size_t)bh * Tq + i] : 0.f;
    if (lane == 0 && i < Tq) delta[(size_t)bh * Tq + i] = dl[rr];
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[rr][e] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed
    stage<T, D>(k, Ks, D + 1, b, k0, kBK, S, Hkv, hk);
    stage<T, D>(v, Vs, D + 1, b, k0, kBK, S, Hkv, hk);
    __syncthreads();

    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      s[rr][0] = s[rr][1] = dp[rr][0] = dp[rr][1] = 0.f;
    const float* ka = Ks + lane * (D + 1);
    const float* kb = Ks + (lane + 32) * (D + 1);
    const float* va = Vs + lane * (D + 1);
    const float* vb = Vs + (lane + 32) * (D + 1);
    const float* qw = Qs + warp * kRows * D;
    const float* dw = Ds + warp * kRows * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0v = ka[d], k1v = kb[d], v0v = va[d], v1v = vb[d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float qv = qw[rr * D + d], dv = dw[rr * D + d];
        s[rr][0] = fmaf(qv, k0v, s[rr][0]);
        s[rr][1] = fmaf(qv, k1v, s[rr][1]);
        dp[rr][0] = fmaf(dv, v0v, dp[rr][0]);
        dp[rr][1] = fmaf(dv, v1v, dp[rr][1]);
      }
    }

    float dsa[kRows], dsb[kRows];
    const int ja = k0 + lane, jb = k0 + lane + 32;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int i = q0 + warp * kRows + rr;
      float sa = scale * s[rr][0], sb = scale * s[rr][1];
      if (causal) {
        if (ja > i) sa = kNeg;
        if (jb > i) sb = kNeg;
      }
      const float pa = ja < S ? expf(sa - ls[rr]) : 0.f;
      const float pb = jb < S ? expf(sb - ls[rr]) : 0.f;
      dsa[rr] = pa * (dp[rr][0] - dl[rr]);
      dsb[rr] = pb * (dp[rr][1] - dl[rr]);
    }

#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float kv[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) kv[e] = Ks[jj * (D + 1) + lane + 32 * e];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float dsj =
            __shfl_sync(0xffffffffu, jj < 32 ? dsa[rr] : dsb[rr], jj & 31);
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[rr][e] = fmaf(dsj, kv[e], acc[rr][e]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int i = q0 + warp * kRows + rr;
    if (i >= Tq) continue;
    OT* row = dq + ((size_t)(b * Tq + i) * H + h) * D;
#pragma unroll
    for (int e = 0; e < NV; ++e) store1(row + lane + 32 * e, scale * acc[rr][e]);
  }
}

// dk and dv.  grid (ceil(S / kBKc), B·Hkv).  Written as OT.
template <typename T, int D, typename OT = T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, OT* __restrict__ dk,
                     OT* __restrict__ dv, int Tq, int S, int H, int Hkv,
                     float scale, int causal) {
  extern __shared__ float smem[];
  float* Kc = smem;                       // [kBKc][D]  this CTA's keys
  float* Vc = Kc + kBKc * D;              // [kBKc][D]
  float* Qs = Vc + kBKc * D;              // [kBQc][D + 1]
  float* Ds = Qs + kBQc * (D + 1);        // [kBQc][D + 1]   do
  float* Ls = Ds + kBQc * (D + 1);        // [kBQc]  lse
  float* Dl = Ls + kBQc;                  // [kBQc]  δ
  constexpr int NV = D / 32;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.x * kBKc;

  stage<T, D>(k, Kc, D, b, k0, kBKc, S, Hkv, hk);
  stage<T, D>(v, Vc, D, b, k0, kBKc, S, Hkv, hk);

  float dka[kRows][NV], dva[kRows][NV];
#pragma unroll
  for (int kk = 0; kk < kRows; ++kk)
#pragma unroll
    for (int e = 0; e < NV; ++e) dka[kk][e] = dva[kk][e] = 0.f;

  // the first q tile holding a row that can see key k0
  const int qt_begin = causal ? (k0 / kBQc) * kBQc : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t bh = (size_t)b * H + h;
    for (int qt0 = qt_begin; qt0 < Tq; qt0 += kBQc) {
      __syncthreads();   // the previous tile is consumed (and Kc/Vc written)
      stage<T, D>(q, Qs, D + 1, b, qt0, kBQc, Tq, H, h);
      stage<T, D>(dout, Ds, D + 1, b, qt0, kBQc, Tq, H, h);
      for (int r = threadIdx.x; r < kBQc; r += kThreads) {
        const int i = qt0 + r;
        Ls[r] = i < Tq ? lse[bh * Tq + i] : 0.f;
        Dl[r] = i < Tq ? delta[bh * Tq + i] : 0.f;
      }
      __syncthreads();

      float s[kRows][2], dp[kRows][2];
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk)
        s[kk][0] = s[kk][1] = dp[kk][0] = dp[kk][1] = 0.f;
      const float* qa = Qs + lane * (D + 1);
      const float* qb = Qs + (lane + 32) * (D + 1);
      const float* da = Ds + lane * (D + 1);
      const float* db = Ds + (lane + 32) * (D + 1);
      const float* kw = Kc + warp * kRows * D;
      const float* vw = Vc + warp * kRows * D;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float q0v = qa[d], q1v = qb[d], d0v = da[d], d1v = db[d];
#pragma unroll
        for (int kk = 0; kk < kRows; ++kk) {
          const float kv = kw[kk * D + d], vv = vw[kk * D + d];
          s[kk][0] = fmaf(kv, q0v, s[kk][0]);
          s[kk][1] = fmaf(kv, q1v, s[kk][1]);
          dp[kk][0] = fmaf(vv, d0v, dp[kk][0]);
          dp[kk][1] = fmaf(vv, d1v, dp[kk][1]);
        }
      }

      float pa[kRows], pb[kRows], dsa[kRows], dsb[kRows];
      const int ia = qt0 + lane, ib = qt0 + lane + 32;
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        const int j = k0 + warp * kRows + kk;
        float sa = scale * s[kk][0], sb = scale * s[kk][1];
        if (causal) {
          if (j > ia) sa = kNeg;
          if (j > ib) sb = kNeg;
        }
        pa[kk] = (ia < Tq && j < S) ? expf(sa - Ls[lane]) : 0.f;
        pb[kk] = (ib < Tq && j < S) ? expf(sb - Ls[lane + 32]) : 0.f;
        dsa[kk] = pa[kk] * (dp[kk][0] - Dl[lane]);
        dsb[kk] = pb[kk] * (dp[kk][1] - Dl[lane + 32]);
      }

#pragma unroll 2
      for (int rr = 0; rr < kBQc; ++rr) {
        float qv[NV], dov[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          qv[e] = Qs[rr * (D + 1) + lane + 32 * e];
          dov[e] = Ds[rr * (D + 1) + lane + 32 * e];
        }
#pragma unroll
        for (int kk = 0; kk < kRows; ++kk) {
          const float pr =
              __shfl_sync(0xffffffffu, rr < 32 ? pa[kk] : pb[kk], rr & 31);
          const float dsr =
              __shfl_sync(0xffffffffu, rr < 32 ? dsa[kk] : dsb[kk], rr & 31);
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            dva[kk][e] = fmaf(pr, dov[e], dva[kk][e]);
            dka[kk][e] = fmaf(dsr, qv[e], dka[kk][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kRows; ++kk) {
    const int j = k0 + warp * kRows + kk;
    if (j >= S) continue;
    const size_t off = ((size_t)(b * S + j) * Hkv + hk) * D;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      store1(dk + off + lane + 32 * e, scale * dka[kk][e]);
      store1(dv + off + lane + 32 * e, dva[kk][e]);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once per card (the limit
// belongs to the current device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* attr_bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  return cudaSuccess;
}

template <typename T, int D, typename OT = T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int Tq, int S, int H,
                      int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBQ * D + 2 * kBK * (D + 1));
  static size_t attr_bytes[kMaxDevices] = {};
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D, OT>, smem,
                             attr_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<T, D, OT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<OT*>(dq), Tq, S, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D, typename OT = T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Tq, int S, int H,
                       int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBKc * D + 2 * kBQc * (D + 1) + 2 * kBQc);
  static size_t attr_bytes[kMaxDevices] = {};
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D, OT>, smem,
                             attr_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBKc - 1) / kBKc, B * Hkv);
  flash_bwd_dkv_kernel<T, D, OT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<OT*>(dk), static_cast<OT*>(dv), Tq, S, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

// ---- bf16 at D = 64 / 128: the tensor-core bodies (attn_tc.cuh) ----

namespace tc {

using namespace attn_tc;
using attn_tc::kThreads;   // not the FMA body's of the same name

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return kBM * D * 2; }

template <int D>
constexpr size_t dq_smem() { return 1024 + 6 * (size_t)tile_bytes<D>(); }

template <int D>
constexpr size_t dkv_smem() {
  return dq_smem<D>() + (size_t)kStages * 2 * kBM * sizeof(float);
}

// Rows [r0, r0 + 64) of x [B, Tx, Hx, D] at (b, hx) into a swizzled tile by
// cp.async; rows past Tx are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ x,
                                          uint32_t dst, int b, int r0, int Tx,
                                          int Hx, int hx) {
  constexpr int C = D / 8;                     // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < kBM * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, t = r0 + r;
    const bool ok = t < Tx;
    cp16(dst + swz(r, c, kBM),
         x + ((size_t)(b * Tx + (ok ? t : 0)) * Hx + hx) * D + c * 8, ok);
  }
}

// Keeps A registers alive (unmoved) until the products that read them end.
__device__ __forceinline__ void hold_a(uint32_t (&a)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc[nb]);
}

// Write rows r0 + i0 (+ 8) of a [B, Tx, Hx, D] array at (b, hx) from the
// accumulators, times mul, as bf16; rows at or past Tx are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ x,
                                           const float (&acc)[D / 64][32],
                                           float mul, int b, int r0, int Tx,
                                           int Hx, int hx) {
  const int i0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int t = r0 + i0 + 8 * acc_half(e);
      if (t >= Tx) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          x + ((size_t)(b * Tx + t) * Hx + hx) * D + acc_col(nb, e)) =
          __floats2bfloat162_rn(acc[nb][e] * mul, acc[nb][e + 1] * mul);
    }
}

// The same rows as float32 (a caller summing partial gradients).
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ x,
                                           const float (&acc)[D / 64][32],
                                           float mul, int b, int r0, int Tx,
                                           int Hx, int hx) {
  const int i0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int t = r0 + i0 + 8 * acc_half(e);
      if (t >= Tx) continue;
      *reinterpret_cast<float2*>(
          x + ((size_t)(b * Tx + t) * Hx + hx) * D + acc_col(nb, e)) =
          make_float2(acc[nb][e] * mul, acc[nb][e + 1] * mul);
    }
}

// Σ_d a_d·b_d over the 16-byte chunks c4, c4 + 4, ... of two bf16 rows.
template <int D>
__device__ __forceinline__ float part_dot(const __nv_bfloat16* a,
                                          const __nv_bfloat16* b, int c4) {
  float acc = 0.f;
#pragma unroll
  for (int c = c4; c < D / 8; c += 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(b + c * 8);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(xp[e]), fy = __bfloat1622float2(yp[e]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
  return acc;
}

// dq and δ.  grid (B·H, ceil(Tq / 64)), q tiles from the last.  dq is
// written as OT (bf16, or float for a caller summing partial gradients).
template <int D, typename OT = __nv_bfloat16>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, OT* __restrict__ dq, int Tq,
          int S, int H, int Hkv, float scale, int causal) {
  constexpr uint32_t kTile = tile_bytes<D>();
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = warp * 16 + (lane >> 2), c4 = lane & 3;

  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(attn_tc_smem);
  const uint32_t qs = (raw + 1023u) & ~1023u;
  const uint32_t dos = qs + kTile;
  const uint32_t ring = dos + kTile;             // [stage][K, V]

  load_tile<D>(q, qs, b, q0, Tq, H, h);
  load_tile<D>(dout, dos, b, q0, Tq, H, h);
  const int k_end = causal ? min(S, q0 + kBM) : S;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  load_tile<D>(k, ring, b, 0, S, Hkv, hk);
  load_tile<D>(v, ring + kTile, b, 0, S, Hkv, hk);
  cp_commit();

  // δ and lse (log2 units) of the thread's rows i0 and i0 + 8; the causal
  // frontier (last visible key) of each row and of the tile's first row
  float dl[2], ls[2];
  int f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + i0 + 8 * r;
    float part = 0.f;
    if (t < Tq) {
      const size_t row = ((size_t)(b * Tq + t) * H + h) * D;
      part = part_dot<D>(o + row, dout + row, c4);
    }
    dl[r] = quad_sum(part);
    ls[r] = t < Tq ? lse[(size_t)bh * Tq + t] * kLog2e : 0.f;
    if (c4 == 0 && t < Tq) delta[(size_t)bh * Tq + t] = dl[r];
    f[r] = causal ? min(t, S - 1) : S - 1;
  }
  const int front_first = causal ? min(q0, S - 1) : S - 1;
  const float sl2 = scale * kLog2e;

  float acc[D / 64][32], s[32], dp[32];
  zero<D>(acc);
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it & 1, k0 = it * kBN;
    if (it + 1 < n_tiles) {
      const uint32_t nxt = ring + (slot ^ 1) * 2 * kTile;
      load_tile<D>(k, nxt, b, k0 + kBN, S, Hkv, hk);
      load_tile<D>(v, nxt + kTile, b, k0 + kBN, S, Hkv, hk);
    }
    cp_commit();
    cp_wait<1>();           // this tile (and Q, dO) landed; the next one flies
    fence_async_smem();
    __syncthreads();
    const uint32_t kt = ring + slot * 2 * kTile, vt = kt + kTile;

    // S = Q·Kᵀ and dP = dO·Vᵀ, one group
    wg_fence();
    mma_abt<D>(s, qs, kt);
    mma_abt<D>(dp, dos, vt);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    // p and dS = p (dP − δ), in place in s
    const bool full = k0 + kBN - 1 <= front_first;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hr = acc_half(e), col = k0 + acc_col(0, e);
      float p = ex2(s[e] * sl2 - ls[hr]);
      if (!full && col > f[hr]) p = 0.f;
      s[e] = p * (dp[e] - dl[hr]);
    }

    // dQ += dS·K: dS from registers, K read MN-major
    fence_acc<D>(acc);
    uint32_t a[kBN / 16][4];
    to_a(s, a);
    wg_fence();
    mma_ab<D>(acc, a, kt);
    wg_commit();
    wg_wait0();
    fence_acc<D>(acc);
    hold_a(a);
    __syncthreads();        // this slot is read; the next load may refill it
  }
  cp_wait<0>();
  store_rows<D>(dq, acc, scale, b, q0, Tq, H, h);
}

// dk and dv.  grid (B·Hkv, ceil(S / 64)), the first key tiles first.
// Written as OT.
template <int D, typename OT = __nv_bfloat16>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, OT* __restrict__ dk,
           OT* __restrict__ dv, int Tq, int S, int H, int Hkv,
           float scale, int causal) {
  constexpr uint32_t kTile = tile_bytes<D>();
  const int bhk = blockIdx.x, b = bhk / Hkv, hk = bhk % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = warp * 16 + (lane >> 2);        // the thread's keys j0, j0 + 8

  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(attn_tc_smem);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t vs = ks + kTile;
  const uint32_t ring = vs + kTile;              // [stage][Q, dO]
  float* rows = reinterpret_cast<float*>(        // [stage][lse, δ][64]
      attn_tc_smem + (ring - raw) + kStages * 2 * kTile);

  // q tiles of each head of the group: from the one holding row k0 (the
  // first row that sees key k0) when causal
  const int qt_begin = causal ? k0 : 0;
  const int nq = qt_begin < Tq ? (Tq - qt_begin + kBM - 1) / kBM : 0;
  const int n_tiles = G * nq;
  // tile n = (group head g, q tile m): its Q and dO into ring slot `slot`,
  // and the value thread tid stages for it: lse·log2 e of row tid (tid <
  // 64; 1e30 past Tq, so p = 0 there) or δ of row tid − 64
  auto load_q = [&](int n, int slot) {
    const int h = hk * G + n / nq, qt0 = qt_begin + (n % nq) * kBM;
    const uint32_t dst = ring + slot * 2 * kTile;
    load_tile<D>(q, dst, b, qt0, Tq, H, h);
    load_tile<D>(dout, dst + kTile, b, qt0, Tq, H, h);
  };
  auto row_value = [&](int n) {
    const int h = hk * G + n / nq, i = qt_begin + (n % nq) * kBM + (tid & 63);
    const size_t at = ((size_t)b * H + h) * Tq + i;
    if (tid < kBM) return i < Tq ? lse[at] * kLog2e : 1e30f;
    return i < Tq ? delta[at] : 0.f;
  };

  load_tile<D>(k, ks, b, k0, S, Hkv, hk);
  load_tile<D>(v, vs, b, k0, S, Hkv, hk);
  if (n_tiles > 0) {
    load_q(0, 0);
    rows[tid] = row_value(0);
  }
  cp_commit();

  const float sl2 = scale * kLog2e;
  float dka[D / 64][32], dva[D / 64][32], st[32], dpt[32];
  zero<D>(dka);
  zero<D>(dva);
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it & 1;
    float next = 0.f;
    if (it + 1 < n_tiles) {
      load_q(it + 1, slot ^ 1);
      next = row_value(it + 1);   // stored at the end: its latency hides
    }
    cp_commit();
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t qt = ring + slot * 2 * kTile, dot = qt + kTile;
    const float* lsm = rows + slot * 2 * kBM;
    const float* dlm = lsm + kBM;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, one group
    wg_fence();
    mma_abt<D>(st, ks, qt);
    mma_abt<D>(dpt, vs, dot);
    wg_commit();
    wg_wait0();
    fence_regs(st);
    fence_regs(dpt);

    // pᵀ in st, dSᵀ in dpt; columns are query rows.  Only a causal walk's
    // first tile of each head (q tile k0) holds keys past a row.
    const bool diag = causal && it % nq == 0;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = acc_col(0, e);
      float p = ex2(st[e] * sl2 - lsm[col]);
      if (diag && j0 + 8 * acc_half(e) > col) p = 0.f;
      st[e] = p;
      dpt[e] = p * (dpt[e] - dlm[col]);
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q: dO and Q read MN-major
    fence_acc<D>(dva);
    fence_acc<D>(dka);
    uint32_t pa[kBN / 16][4], da[kBN / 16][4];
    to_a(st, pa);
    to_a(dpt, da);
    wg_fence();
    mma_ab<D>(dva, pa, dot);
    mma_ab<D>(dka, da, qt);
    wg_commit();
    wg_wait0();
    fence_acc<D>(dva);
    fence_acc<D>(dka);
    hold_a(pa);
    hold_a(da);
    if (it + 1 < n_tiles) rows[(slot ^ 1) * 2 * kBM + tid] = next;
    __syncthreads();        // this slot is read; the next load may refill it
  }
  cp_wait<0>();
  store_rows<D>(dk, dka, scale, b, k0, S, Hkv, hk);
  store_rows<D>(dv, dva, 1.f, b, k0, S, Hkv, hk);
}

template <int D, typename OT = __nv_bfloat16>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int Tq, int S, int H,
                      int Hkv, int causal, float scale, cudaStream_t stream) {
  static size_t attr_bytes[kMaxDevices] = {};
  cudaError_t e = allow_smem(dq_kernel<D, OT>, dq_smem<D>(), attr_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tq + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  dq_kernel<D, OT><<<grid, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(o),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<OT*>(dq), Tq, S, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

template <int D, typename OT = __nv_bfloat16>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Tq, int S, int H,
                       int Hkv, int causal, float scale, cudaStream_t stream) {
  static size_t attr_bytes[kMaxDevices] = {};
  cudaError_t e = allow_smem(dkv_kernel<D, OT>, dkv_smem<D>(), attr_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * Hkv, (S + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  dkv_kernel<D, OT><<<grid, kThreads, dkv_smem<D>(), stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<OT*>(dk), static_cast<OT*>(dv), Tq, S, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace tc

bool valid(int Tq, int S, int H, int Hkv) {
  return Tq > 0 && S > 0 && Hkv > 0 && H % Hkv == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do and the grads share it).
// bf16 at D = 64 or 128 runs the tensor-core bodies, fp32 and bf16 at D = 256
// the FMA body.
// q/o/do/dq [B, Tq, H, D], k/v [B, S, Hkv, D], lse and delta [B*H, Tq]
// float32; all contiguous.  flash_bwd_dq writes dq and delta; flash_bwd_dkv
// reads delta and writes dk/dv [B, S, Hkv, D] (each kv head's group summed).
// Each returns cudaGetLastError() after its launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, int B, int Tq, int S,
                            int H, int Hkv, int D, int dtype, int causal,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Tq, S, H, Hkv)) return (int)cudaErrorInvalidValue;
#define PT_DQ(LAUNCH, DD)                                                   \
  if (D == DD)                                                              \
    return (int)LAUNCH(q, k, v, o, dout, lse, delta, dq, B, Tq, S, H, Hkv,  \
                       causal, scale, st);
  if (dtype == 0) {
    PT_DQ((launch_dq<float, 64>), 64)
    PT_DQ((launch_dq<float, 128>), 128)
    PT_DQ((launch_dq<float, 256>), 256)
  }
  if (dtype == 1) {
    PT_DQ(tc::launch_dq<64>, 64)
    PT_DQ(tc::launch_dq<128>, 128)
    PT_DQ((launch_dq<__nv_bfloat16, 256>), 256)
  }
#undef PT_DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int Tq, int S, int H, int Hkv, int D, int dtype,
                             int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Tq, S, H, Hkv)) return (int)cudaErrorInvalidValue;
#define PT_DKV(LAUNCH, DD)                                                  \
  if (D == DD)                                                              \
    return (int)LAUNCH(q, k, v, dout, lse, delta, dk, dv, B, Tq, S, H, Hkv, \
                       causal, scale, st);
  if (dtype == 0) {
    PT_DKV((launch_dkv<float, 64>), 64)
    PT_DKV((launch_dkv<float, 128>), 128)
    PT_DKV((launch_dkv<float, 256>), 256)
  }
  if (dtype == 1) {
    PT_DKV(tc::launch_dkv<64>, 64)
    PT_DKV(tc::launch_dkv<128>, 128)
    PT_DKV((launch_dkv<__nv_bfloat16, 256>), 256)
  }
#undef PT_DKV
  return (int)cudaErrorInvalidValue;
}

// The same kernels writing their gradients as float32 whatever the input
// dtype (dq [B, Tq, H, D], dk/dv [B, S, Hkv, D] float32): a caller that
// sums partial gradients over key blocks (the sp ring's kernel route)
// rounds once, at the end.  float32 inputs take the entries above.
extern "C" int flash_bwd_dq_f32out(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, int B, int Tq,
                                   int S, int H, int Hkv, int D, int dtype,
                                   int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Tq, S, H, Hkv) || dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)tc::launch_dq<64, float>(q, k, v, o, dout, lse, delta, dq, B,
                                         Tq, S, H, Hkv, causal, scale, st);
  if (D == 128)
    return (int)tc::launch_dq<128, float>(q, k, v, o, dout, lse, delta, dq,
                                          B, Tq, S, H, Hkv, causal, scale,
                                          st);
  if (D == 256)
    return (int)launch_dq<__nv_bfloat16, 256, float>(
        q, k, v, o, dout, lse, delta, dq, B, Tq, S, H, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_f32out(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int Tq, int S,
                                    int H, int Hkv, int D, int dtype,
                                    int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Tq, S, H, Hkv) || dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)tc::launch_dkv<64, float>(q, k, v, dout, lse, delta, dk, dv,
                                          B, Tq, S, H, Hkv, causal, scale,
                                          st);
  if (D == 128)
    return (int)tc::launch_dkv<128, float>(q, k, v, dout, lse, delta, dk,
                                           dv, B, Tq, S, H, Hkv, causal,
                                           scale, st);
  if (D == 256)
    return (int)launch_dkv<__nv_bfloat16, 256, float>(
        q, k, v, dout, lse, delta, dk, dv, B, Tq, S, H, Hkv, causal, scale,
        st);
  return (int)cudaErrorInvalidValue;
}
