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
// The JAX package computes δ in XLA between its two kernels; here the dq
// kernel computes it from its own do tile and writes it for the dk/dv
// kernel, which runs after it on the same stream.
//
// What bounds it on an H100: at the train path's shapes (B = 1, T = 2048,
// H = 16, D = 128, causal) the two kernels do about 7·T²·H·D/2 multiply-
// adds against some 12·T·H·D bytes, so the tensor-core rate bounds them.
// These first versions run their products as fp32 FMAs on the CUDA cores
// (no wgmma/TMA yet), so in practice the FMA and shared-memory issue rates
// bound them; the tensor-core version is later work.
//
// Design:
//  * dq: one CTA per (b·h, 32-row q tile), 8 warps of 4 query rows, like
//    the forward (csrc/flash_fwd.cu).  The TPU kernel carries the dq sum
//    across sequential grid steps in VMEM scratch; here the k-tile walk is
//    a loop inside the CTA and dq lives in registers (fp32) until it is
//    written once.  A lane scores keys lane and lane+32 of each staged
//    64-key tile (q·k and do·v from padded shared-memory rows), and the
//    ds·k product broadcasts ds with a warp shuffle.
//  * dk/dv: one CTA per (b·kv head, 32-key tile), 8 warps of 4 keys; the
//    walk stages 64 query rows at a time (q, do, lse, δ) and a lane takes
//    rows lane and lane+32.  dk and dv live in registers until written.
//  * GQA: the dk/dv CTA walks the query rows of every head of its kv
//    head's group (h = hk·G + g), so the group's sum happens in fp32 in
//    registers — no repeated k/v, no atomics, one write per key.  The dq
//    CTA reads kv head h / G directly.
//  * Causal: key tiles past a q tile's last row are never visited by dq,
//    and q tiles before a key tile's first key never by dk/dv (the TPU
//    kernels skip the same dead blocks).  Masked scores are −1e30 as in
//    the Pallas bodies, so p is exactly 0 there.  Any T works: rows past
//    the end are zero-filled and masked.
//  * D is 64, 128 or 256; at D = 256 the staged tiles take 193 KB of
//    shared memory (one CTA per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// dq and δ.  grid (ceil(Tq / kBQ), B·H).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int Tq,
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
    T* row = dq + ((size_t)(b * Tq + i) * H + h) * D;
#pragma unroll
    for (int e = 0; e < NV; ++e) store1(row + lane + 32 * e, scale * acc[rr][e]);
  }
}

// dk and dv.  grid (ceil(S / kBKc), B·Hkv).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int S, int H, int Hkv,
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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int Tq, int S, int H,
                      int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBQ * D + 2 * kBK * (D + 1));
  static size_t attr_bytes[kMaxDevices] = {};
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem, attr_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), Tq, S, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Tq, int S, int H,
                       int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBKc * D + 2 * kBQc * (D + 1) + 2 * kBQc);
  static size_t attr_bytes[kMaxDevices] = {};
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem, attr_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBKc - 1) / kBKc, B * Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, S, H, Hkv, scale, causal);
  return cudaGetLastError();
}

bool valid(int Tq, int S, int H, int Hkv) {
  return Tq > 0 && S > 0 && Hkv > 0 && H % Hkv == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do and the grads share it).
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
#define PT_DQ(TT, DD)                                                      \
  if (D == DD)                                                             \
    return (int)launch_dq<TT, DD>(q, k, v, o, dout, lse, delta, dq, B, Tq, \
                                  S, H, Hkv, causal, scale, st);
  if (dtype == 0) { PT_DQ(float, 64) PT_DQ(float, 128) PT_DQ(float, 256) }
  if (dtype == 1) {
    PT_DQ(__nv_bfloat16, 64) PT_DQ(__nv_bfloat16, 128) PT_DQ(__nv_bfloat16, 256)
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
#define PT_DKV(TT, DD)                                                      \
  if (D == DD)                                                              \
    return (int)launch_dkv<TT, DD>(q, k, v, dout, lse, delta, dk, dv, B, Tq, \
                                   S, H, Hkv, causal, scale, st);
  if (dtype == 0) { PT_DKV(float, 64) PT_DKV(float, 128) PT_DKV(float, 256) }
  if (dtype == 1) {
    PT_DKV(__nv_bfloat16, 64) PT_DKV(__nv_bfloat16, 128)
    PT_DKV(__nv_bfloat16, 256)
  }
#undef PT_DKV
  return (int)cudaErrorInvalidValue;
}
