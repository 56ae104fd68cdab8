// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/flash_attention.py::_flash_fwd_impl (the Pallas
// kernel at its pl.pallas_call, flash_attention.py:164) — blockwise
// online-softmax attention over q, k, v [B, T, H, D] that returns out in
// q's dtype and the per-row logsumexp in fp32.
//
// Two bodies, chosen statically by dtype (``flash_attention.route`` in the
// wrapper takes the same decision):
//  * bf16 q/k/v, D in {64, 128, 256}: the tensor-core body of attn_tc.cuh
//    (wgmma products, a cp.async ring of swizzled K/V tiles) — its note
//    says what bounds it and how it is laid out.  One CTA (one warpgroup)
//    per (64-row q tile, b·h); the grid walks q tiles from the last, so
//    the heaviest causal tiles start first.  No split and no combine: a
//    CTA walks all the keys its rows see.
//  * fp32 q/k/v: the fp32-FMA body below, kept for the small fp32 models
//    whose card-vs-CPU gates need fp32 products.
//
// The fp32 body, what bounds it and its design: at the prefill shapes of
// the serving path (B = 1, T <= 2048, H = 16, D = 128, causal) the work is
// 2·T²·H·D multiply-adds against 8·T·H·D bytes of q, k, v and out, so
// below T ~ 1k the bytes bound it and above that the operations do.  It
// runs its products as fp32 FMAs on the CUDA cores, so in practice its FMA
// and shared-memory issue rate bound it.
//
// Design of the fp32 body:
//  * One CTA per (b·h, 32-row q tile); 8 warps, 4 query rows each.  The
//    TPU kernel carries the running max / denominator / accumulator
//    across sequential grid steps in VMEM scratch; here the k-tile walk is
//    a loop inside the CTA and that state lives in registers (fp32).
//  * Each 64-key tile of k and v is staged in shared memory as fp32 (k
//    rows padded by one float so lanes reading different rows hit
//    different banks).  A lane scores keys lane and lane+32 for its
//    warp's 4 rows, so each k element read from shared memory feeds 4
//    FMAs; the p·v product broadcasts p with a warp shuffle.
//  * D is 64, 128 or 256 (the JAX gate's widths).  At D = 256 a lane
//    holds 4 rows x 8 fp32 accumulators and the tiles take 160 KB of
//    shared memory: one CTA per SM.
//  * Causally dead k tiles are never visited (the walk stops at the
//    tile's last row).  The ragged edge is masked here, so any T works —
//    the TPU's T % 128 gate is a tiling artifact that does not apply.
//  * GQA: the CTA reads kv head h / (H / Hkv) directly; callers need not
//    repeat k/v heads.
//  * Masking follows the Pallas body: a causally masked score is -1e30
//    (not -inf) so the running max stays finite; keys past the end of k
//    contribute nothing.  Empty rows divide by 1, as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_tc.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 32;                 // query rows per CTA
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kBK = 64;                 // keys per tile (two per lane)
constexpr int kMaxDevices = 64;         // cards per process the launcher tracks
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int S, int H, int Hkv,
                 float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D]
  float* Ks = Qs + kBQ * D;               // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);         // [kBK][D]
  constexpr int NV = D / 32;              // output dims per lane

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;

  for (int idx = tid * 4; idx < kBQ * D; idx += kThreads * 4) {
    const int r = idx / D, d = idx % D, t = q0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < Tq) load4(q + ((size_t)(b * Tq + t) * H + h) * D + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[r * D + d + e] = x[e];
  }

  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[rr][e] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and Qs is written)
    for (int idx = tid * 4; idx < kBK * D; idx += kThreads * 4) {
      const int j = idx / D, d = idx % D, t = k0 + j;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < S) {
        const size_t off = ((size_t)(b * S + t) * Hkv + hk) * D + d;
        load4(k + off, kx);
        load4(v + off, vx);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ks[j * (D + 1) + d + e] = kx[e];
        Vs[j * D + d + e] = vx[e];
      }
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr][0] = s[rr][1] = 0.f;
    const float* ka = Ks + lane * (D + 1);
    const float* kb = Ks + (lane + 32) * (D + 1);
    const float* qw = Qs + warp * kRows * D;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float x0 = ka[d], x1 = kb[d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float qv = qw[rr * D + d];
        s[rr][0] = fmaf(qv, x0, s[rr][0]);
        s[rr][1] = fmaf(qv, x1, s[rr][1]);
      }
    }

    float pa[kRows], pb[kRows];
    const int ja = k0 + lane, jb = k0 + lane + 32;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int i = q0 + warp * kRows + rr;
      float sa = scale * s[rr][0], sb = scale * s[rr][1];
      if (causal) {
        if (ja > i) sa = kNeg;
        if (jb > i) sb = kNeg;
      }
      if (ja >= S) sa = -INFINITY;   // no such key
      if (jb >= S) sb = -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(sa, sb)));
      pa[rr] = expf(sa - m_new);
      pb[rr] = expf(sb - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(pa[rr] + pb[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[rr][e] *= alpha;
    }

#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float vv[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) vv[e] = Vs[jj * D + lane + 32 * e];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float pj =
            __shfl_sync(0xffffffffu, jj < 32 ? pa[rr] : pb[rr], jj & 31);
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[rr][e] = fmaf(pj, vv[e], acc[rr][e]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int i = q0 + warp * kRows + rr;
    if (i >= Tq) continue;
    const float ls = l[rr] == 0.f ? 1.f : l[rr];
    float* orow = o + ((size_t)(b * Tq + i) * H + h) * D;
#pragma unroll
    for (int e = 0; e < NV; ++e) orow[lane + 32 * e] = acc[rr][e] / ls;
    if (lane == 0) lse[(size_t)bh * Tq + i] = m[rr] + logf(ls);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Tq, int S, int H, int Hkv,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
  // The limit belongs to the current device: raise it once per card.
  static size_t attr_bytes[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse),
      Tq, S, H, Hkv, scale, causal);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core body (attn_tc.cuh) ----

// Row addressing of one (b, h, 64-row q tile) for attn_tc::attend.
template <int D>
struct FlashTile {
  static constexpr bool kStaged = false;   // every key is stored
  const __nv_bfloat16* q;
  int b, h, hk, q0, Tq, S, H, Hkv, causal;
  __device__ __forceinline__ const __nv_bfloat16* q_row(int i) const {
    const int t = q0 + i;
    return t < Tq ? q + ((size_t)(b * Tq + t) * H + h) * D : nullptr;
  }
  __device__ __forceinline__ size_t kv_row(int t) const {
    return (size_t)(b * S + t) * Hkv + hk;
  }
  __device__ __forceinline__ int frontier(int i) const {
    return causal ? min(q0 + i, S - 1) : S - 1;
  }
};

template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int Tq, int S, int H, int Hkv, float scale, int causal) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * attn_tc::kBM;  // last first
  const FlashTile<D> pol{q, b, h, h / (H / Hkv), q0, Tq, S, H, Hkv, causal};
  const int k_end = causal ? min(S, q0 + attn_tc::kBM) : S;
  attn_tc::State<D> st;
  attn_tc::attend<D, __nv_bfloat16>(pol, k, v, nullptr, nullptr, 0, k_end,
                                    scale * attn_tc::kLog2e, st);

  const int i0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = st.l[r] == 0.f ? 1.f : st.l[r];
    inv[r] = 1.f / ls;
    const int t = q0 + i0 + 8 * r;
    if ((threadIdx.x & 3) == 0 && t < Tq)
      lse[(size_t)bh * Tq + t] = st.m[r] * attn_tc::kLn2 + logf(ls);
  }
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = attn_tc::acc_half(e), t = q0 + i0 + 8 * r;
      if (t >= Tq) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((size_t)(b * Tq + t) * H + h) * D + attn_tc::acc_col(nb, e)) =
          __floats2bfloat162_rn(st.o[nb][e] * inv[r], st.o[nb][e + 1] * inv[r]);
    }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Tq, int S, int H, int Hkv,
                      int causal, float scale, cudaStream_t stream) {
  const size_t smem = attn_tc::smem_bytes<D>(false);
  static size_t attr_bytes[attn_tc::kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= attn_tc::kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  const dim3 grid(B * H, (Tq + attn_tc::kBM - 1) / attn_tc::kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  flash_fwd_tc_kernel<D><<<grid, attn_tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Tq, S, H, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA body), 1 = bfloat16 (the tensor-core body);
// q, k, v and out share it.
// q [B, Tq, H, D], k/v [B, S, Hkv, D], out like q, lse [B*H, Tq] float32;
// all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Tq, int S, int H, int Hkv,
                         int D, int dtype, int causal, float scale,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return (int)launch<64>(q, k, v, o, lse, B, Tq, S, H, Hkv, causal, scale, st);
  if (dtype == 0 && D == 128)
    return (int)launch<128>(q, k, v, o, lse, B, Tq, S, H, Hkv, causal, scale, st);
  if (dtype == 0 && D == 256)
    return (int)launch<256>(q, k, v, o, lse, B, Tq, S, H, Hkv, causal, scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch_tc<64>(q, k, v, o, lse, B, Tq, S, H, Hkv, causal, scale, st);
  if (dtype == 1 && D == 128)
    return (int)launch_tc<128>(q, k, v, o, lse, B, Tq, S, H, Hkv, causal, scale, st);
  if (dtype == 1 && D == 256)
    return (int)launch_tc<256>(q, k, v, o, lse, B, Tq, S, H, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
