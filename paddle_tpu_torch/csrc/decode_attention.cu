// Split-KV decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/decode_attention.py::_decode_call (the Pallas
// kernel at its pl.pallas_call, decode_attention.py:282) — grouped-query
// attention of q [B, Tq, Hq, hd] against a KV cache [B, T, Hkv, hd] where
// query row i of batch b sees cache rows t <= pos[b] + i; int8 caches carry
// per-(row, head) fp32 scales [B, T, Hkv].
//
// What bounds it on an H100: bytes.  Each live cache row is read once and
// used for Tq·G (1 on the serving path) dot products, so the kernel does
// about one multiply-add per byte read — far under the ~295 operations per
// byte at which bf16 becomes compute-bound.  The least time is the live
// K/V bytes over 3.35 TB/s.
//
// Design, against that bound:
//  * Nothing past the frontier is read: a split whose first row lies past
//    pos[b] + Tq - 1 returns at once, and the walk inside a split stops at
//    the frontier (the TPU kernel's dead-block skip, at row granularity).
//  * Split-KV: one CTA per (split, kv head, batch row).  B·Hkv cells alone
//    (128 at the serving path's B = 8, Hkv = 16) do not fill 132 SMs
//    several times over, so the T walk is cut into `chunk`-row splits that
//    run in parallel; each writes an unnormalised (m, l, acc) triple and a
//    second small kernel combines them.  The TPU kernel instead carried
//    one running (m, l, acc) across sequential grid steps in VMEM scratch;
//    on the GPU nothing carries over between blocks.
//  * GQA: a CTA holds its kv head's whole query group as R = Tq·G rows
//    (row r = tq·G + g), so each K/V row is read from memory once for the
//    whole group and never repeated per query head.
//  * int8 K/V are dequantized by their scales as they are staged in
//    shared memory; no dequantized copy is ever written to device memory.
//  * Loads are 4 elements per thread, consecutive threads on consecutive
//    addresses.  The scores use scale * (q . k), exactly the reference's
//    order; an empty row (l == 0) divides by 1, as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBT = 64;        // cache rows per tile (two per lane)
constexpr int kRMax = 64;      // query rows (Tq * G) per CTA
constexpr int kMaxDevices = 64;  // cards per process the launcher tracks
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

__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = (float)c.x; o[1] = (float)c.y; o[2] = (float)c.z; o[3] = (float)c.w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial(const QT* __restrict__ q, const KT* __restrict__ k,
               const KT* __restrict__ v, const float* __restrict__ ks,
               const float* __restrict__ vs, const int* __restrict__ pos,
               float* __restrict__ o_part, float* __restrict__ m_part,
               float* __restrict__ l_part, int Tq, int Hq, int Hkv, int T,
               int chunk, int nsplit, float scale) {
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = Tq * G;
  const int p_b = pos[b];
  const int n_valid = min(T, p_b + Tq);   // rows any query row can see
  const int t_begin = s * chunk;
  if (t_begin >= n_valid) return;         // the combine skips this split
  const int t_end = min(t_begin + chunk, n_valid);

  extern __shared__ float smem[];
  float* Qs = smem;                       // [R][HD]
  float* Acc = Qs + R * HD;               // [R][HD]
  float* Ks = Acc + R * HD;               // [kBT][HD + 1]
  float* Vs = Ks + kBT * (HD + 1);        // [kBT][HD]
  float* Sc = Vs + kBT * HD;              // [R][kBT]
  float* Mr = Sc + R * kBT;               // [R]
  float* Lr = Mr + R;                     // [R]
  float* Al = Lr + R;                     // [R]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int idx = tid * 4; idx < R * HD; idx += kThreads * 4) {
    const int r = idx / HD, d = idx % HD;
    const int tq = r / G, g = r % G;
    float x[4];
    load4(q + ((size_t)(b * Tq + tq) * Hq + h * G + g) * HD + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      Qs[idx + e] = x[e];
      Acc[idx + e] = 0.f;
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    Mr[r] = kNeg;
    Lr[r] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kBT) {
    const int nt = min(kBT, t_end - t0);
    __syncthreads();   // previous tile consumed; Qs/Mr/Lr initialised
    for (int idx = tid * 4; idx < nt * HD; idx += kThreads * 4) {
      const int j = idx / HD, d = idx % HD;
      const size_t row = (size_t)(b * T + t0 + j) * Hkv + h;
      float kx[4], vx[4];
      load4(k + row * HD + d, kx);
      load4(v + row * HD + d, vx);
      const float sk = ks != nullptr ? ks[row] : 1.f;
      const float sv = vs != nullptr ? vs[row] : 1.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ks[j * (HD + 1) + d + e] = kx[e] * sk;
        Vs[j * HD + d + e] = vx[e] * sv;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * kBT; idx += kThreads) {
      const int r = idx / kBT, j = idx % kBT;
      float sc = -INFINITY;   // not a visible row: contributes nothing
      if (j < nt && t0 + j <= p_b + r / G) {
        const float* qr = Qs + r * HD;
        const float* kr = Ks + j * (HD + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = scale * dot;
      }
      Sc[idx] = sc;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      const float a = Sc[r * kBT + lane], c = Sc[r * kBT + lane + 32];
      const float m_old = Mr[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      Sc[r * kBT + lane] = pa;
      Sc[r * kBT + lane + 32] = pc;
      const float sum = warp_sum(pa + pc);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Al[r] = alpha;
        Lr[r] = Lr[r] * alpha + sum;
        Mr[r] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const float* pr = Sc + r * kBT;
      float a = Acc[idx] * Al[r];
      for (int j = 0; j < nt; ++j) a = fmaf(pr[j], Vs[j * HD + d], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();

  const size_t base = ((size_t)(b * Hkv + h) * nsplit + s) * R;
  for (int idx = tid; idx < R * HD; idx += kThreads)
    o_part[base * HD + idx] = Acc[idx];
  for (int r = tid; r < R; r += kThreads) {
    m_part[base + r] = Mr[r];
    l_part[base + r] = Lr[r];
  }
}

template <typename QT, int HD>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ o_part,
               const float* __restrict__ m_part,
               const float* __restrict__ l_part, const int* __restrict__ pos,
               QT* __restrict__ out, int Tq, int Hq, int Hkv, int T,
               int chunk, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv, R = Tq * G;
  const int n_valid = min(T, pos[b] + Tq);
  const int n_act = n_valid > 0 ? (n_valid + chunk - 1) / chunk : 0;
  const size_t base = (size_t)(b * Hkv + h) * nsplit * R;
  for (int idx = threadIdx.x; idx < R * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float mx = kNeg;
    for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, m_part[base + s * R + r]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const size_t i = base + s * R + r;
      const float w = expf(m_part[i] - mx);
      l = fmaf(l_part[i], w, l);
      a = fmaf(o_part[i * HD + d], w, a);
    }
    const float ls = l == 0.f ? 1.f : l;
    const int tq = r / G, g = r % G;
    store1(out + ((size_t)(b * Tq + tq) * Hq + h * G + g) * HD + d, a / ls);
  }
}

template <typename QT, typename KT, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* pos, void* out,
                   void* o_part, void* m_part, void* l_part, int B, int Tq,
                   int Hq, int Hkv, int T, int chunk, int nsplit, float scale,
                   cudaStream_t stream) {
  const int R = Tq * (Hq / Hkv);
  const size_t smem = sizeof(float) * ((size_t)2 * R * HD + kBT * (HD + 1) +
                                       kBT * HD + (size_t)R * kBT + 3 * R);
  // The limit belongs to the current device: raise it once per card (and
  // again when a larger R needs more).
  static size_t attr_bytes[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(decode_partial<QT, KT, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  decode_partial<QT, KT, HD><<<dim3(nsplit, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), Tq, Hq, Hkv, T, chunk, nsplit, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine<QT, HD><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<const int*>(pos),
      static_cast<QT*>(out), Tq, Hq, Hkv, T, chunk, nsplit);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* pos,
                        void* out, void* o_part, void* m_part, void* l_part,
                        int B, int Tq, int Hq, int Hkv, int T, int chunk,
                        int nsplit, float scale, cudaStream_t st) {
  if (hd == 64)
    return launch<QT, KT, 64>(q, k, v, ks, vs, pos, out, o_part, m_part,
                              l_part, B, Tq, Hq, Hkv, T, chunk, nsplit, scale, st);
  if (hd == 128)
    return launch<QT, KT, 128>(q, k, v, ks, vs, pos, out, o_part, m_part,
                               l_part, B, Tq, Hq, Hkv, T, chunk, nsplit, scale, st);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, int hd, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const void* pos, void* out, void* o_part, void* m_part,
                        void* l_part, int B, int Tq, int Hq, int Hkv, int T,
                        int chunk, int nsplit, float scale, cudaStream_t st) {
  if (kv_dtype == 0)
    return dispatch_hd<QT, float>(hd, q, k, v, ks, vs, pos, out, o_part,
                                  m_part, l_part, B, Tq, Hq, Hkv, T, chunk,
                                  nsplit, scale, st);
  if (kv_dtype == 1)
    return dispatch_hd<QT, __nv_bfloat16>(hd, q, k, v, ks, vs, pos, out,
                                          o_part, m_part, l_part, B, Tq, Hq,
                                          Hkv, T, chunk, nsplit, scale, st);
  if (kv_dtype == 2)
    return dispatch_hd<QT, int8_t>(hd, q, k, v, ks, vs, pos, out, o_part,
                                   m_part, l_part, B, Tq, Hq, Hkv, T, chunk,
                                   nsplit, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then ks/vs are the [B, T, Hkv] float32 scales,
// else null).  q [B, Tq, Hq, hd], k/v [B, T, Hkv, hd], pos [B] int32; all
// contiguous.  Scratch: o_part [B, Hkv, nsplit, R, hd], m_part/l_part
// [B, Hkv, nsplit, R] float32 with R = Tq * Hq / Hkv <= 64 and
// nsplit * chunk >= T, chunk a multiple of 64.  Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* pos, void* out, void* o_part,
                                void* m_part, void* l_part, int B, int Tq,
                                int Hq, int Hkv, int T, int hd, int q_dtype,
                                int kv_dtype, int chunk, int nsplit,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Tq * (Hq / Hkv) > kRMax || chunk <= 0 || chunk % kBT != 0 ||
      (long long)chunk * nsplit < T)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return (int)dispatch_kv<float>(kv_dtype, hd, q, k, v, ks, vs, pos, out,
                                   o_part, m_part, l_part, B, Tq, Hq, Hkv, T,
                                   chunk, nsplit, scale, st);
  if (q_dtype == 1)
    return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, hd, q, k, v, ks, vs,
                                           pos, out, o_part, m_part, l_part,
                                           B, Tq, Hq, Hkv, T, chunk, nsplit,
                                           scale, st);
  return (int)cudaErrorInvalidValue;
}
