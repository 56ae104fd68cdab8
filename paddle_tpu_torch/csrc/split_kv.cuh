// Split-KV decode attention for Hopper (sm_90a): the kernels that
// csrc/decode_attention.cu (a contiguous cache) and
// csrc/paged_decode_attention.cu (a block-table pool) launch for fp32 q
// or caches at R = Tq·G >= r_tc — their narrower launches run
// csrc/decode_tick.cuh, their bf16 chunks csrc/decode_chunk_tc.cuh.  The
// layouts differ only in where cache row t of batch row b lives, which
// the `Rows` template parameter answers (ContiguousRows, PagedRows below;
// the other two bodies take them too).
//
// Function: grouped-query attention of q [B, Tq, Hq, hd] against the rows
// of a KV cache, Hkv kv heads, where query row i of batch row b sees cache
// rows t <= pos[b] + i; int8 caches carry one fp32 scale per (row, head).
// Scores are scale * (q . k) in fp32, an empty row divides by 1, the output
// is in q's dtype.
//
// What bounds it on an H100: bytes.  Each live cache row is read once and
// used for Tq·G dot products (1 on a decode tick), so the kernel does about
// one multiply-add per byte read — far under the ~295 operations per byte at
// which bf16 becomes compute-bound.  The least time is the live K/V bytes
// over 3.35 TB/s.  (A prefill chunk, Tq·G in the hundreds, does more work
// per byte; these fp32-FMA kernels are then far from either bound.)
//
// Design, against that bound:
//  * Nothing past the frontier is read: a split whose first row lies past
//    the last query row's frontier returns at once, and the walk inside a
//    split stops there.  A row that is not stored (an unmapped block of a
//    paged cache) is never read and contributes nothing.
//  * Split-KV: one CTA per (row tile, split, kv head, batch row).  The
//    cache walk is cut into `chunk`-row splits that run in parallel; each
//    writes an unnormalised (m, l, acc) triple and a second small kernel
//    combines them.  The TPU kernels instead carry one running (m, l, acc)
//    across sequential grid steps in VMEM scratch; on the GPU nothing
//    carries over between blocks.
//  * GQA: a kv head's whole query group is R = Tq·G rows (row r = tq·G + g),
//    held in 64-row tiles (32-row at hd 256), one tile per CTA (R up to
//    1024 — the TPU kernels' cap — is 16 tiles), so each K/V row is read
//    once per tile and never once per query head.
//  * int8 K/V are dequantized by their scales as they are staged in shared
//    memory; no dequantized copy is written to device memory.
//  * Loads are 4 elements per thread, consecutive threads on consecutive
//    addresses.  A paged row's address is resolved once per staged row (so
//    a 64-row tile may span several blocks of any size).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace split_kv {

constexpr int kThreads = 128;
constexpr int kBT = 64;          // cache rows per staged tile (two per lane)
// Query rows per CTA (one row tile): 64, or 32 at hd 256 — there a 64-row
// tile's Qs and Acc alone (128 KB) plus the staged K/V tiles would pass the
// 227 KB of shared memory a CTA may have.
template <int HD>
constexpr int kRT = HD > 128 ? 32 : 64;
constexpr int kRMax = 1024;      // query rows (Tq * G) per kv head in all
constexpr int kMaxDevices = 64;  // cards per process the launcher tracks
constexpr float kNeg = -1e30f;

// Cache [B, T, Hkv, hd]: row index (into k/v viewed as [rows, hd] and the
// scales viewed as [rows]) of logical row t of batch row b, kv head h.
// (b * T + t and pb * bs + t % bs below stay in 32 bits, as the rows of a
// cache do: with the whole index in 64 bits the load loop compiled to a
// markedly slower kernel on an H100 — PERF.md, Findings.)
// Every row is stored (kDense), so the address is computed where it is
// loaded, with no staging pass.
struct ContiguousRows {
  static constexpr bool kDense = true;
  int T, Hkv;
  __device__ __forceinline__ long long operator()(int b, int t, int h) const {
    return (long long)((size_t)(b * T + t) * Hkv + h);
  }
};

// Pool [N, bs, Hkv, hd] read through tables [B, nmax]: logical row t of
// batch row b is row t % bs of physical block tables[b, t / bs].  -1 (and,
// defensively, any entry outside [0, N)) means "not stored": never read.
// A staged tile resolves its rows once, into shared memory, before the
// loads that depend on them.  The tick and tensor-core bodies first copy
// their split's slice of the table into shared memory (load_slice), so
// that no table read stands in front of a tile's loads.
struct PagedRows {
  static constexpr bool kDense = false;
  const int* tables;
  int N, nmax, bs, Hkv;
  __device__ __forceinline__ long long operator()(int b, int t, int h) const {
    const int pb = tables[(size_t)b * nmax + t / bs];
    if (pb < 0 || pb >= N) return -1;
    return (long long)((size_t)(pb * bs + t % bs) * Hkv + h);
  }
  // Entries a slice of `chunk` rows spans, at most.
  __host__ __device__ int slice_len(int chunk) const {
    return chunk / bs + 2;
  }
  // Batch row b's entries for rows [t_begin, t_begin + chunk) into dst
  // (entry 0: block t_begin / bs), -1 where a block is not stored; each
  // of a CTA's `threads` threads takes every threads-th entry.
  __device__ __forceinline__ void load_slice(int* dst, int b, int t_begin,
                                             int chunk, int threads) const {
    const int tb0 = t_begin / bs;
    const int n = min(nmax, (t_begin + chunk - 1) / bs + 1) - tb0;
    for (int i = threadIdx.x; i < n; i += threads) {
      const int pb = __ldg(tables + b * nmax + tb0 + i);
      dst[i] = pb < 0 || pb >= N ? -1 : pb;
    }
  }
};

// Everything a launch needs besides the row addressing.
struct Args {
  const void *q, *k, *v, *ks, *vs, *pos;
  void *out, *o_part, *m_part, *l_part;
  int B, Tq, Hq, Hkv, T, chunk, nsplit;
  float scale;
  cudaStream_t stream;
};

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

// One CTA: query rows [r0, r0 + Rc) of (batch row b, kv head h) against the
// cache rows of split s.  blockIdx.x = rt * nsplit + s.
template <typename QT, typename KT, int HD, class Rows>
__global__ void __launch_bounds__(kThreads)
partial(const QT* __restrict__ q, const KT* __restrict__ k,
        const KT* __restrict__ v, const float* __restrict__ ks,
        const float* __restrict__ vs, const int* __restrict__ pos, Rows rows,
        float* __restrict__ o_part, float* __restrict__ m_part,
        float* __restrict__ l_part, int Tq, int Hq, int Hkv, int T, int chunk,
        int nsplit, float scale) {
  const int s = blockIdx.x % nsplit, rt = blockIdx.x / nsplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = Tq * G;
  const int r0 = rt * kRT<HD>, Rc = min(kRT<HD>, R - r0);
  const int p_b = pos[b];
  // rows the tile's last query row can see
  const int n_valid = min(T, p_b + (r0 + Rc - 1) / G + 1);
  const int t_begin = s * chunk;
  if (t_begin >= n_valid) return;         // the combine skips this split
  const int t_end = min(t_begin + chunk, n_valid);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* Rw = reinterpret_cast<long long*>(smem_raw);   // [kBT] row index
  float* Qs = reinterpret_cast<float*>(Rw + kBT);           // [Rc][HD]
  float* Acc = Qs + Rc * HD;              // [Rc][HD]
  float* Ks = Acc + Rc * HD;              // [kBT][HD + 1]
  float* Vs = Ks + kBT * (HD + 1);        // [kBT][HD]
  float* Sc = Vs + kBT * HD;              // [Rc][kBT]
  float* Mr = Sc + Rc * kBT;              // [Rc]
  float* Lr = Mr + Rc;                    // [Rc]
  float* Al = Lr + Rc;                    // [Rc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int idx = tid * 4; idx < Rc * HD; idx += kThreads * 4) {
    const int r = r0 + idx / HD, d = idx % HD;
    const int tq = r / G, g = r % G;
    float x[4];
    load4(q + ((size_t)(b * Tq + tq) * Hq + h * G + g) * HD + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      Qs[idx + e] = x[e];
      Acc[idx + e] = 0.f;
    }
  }
  for (int r = tid; r < Rc; r += kThreads) {
    Mr[r] = kNeg;
    Lr[r] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kBT) {
    const int nt = min(kBT, t_end - t0);
    __syncthreads();   // previous tile consumed; Qs/Mr/Lr initialised
    if constexpr (!Rows::kDense) {
      for (int j = tid; j < nt; j += kThreads) Rw[j] = rows(b, t0 + j, h);
      __syncthreads();
    }
    for (int idx = tid * 4; idx < nt * HD; idx += kThreads * 4) {
      const int j = idx / HD, d = idx % HD;
      const long long row = Rows::kDense ? rows(b, t0 + j, h) : Rw[j];
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      float sk = 0.f, sv = 0.f;
      if (Rows::kDense || row >= 0) {     // an unstored row is never read
        load4(k + row * HD + d, kx);
        load4(v + row * HD + d, vx);
        sk = ks != nullptr ? ks[row] : 1.f;
        sv = vs != nullptr ? vs[row] : 1.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ks[j * (HD + 1) + d + e] = kx[e] * sk;
        Vs[j * HD + d + e] = vx[e] * sv;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < Rc * kBT; idx += kThreads) {
      const int r = idx / kBT, j = idx % kBT;
      float sc = -INFINITY;   // not a visible row: contributes nothing
      if (j < nt && (Rows::kDense || Rw[j] >= 0) &&
          t0 + j <= p_b + (r0 + r) / G) {
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

    for (int r = warp; r < Rc; r += kThreads / 32) {
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

    for (int idx = tid; idx < Rc * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const float* pr = Sc + r * kBT;
      float a = Acc[idx] * Al[r];
      for (int j = 0; j < nt; ++j) a = fmaf(pr[j], Vs[j * HD + d], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();

  const size_t base = ((size_t)(b * Hkv + h) * nsplit + s) * R + r0;
  for (int idx = tid; idx < Rc * HD; idx += kThreads)
    o_part[base * HD + idx] = Acc[idx];
  for (int r = tid; r < Rc; r += kThreads) {
    m_part[base + r] = Mr[r];
    l_part[base + r] = Lr[r];
  }
}

// One CTA per (row tile, kv head, batch row): merge the splits each query
// row can see (its own frontier decides which splits ran for it).  `Rows`
// is unused here; it names the kernel after its layout in a profile.
template <typename QT, int HD, class Rows>
__global__ void __launch_bounds__(kThreads)
combine(const float* __restrict__ o_part, const float* __restrict__ m_part,
        const float* __restrict__ l_part, const int* __restrict__ pos,
        QT* __restrict__ out, int Tq, int Hq, int Hkv, int T, int chunk,
        int nsplit) {
  const int rt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = Tq * G;
  const int r0 = rt * kRT<HD>, Rc = min(kRT<HD>, R - r0);
  const size_t base = (size_t)(b * Hkv + h) * nsplit * R;
  for (int idx = threadIdx.x; idx < Rc * HD; idx += kThreads) {
    const int r = r0 + idx / HD, d = idx % HD;
    const int tq = r / G, g = r % G;
    const int n_valid = min(T, pos[b] + tq + 1);
    const int n_act = n_valid > 0 ? (n_valid + chunk - 1) / chunk : 0;
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
    store1(out + ((size_t)(b * Tq + tq) * Hq + h * G + g) * HD + d, a / ls);
  }
}

template <typename QT, typename KT, int HD, class Rows>
cudaError_t launch(const Args& a, Rows rows) {
  const int R = a.Tq * (a.Hq / a.Hkv);
  const int Rt = min(R, kRT<HD>), n_rt = (R + kRT<HD> - 1) / kRT<HD>;
  const size_t smem = sizeof(long long) * kBT +
                      sizeof(float) * ((size_t)2 * Rt * HD + kBT * (HD + 1) +
                                       kBT * HD + (size_t)Rt * kBT + 3 * Rt);
  // The limit belongs to the current device: raise it once per card (and
  // again when a larger tile needs more).
  static size_t attr_bytes[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(partial<QT, KT, HD, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  partial<QT, KT, HD, Rows>
      <<<dim3(a.nsplit * n_rt, a.Hkv, a.B), kThreads, smem, a.stream>>>(
          static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
          rows, static_cast<float*>(a.o_part), static_cast<float*>(a.m_part),
          static_cast<float*>(a.l_part), a.Tq, a.Hq, a.Hkv, a.T, a.chunk,
          a.nsplit, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine<QT, HD, Rows><<<dim3(n_rt, a.Hkv, a.B), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.o_part), static_cast<const float*>(a.m_part),
      static_cast<const float*>(a.l_part), static_cast<const int*>(a.pos),
      static_cast<QT*>(a.out), a.Tq, a.Hq, a.Hkv, a.T, a.chunk, a.nsplit);
  return cudaGetLastError();
}

template <typename QT, typename KT, class Rows>
cudaError_t by_hd(int hd, const Args& a, Rows rows) {
  if (hd == 64) return launch<QT, KT, 64>(a, rows);
  if (hd == 128) return launch<QT, KT, 128>(a, rows);
  if (hd == 256) return launch<QT, KT, 256>(a, rows);
  return cudaErrorInvalidValue;
}

template <typename QT, class Rows>
cudaError_t by_kv(int kv_dtype, int hd, const Args& a, Rows rows) {
  if (kv_dtype == 0) return by_hd<QT, float>(hd, a, rows);
  if (kv_dtype == 1) return by_hd<QT, __nv_bfloat16>(hd, a, rows);
  if (kv_dtype == 2) return by_hd<QT, int8_t>(hd, a, rows);
  return cudaErrorInvalidValue;
}

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then ks/vs are the per-row float32 scales, else
// null).  Scratch: o_part [B, Hkv, nsplit, R, hd], m_part/l_part
// [B, Hkv, nsplit, R] float32, R = Tq * Hq / Hkv <= kRMax; nsplit * chunk >=
// T, chunk a multiple of kBT.  Returns cudaGetLastError() after the launches.
template <class Rows>
cudaError_t run(int q_dtype, int kv_dtype, int hd, const Args& a, Rows rows) {
  if (a.B <= 0 || a.Tq <= 0 || a.T <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.Tq * (a.Hq / a.Hkv) > kRMax || a.chunk <= 0 || a.chunk % kBT != 0 ||
      a.nsplit <= 0 || (long long)a.chunk * a.nsplit < a.T)
    return cudaErrorInvalidValue;
  if (q_dtype == 0) return by_kv<float>(kv_dtype, hd, a, rows);
  if (q_dtype == 1) return by_kv<__nv_bfloat16>(kv_dtype, hd, a, rows);
  return cudaErrorInvalidValue;
}

}  // namespace split_kv
