// Decode attention at admission-chunk widths on the tensor cores, for
// Hopper (sm_90a): the wide-query route (bf16 q over a bf16 or int8 cache,
// R = Tq·G >= r_tc) that csrc/decode_attention.cu (a contiguous cache)
// and csrc/paged_decode_attention.cu (a block-table pool, read in place)
// both run.  Written over split_kv.cuh's `Rows` policy (where cache row t
// of batch row b lives); instantiated for ContiguousRows and PagedRows.
//
// Replaces: paddle_tpu/ops/decode_attention.py::_decode_call and
// ::_paged_call (the Pallas kernels at their pl.pallas_call,
// decode_attention.py:282 and :509) at those widths.
//
// One CTA per (64-row tile of the R packed rows, split, kv head, batch
// row) runs attn_tc.cuh's tile body (its note says what bounds it and how
// it is laid out).  With one split it writes the output itself; with more
// it writes the split-KV scratch (o_part, m_part, l_part) and
// split_kv.cuh's combine kernel merges the splits.  Block tables: a CTA
// copies its split's slice of the table into shared memory once, beside
// pos's load, so no table read stands in front of a tile; attn_tc.cuh
// resolves each tile's 64 rows from that slice two tiles ahead (the
// policy's kStaged), and a row the table does not map is zero-filled,
// never read.  So the body on the pool and the same body on a gathered
// copy of it walk the same values at every row a live slot's query can
// see, in the same order — equal bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tc.cuh"
#include "split_kv.cuh"

namespace chunk_tc {

// Row addressing of one (b, kv head h, 64-row tile of the R packed query
// rows) for attn_tc::attend: packed row r = tq·G + g is query head h·G + g
// at position tq, and sees cache rows t <= pos[b] + tq.
// PagedRows: key t's block comes from `slice`, the CTA's slice of the
// table in shared memory (entry 0: block tb0).
template <int HD, class Rows>
struct ChunkTile {
  static constexpr bool kStaged = !Rows::kDense;
  const __nv_bfloat16* q;
  Rows rows;
  const int* slice;
  int tb0, b, h, r0, R, G, Tq, Hq, T, p_b;
  __device__ __forceinline__ const __nv_bfloat16* q_row(int i) const {
    const int r = r0 + i;
    if (r >= R) return nullptr;
    return q + ((size_t)(b * Tq + r / G) * Hq + h * G + r % G) * HD;
  }
  __device__ __forceinline__ long long kv_row(int t) const {
    if constexpr (Rows::kDense) {
      return rows(b, t, h);
    } else {
      const int pb = slice[t / rows.bs - tb0];
      if (pb < 0) return -1;
      return (long long)((size_t)(pb * rows.bs + t % rows.bs) * rows.Hkv + h);
    }
  }
  __device__ __forceinline__ int frontier(int i) const {
    return min(p_b + (r0 + i) / G, T - 1);
  }
};

// One CTA: packed rows [r0, r0 + 64) of (batch row b, kv head h) against
// the cache rows of split s.  blockIdx.x = rt * nsplit + s.  With nsplit
// == 1 the rows are normalised into out; else the unnormalised (o, m, l)
// go to the scratch the combine kernel reads (m in natural-log units).
template <int HD, typename KT, class Rows>
__global__ void __launch_bounds__(attn_tc::kThreads)
decode_chunk_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const KT* __restrict__ k, const KT* __restrict__ v,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ pos, Rows rows,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int Tq, int Hq, int Hkv,
                       int T, int chunk, int nsplit, float scale) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  const int s = blockIdx.x % nsplit, rt = blockIdx.x / nsplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = Tq * G;
  const int r0 = rt * attn_tc::kBM, Rc = min(attn_tc::kBM, R - r0);
  const int t_begin = s * chunk;
  // PagedRows: the table slice sits past what attn_tc::attend uses
  int* slice = reinterpret_cast<int*>(
      attn_tc::attn_tc_smem + attn_tc::smem_bytes<HD>(kInt8, true));
  const int p_b = pos[b];
  if constexpr (!Rows::kDense)             // in flight beside pos's load
    rows.load_slice(slice, b, t_begin, chunk, attn_tc::kThreads);
  // rows the tile's last query row can see
  const int n_valid = min(T, p_b + (r0 + Rc - 1) / G + 1);
  if (t_begin >= n_valid) return;        // the combine skips this split
  const int t_end = min(t_begin + chunk, n_valid);
  int tb0 = 0;
  if constexpr (!Rows::kDense) {
    tb0 = t_begin / rows.bs;
    __syncthreads();                      // the slice is in
  }

  const ChunkTile<HD, Rows> pol{q,  rows, slice, tb0, b,  h,
                                r0, R,    G,     Tq,  Hq, T, p_b};
  attn_tc::State<HD> st;
  attn_tc::attend<HD, KT>(pol, k, v, ks, vs, t_begin, t_end,
                          scale * attn_tc::kLog2e, st);

  const int i0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const size_t base = ((size_t)(b * Hkv + h) * nsplit + s) * R + r0;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.f / (st.l[r] == 0.f ? 1.f : st.l[r]);
    const int i = i0 + 8 * r;
    if (nsplit > 1 && (threadIdx.x & 3) == 0 && i < Rc) {
      m_part[base + i] = st.m[r] * attn_tc::kLn2;
      l_part[base + i] = st.l[r];
    }
  }
#pragma unroll
  for (int nb = 0; nb < HD / 64; ++nb)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = attn_tc::acc_half(e), i = i0 + 8 * r;
      if (i >= Rc) continue;
      const int col = attn_tc::acc_col(nb, e);
      if (nsplit > 1) {
        *reinterpret_cast<float2*>(o_part + (base + i) * HD + col) =
            make_float2(st.o[nb][e], st.o[nb][e + 1]);
      } else {
        const int pr = r0 + i, tq = pr / G, g = pr % G;
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((size_t)(b * Tq + tq) * Hq + h * G + g) * HD + col) =
            __floats2bfloat162_rn(st.o[nb][e] * inv[r],
                                  st.o[nb][e + 1] * inv[r]);
      }
    }
}

template <int HD, typename KT, class Rows>
cudaError_t launch_tc(const split_kv::Args& a, Rows rows) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  const int R = a.Tq * (a.Hq / a.Hkv);
  const int n_rt = (R + attn_tc::kBM - 1) / attn_tc::kBM;
  size_t smem = attn_tc::smem_bytes<HD>(kInt8, !Rows::kDense);
  if constexpr (!Rows::kDense) smem += sizeof(int) * rows.slice_len(a.chunk);
  static size_t attr_bytes[attn_tc::kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= attn_tc::kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(decode_chunk_tc_kernel<HD, KT, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  decode_chunk_tc_kernel<HD, KT, Rows>
      <<<dim3(a.nsplit * n_rt, a.Hkv, a.B), attn_tc::kThreads, smem,
         a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
          rows, static_cast<__nv_bfloat16*>(a.out),
          static_cast<float*>(a.o_part), static_cast<float*>(a.m_part),
          static_cast<float*>(a.l_part), a.Tq, a.Hq, a.Hkv, a.T, a.chunk,
          a.nsplit, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  const int n_rt_c = (R + split_kv::kRT<HD> - 1) / split_kv::kRT<HD>;
  split_kv::combine<__nv_bfloat16, HD, Rows>
      <<<dim3(n_rt_c, a.Hkv, a.B), split_kv::kThreads, 0, a.stream>>>(
          static_cast<const float*>(a.o_part),
          static_cast<const float*>(a.m_part),
          static_cast<const float*>(a.l_part), static_cast<const int*>(a.pos),
          static_cast<__nv_bfloat16*>(a.out), a.Tq, a.Hq, a.Hkv, a.T, a.chunk,
          a.nsplit);
  return cudaGetLastError();
}

template <typename KT, class Rows>
cudaError_t by_hd(int hd, const split_kv::Args& a, Rows rows) {
  if (hd == 64) return launch_tc<64, KT>(a, rows);
  if (hd == 128) return launch_tc<128, KT>(a, rows);
  if (hd == 256) return launch_tc<256, KT>(a, rows);
  return cudaErrorInvalidValue;
}

// kv_dtype: 1 = bfloat16, 2 = int8 (then a.ks/a.vs are the per-row float32
// scales); q and out bfloat16.  Scratch as split_kv::run's, used when
// a.nsplit > 1; a.chunk a multiple of 64 with a.nsplit · a.chunk >= a.T.
// Returns cudaGetLastError() after the launches.
template <class Rows>
cudaError_t run(int kv_dtype, int hd, const split_kv::Args& a, Rows rows) {
  if (a.B <= 0 || a.Tq <= 0 || a.T <= 0 ||
      a.Tq * (a.Hq / a.Hkv) > split_kv::kRMax || a.chunk <= 0 ||
      a.chunk % attn_tc::kBN != 0 || a.nsplit <= 0 ||
      (long long)a.chunk * a.nsplit < a.T)
    return cudaErrorInvalidValue;
  if (kv_dtype == 1) return by_hd<__nv_bfloat16>(hd, a, rows);
  if (kv_dtype == 2) return by_hd<int8_t>(hd, a, rows);
  return cudaErrorInvalidValue;
}

}  // namespace chunk_tc
