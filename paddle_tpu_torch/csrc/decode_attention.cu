// Split-KV decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/decode_attention.py::_decode_call (the Pallas
// kernel at its pl.pallas_call, decode_attention.py:282) — grouped-query
// attention of q [B, Tq, Hq, hd] against a KV cache [B, T, Hkv, hd] where
// query row i of batch b sees cache rows t <= pos[b] + i; int8 caches carry
// per-(row, head) fp32 scales [B, T, Hkv].  Tq·Hq/Hkv may reach 1024, the
// TPU kernel's cap: a decode tick has Tq = 1, a prefill chunk Tq = its
// width.
//
// Three routes, chosen by the launch's shape and dtypes (the wrapper's
// ``decode_attention.route`` takes the same decision from the same inputs):
//  * R = Tq·G < r_tc (the decode tick, narrow chunks; any q and cache
//    dtype): the tick body of decode_tick.cuh, one CTA per (query tile,
//    split, kv head, batch row), the splits merged by the last CTA of each
//    tile.  Its note says what bounds it and how it is laid out.
//  * R >= r_tc with bf16 q and a bf16 or int8 cache (an admission
//    chunk): the tensor-core body of attn_tc.cuh, one CTA per (64-row
//    tile of the R packed rows, split, kv head, batch row).  With one split
//    it writes the output itself; with more it writes the split-KV
//    scratch (o_part, m_part, l_part) and split_kv.cuh's combine kernel
//    merges the splits, unchanged.
//  * R >= r_tc otherwise (fp32 q or cache: the small fp32 models'
//    admission chunks): the split-KV body of split_kv.cuh, which this file
//    instantiates with contiguous row addressing.

#include "attn_tc.cuh"
#include "decode_tick.cuh"
#include "split_kv.cuh"

namespace {

// Row addressing of one (b, kv head h, 64-row tile of the R packed query
// rows) for attn_tc::attend: packed row r = tq·G + g is query head h·G + g
// at position tq, and sees cache rows t <= pos[b] + tq.
template <int HD>
struct ChunkTile {
  const __nv_bfloat16* q;
  int b, h, r0, R, G, Tq, Hq, Hkv, T, p_b;
  __device__ __forceinline__ const __nv_bfloat16* q_row(int i) const {
    const int r = r0 + i;
    if (r >= R) return nullptr;
    return q + ((size_t)(b * Tq + r / G) * Hq + h * G + r % G) * HD;
  }
  __device__ __forceinline__ size_t kv_row(int t) const {
    return (size_t)(b * T + t) * Hkv + h;
  }
  __device__ __forceinline__ int frontier(int i) const {
    return min(p_b + (r0 + i) / G, T - 1);
  }
};

// One CTA: packed rows [r0, r0 + 64) of (batch row b, kv head h) against
// the cache rows of split s.  blockIdx.x = rt * nsplit + s.  With nsplit
// == 1 the rows are normalised into out; else the unnormalised (o, m, l)
// go to the scratch the combine kernel reads (m in natural-log units).
template <int HD, typename KT>
__global__ void __launch_bounds__(attn_tc::kThreads)
decode_chunk_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const KT* __restrict__ k, const KT* __restrict__ v,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int Tq, int Hq, int Hkv,
                       int T, int chunk, int nsplit, float scale) {
  const int s = blockIdx.x % nsplit, rt = blockIdx.x / nsplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = Tq * G;
  const int r0 = rt * attn_tc::kBM, Rc = min(attn_tc::kBM, R - r0);
  const int p_b = pos[b];
  // rows the tile's last query row can see
  const int n_valid = min(T, p_b + (r0 + Rc - 1) / G + 1);
  const int t_begin = s * chunk;
  if (t_begin >= n_valid) return;        // the combine skips this split
  const int t_end = min(t_begin + chunk, n_valid);

  const ChunkTile<HD> pol{q, b, h, r0, R, G, Tq, Hq, Hkv, T, p_b};
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

template <int HD, typename KT>
cudaError_t launch_tc(const split_kv::Args& a) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  const int R = a.Tq * (a.Hq / a.Hkv);
  const int n_rt = (R + attn_tc::kBM - 1) / attn_tc::kBM;
  const size_t smem = attn_tc::smem_bytes<HD>(kInt8);
  static size_t attr_bytes[attn_tc::kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= attn_tc::kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(decode_chunk_tc_kernel<HD, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  decode_chunk_tc_kernel<HD, KT>
      <<<dim3(a.nsplit * n_rt, a.Hkv, a.B), attn_tc::kThreads, smem,
         a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
          static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.o_part),
          static_cast<float*>(a.m_part), static_cast<float*>(a.l_part), a.Tq,
          a.Hq, a.Hkv, a.T, a.chunk, a.nsplit, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  using Rows = split_kv::ContiguousRows;
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

template <typename KT>
cudaError_t tc_by_hd(int hd, const split_kv::Args& a) {
  if (hd == 64) return launch_tc<64, KT>(a);
  if (hd == 128) return launch_tc<128, KT>(a);
  if (hd == 256) return launch_tc<256, KT>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then ks/vs are the [B, T, Hkv] float32 scales,
// else null).  q [B, Tq, Hq, hd], k/v [B, T, Hkv, hd], pos [B] int32; all
// contiguous.  Scratch: o_part [B, Hkv, nsplit, R, hd], m_part/l_part
// [B, Hkv, nsplit, R] float32 with R = Tq * Hq / Hkv <= 1024 and
// nsplit * chunk >= T, chunk a multiple of 64; tickets: the tick route's
// B * Hkv * R int32, all 0 (left 0), when nsplit > 1.  r_tc: the least R
// that leaves the tick route (for the tensor-core route with bf16 q and a
// bf16 or int8 cache, else the split-KV body).  Returns
// cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* pos, void* out, void* o_part,
                                void* m_part, void* l_part, void* tickets,
                                int B, int Tq, int Hq, int Hkv, int T, int hd,
                                int q_dtype, int kv_dtype, int chunk,
                                int nsplit, int r_tc, float scale,
                                void* stream) {
  const split_kv::Args a{q, k, v, ks, vs, pos, out, o_part, m_part, l_part,
                         B, Tq, Hq, Hkv, T, chunk, nsplit, scale,
                         static_cast<cudaStream_t>(stream)};
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int R = Tq * (Hq / Hkv);
  const split_kv::ContiguousRows rows{T, Hkv};
  if (R < r_tc)
    return (int)tick::run(q_dtype, kv_dtype, hd, a, rows,
                          static_cast<int*>(tickets));
  if (q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2))
    return (int)split_kv::run(q_dtype, kv_dtype, hd, a, rows);
  if (B <= 0 || Tq <= 0 || T <= 0 || R > split_kv::kRMax || chunk <= 0 ||
      chunk % attn_tc::kBN != 0 || nsplit <= 0 ||
      (long long)chunk * nsplit < T)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 1) return (int)tc_by_hd<__nv_bfloat16>(hd, a);
  return (int)tc_by_hd<int8_t>(hd, a);
}
