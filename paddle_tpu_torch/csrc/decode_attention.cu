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
// The kernels, what bounds them and how they are laid out: split_kv.cuh,
// which this file instantiates with contiguous row addressing.

#include "split_kv.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then ks/vs are the [B, T, Hkv] float32 scales,
// else null).  q [B, Tq, Hq, hd], k/v [B, T, Hkv, hd], pos [B] int32; all
// contiguous.  Scratch: o_part [B, Hkv, nsplit, R, hd], m_part/l_part
// [B, Hkv, nsplit, R] float32 with R = Tq * Hq / Hkv <= 1024 and
// nsplit * chunk >= T, chunk a multiple of 64.  Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* pos, void* out, void* o_part,
                                void* m_part, void* l_part, int B, int Tq,
                                int Hq, int Hkv, int T, int hd, int q_dtype,
                                int kv_dtype, int chunk, int nsplit,
                                float scale, void* stream) {
  const split_kv::Args a{q, k, v, ks, vs, pos, out, o_part, m_part, l_part,
                         B, Tq, Hq, Hkv, T, chunk, nsplit, scale,
                         static_cast<cudaStream_t>(stream)};
  return (int)split_kv::run(q_dtype, kv_dtype, hd, a,
                            split_kv::ContiguousRows{T, Hkv});
}
