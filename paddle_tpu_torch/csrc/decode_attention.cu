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
//    chunk): the tensor-core body of decode_chunk_tc.cuh (attn_tc.cuh's
//    tile body), one CTA per (64-row tile of the R packed rows, split, kv
//    head, batch row), split_kv.cuh's combine kernel merging the splits
//    where there are several.
//  * R >= r_tc otherwise (fp32 q or cache: the small fp32 models'
//    admission chunks): the split-KV body of split_kv.cuh, which this file
//    instantiates with contiguous row addressing.

#include "decode_chunk_tc.cuh"
#include "decode_tick.cuh"
#include "split_kv.cuh"

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
  return (int)chunk_tc::run(kv_dtype, hd, a, rows);
}
