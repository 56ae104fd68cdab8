// Decode attention through block tables (the paged KV layout), for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/decode_attention.py::_paged_call (the Pallas
// kernel at its pl.pallas_call, decode_attention.py:509) — the function of
// the contiguous decode kernel, with K/V read from a pool [N, bs, Hkv, hd]
// shared by every slot: logical row t of batch row b is row t % bs of
// physical block tables[b, t / bs] (tables [B, nmax] int32, -1 = unmapped),
// so a slot's logical cache holds T = nmax * bs rows.  Query row i of batch
// row b sees rows t <= pos[b] + i that are mapped; int8 pools carry
// per-(row, head) fp32 scales [N, bs, Hkv].
//
// Routes, chosen by the launch's shape and dtypes as csrc/decode_attention.cu
// chooses them (the wrapper's ``decode_attention.paged_route`` takes the
// same decision from the same inputs):
//  * R = Tq·G < r_tc (the paged decode tick, narrow chunks; any dtype):
//    the tick body of decode_tick.cuh over PagedRows — each CTA reads its
//    split's slice of the table once, into shared memory.
//  * R >= r_tc with bf16 q and a bf16 or int8 pool (a paged admission
//    chunk, attending the pool in place): the tensor-core body of
//    decode_chunk_tc.cuh over PagedRows — each CTA reads its split's
//    slice of the table once, and each 64-row tile's rows are resolved
//    from it two tiles ahead of their copies.
//  * R >= r_tc otherwise (fp32 q or pool: the small fp32 models'
//    admission chunks): the split-KV body of split_kv.cuh, which resolves
//    each staged tile's rows through the table likewise.
//
// Where it departs from the TPU kernel, and why:
//  * The Pallas grid steps one pool block per cell and must DMA an
//    in-bounds block even for an unmapped entry (it clamps the index and
//    skips the compute).  Here a block is never read unless it is mapped:
//    an unmapped row is not loaded and not attended, so a free slot (table
//    row all -1, pos 0) returns zeros without touching the pool.
//  * A tile or a split is cut in cache rows whatever the block size (any
//    multiple of 8), so one may span several blocks; each row resolves its
//    own block through the table.
//
// What bounds each body and how it is laid out: the notes of
// decode_tick.cuh, attn_tc.cuh and split_kv.cuh.

#include "decode_chunk_tc.cuh"
#include "decode_tick.cuh"
#include "split_kv.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then ks/vs are the [N, bs, Hkv] float32 scales,
// else null).  q [B, Tq, Hq, hd], k/v pools [N, bs, Hkv, hd], tables
// [B, nmax] int32, pos [B] int32; all contiguous.  Scratch as for
// decode_attention, over T = nmax * bs logical rows: o_part
// [B, Hkv, nsplit, R, hd], m_part/l_part [B, Hkv, nsplit, R] float32, R =
// Tq * Hq / Hkv <= 1024, nsplit * chunk >= T, chunk a multiple of 64;
// tickets: the tick route's B * Hkv * R int32, all 0 (left 0), when
// nsplit > 1.  r_tc: the least R that leaves the tick route (for the
// tensor-core route with bf16 q and a bf16 or int8 pool, else the split-KV
// body).  Returns cudaGetLastError().
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, const void* tables, void* out,
    void* o_part, void* m_part, void* l_part, void* tickets, int B, int Tq,
    int Hq, int Hkv, int N, int nmax, int bs, int hd, int q_dtype,
    int kv_dtype, int chunk, int nsplit, int r_tc, float scale,
    void* stream) {
  if (N <= 0 || nmax <= 0 || bs < 8 || bs % 8 != 0 || Hkv <= 0 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const split_kv::Args a{q, k, v, ks, vs, pos, out, o_part, m_part, l_part,
                         B, Tq, Hq, Hkv, nmax * bs, chunk, nsplit, scale,
                         static_cast<cudaStream_t>(stream)};
  const split_kv::PagedRows rows{static_cast<const int*>(tables), N, nmax,
                                 bs, Hkv};
  if (Tq * (Hq / Hkv) < r_tc)
    return (int)tick::run(q_dtype, kv_dtype, hd, a, rows,
                          static_cast<int*>(tickets));
  if (q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2))
    return (int)split_kv::run(q_dtype, kv_dtype, hd, a, rows);
  return (int)chunk_tc::run(kv_dtype, hd, a, rows);
}
