// Split-KV decode attention through block tables (the paged KV layout), for
// Hopper (sm_90a).
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
// Where it departs from the TPU kernel, and why:
//  * The Pallas grid steps one pool block per cell and must DMA an
//    in-bounds block even for an unmapped entry (it clamps the index and
//    skips the compute).  Here a block is never read unless it is mapped:
//    an unmapped row is not loaded and not attended, so a free slot (table
//    row all -1, pos 0) returns zeros without touching the pool.
//  * The staged tile is 64 cache rows whatever the block size (any
//    multiple of 8): each staged row resolves its own block through the
//    table, so one tile may span several blocks.
//
// The kernels, what bounds them and how they are laid out: split_kv.cuh,
// which this file instantiates with block-table row addressing.

#include "split_kv.cuh"

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then ks/vs are the [N, bs, Hkv] float32 scales,
// else null).  q [B, Tq, Hq, hd], k/v pools [N, bs, Hkv, hd], tables
// [B, nmax] int32, pos [B] int32; all contiguous.  Scratch as for
// decode_attention, over T = nmax * bs logical rows: o_part
// [B, Hkv, nsplit, R, hd], m_part/l_part [B, Hkv, nsplit, R] float32, R =
// Tq * Hq / Hkv <= 1024, nsplit * chunk >= T, chunk a multiple of 64.
// Returns cudaGetLastError().
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, const void* tables, void* out,
    void* o_part, void* m_part, void* l_part, int B, int Tq, int Hq, int Hkv,
    int N, int nmax, int bs, int hd, int q_dtype, int kv_dtype, int chunk,
    int nsplit, float scale, void* stream) {
  if (N <= 0 || nmax <= 0 || bs < 8 || bs % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const split_kv::Args a{q, k, v, ks, vs, pos, out, o_part, m_part, l_part,
                         B, Tq, Hq, Hkv, nmax * bs, chunk, nsplit, scale,
                         static_cast<cudaStream_t>(stream)};
  return (int)split_kv::run(
      q_dtype, kv_dtype, hd, a,
      split_kv::PagedRows{static_cast<const int*>(tables), N, nmax, bs, Hkv});
}
