// Tensor-core attention-forward tile body for Hopper (sm_90a): the body
// that csrc/flash_fwd.cu (bf16 q/k/v) and the wide-query routes of
// csrc/decode_attention.cu and csrc/paged_decode_attention.cu (bf16 q,
// R = Tq·G >= R_TC, through csrc/decode_chunk_tc.cuh) run.
//
// Replaces the products of three Pallas kernels:
//  * paddle_tpu/ops/flash_attention.py::_flash_fwd_impl (pl.pallas_call at
//    flash_attention.py:164): S = Q·Kᵀ, an online softmax and O = P·V over
//    k tiles, with a causal frontier;
//  * paddle_tpu/ops/decode_attention.py::_decode_call and ::_paged_call
//    (pl.pallas_call at decode_attention.py:282 and :509) at
//    admission-chunk widths: the same function over a KV cache (contiguous
//    or a block-table pool), packed query row r = tq·G + g seeing cache
//    rows t <= pos[b] + tq.
//
// Function: each query row takes its softmax over the key rows it can see;
// scores are scale · (q · k) of bf16 q and k accumulated in fp32.  A score
// the row cannot see is -1e30 (never -inf, as both Pallas bodies), so the
// running max stays finite; a row with nothing visible divides by 1.  int8
// caches (decode) carry one fp32 scale per (cache row, head).
//
// What bounds it on an H100 at the paths' shapes: operations.  The flash
// forward at the train shape (B = 1, T = 2048, H = 16, D = 128, causal)
// does 4·D·H·T(T+1)/2 = 17.2 GFLOP against 33.7 MB of q, k, v, out and
// lse: 0.0174 ms at 989 TFLOP/s bf16 against 0.0101 ms at 3.35 TB/s.  At
// T = 512 and at a decode chunk of R = 512 rows over a 512-row cache the
// bytes bound it (0.0025 ms), the products a little below them.  The fp32
// FMA bodies before this one ran the products on the CUDA cores at 15-18
// TFLOP/s; here they run on the tensor cores.
//
// Design:
//  * One warpgroup (128 threads) owns a 64-row query tile.  Q stays in
//    shared memory for the whole walk.  S = Q·Kᵀ is a chain of
//    wgmma.mma_async m64n64k16 products with both operands in shared
//    memory (K-major: the head dim is contiguous in q and k rows);
//    O += P·V is the same product with P as the register A operand and V
//    read MN-major (head dim contiguous) through the transpose bit.
//    Accumulators are fp32 registers (S: 32 a thread, O: D/2).
//  * The softmax works on S in the accumulator layout (a thread holds two
//    rows, i0 = 16·warp + lane/4 and i0 + 8, 16 keys of each per tile):
//    row max and sum reduce over the 4 threads of a row with two shuffles.
//    The running max m and sum l stay fp32, in log2 units (scores are
//    pre-scaled by scale·log2 e, exp is ex2.approx).  l sums the fp32 p
//    BEFORE p is rounded to bf16 for the P·V product, so the lse keeps
//    fp32 accuracy.  The accumulator layout of S is the register layout of
//    wgmma's A operand, so p goes from S's registers to P·V's with a cast
//    and no shuffle.
//  * K and V tiles of 64 keys go through a 2-stage ring in shared memory,
//    filled with 16-byte cp.async copies (zero-filled past the last key,
//    so no stale value can turn 0 · x into NaN); the next tile's copies
//    fly while the current tile's products run.  Every tile (Q, K, V) is
//    stored in the 128-byte swizzled layout that wgmma descriptors read:
//    [D/64 column blocks][rows][64 bf16], 16-byte chunk c of row r at
//    chunk c ^ (r % 8), each block 1024-byte aligned.  K and V share that
//    layout: read K-major it is Kᵀ for S, read MN-major it is V for O.
//  * int8 caches: int8 values are exact in bf16, so the raw values are
//    staged as bf16 (a register pass instead of cp.async) and the scales
//    stay out of the tile: the k scale multiplies S's column, the v scale
//    is folded into p before its bf16 cast (l sums p without it).  No
//    dequantized copy is written anywhere.
//  * Causal and cache frontiers: the walk stops at the tile's last row's
//    frontier; only tiles that cross the first row's frontier are masked.
//  * Rows that may not be stored (a block-table pool: the policy's
//    kStaged): each tile's 64 rows are resolved once, into shared memory,
//    two tiles ahead of its copies — a ring of three row tiles, filled
//    while the tensor cores run the S product, so no barrier or address
//    arithmetic stands between a tile and its copies.  At the paged
//    admission's shapes a barrier at every tile cost 3.5 µs a launch,
//    each thread resolving its own rows 11 µs, the ring filled before
//    the copies land 2.5 µs, filled under the product 1.6 µs (against
//    this body on the same memory, contiguous; PERF.md).  An unstored row
//    is zero-filled and never read.  Its scores are then 0, so a row
//    whose every key is unstored (a free slot) weighs zero V rows and
//    comes out exactly 0; within a live slot's frontier every row is
//    stored.
//
// Shared memory: 1 KB alignment slack + Q (128·D bytes) + 2 stages of K
// and V (256·D bytes each) [+ int8 scales] [+ 3 tiles of row indices]: 81
// KB at D = 128 (two CTAs an SM), 161 KB at D = 256 (one).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attn_tc {

constexpr int kThreads = 128;      // one warpgroup
constexpr int kBM = 64;            // query rows per CTA
constexpr int kBN = 64;            // keys per staged tile
constexpr int kStages = 2;
constexpr int kRowRing = 3;        // tiles of resolved rows (kStaged)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;    // cards per process the launchers track

template <int D>
__host__ __device__ constexpr size_t smem_bytes(bool int8_kv,
                                                bool staged = false) {
  return 1024 + (size_t)kBM * D * 2 + (size_t)kStages * 2 * kBN * D * 2 +
         (int8_kv ? (size_t)kStages * 2 * kBN * sizeof(float) : 0) +
         (staged ? (size_t)kRowRing * kBN * sizeof(int) : 0);
}

extern __shared__ __align__(1024) unsigned char attn_tc_smem[];

// Byte offset of 16-byte chunk c of row r in a swizzled [rows x D] tile.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo/sbo in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products' issue and wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A·B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, m64n64k16, A (bf16 pairs) from registers, B from shared memory
// MN-major (the transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

constexpr uint32_t kBlock = kBM * 128;  // a 64-row column block of a tile
static_assert(kBM == kBN, "Q and K/V tiles share kBlock");

// d = A·Bᵀ over D: A and B 64-row swizzled tiles, both read K-major (the
// head dim contiguous).  Issues the chain; the caller commits and waits.
template <int D>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = (k >> 2) * kBlock + (k & 3) * 32;  // 16 wide a step
    mma_ss(d, desc(a + off, 16, 1024), desc(b + off, 16, 1024), k > 0);
  }
}

// acc[nb] += A·B: A 64 x 64 from registers (bf16 pairs in wgmma's A
// layout), B a 64-row tile read MN-major (column block nb of the head dim).
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 64][32],
                                       const uint32_t (&a)[kBN / 16][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
      mma_rs(acc[nb], a[kk][0], a[kk][1], a[kk][2], a[kk][3],
             desc(b + nb * kBlock + kk * 2048, kBlock, 1024));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes 2j and 2j + 1 of w (signed int8 values) as a bf16 pair: exact.
__device__ __forceinline__ uint32_t i8_pair(int w, int j) {
  const float lo = (float)((int)((unsigned)w << (24 - 16 * j)) >> 24);
  const float hi = (float)((int)((unsigned)w << (16 - 16 * j)) >> 24);
  return pack_bf16(lo, hi);
}

// x (accumulator layout, fp32) -> wgmma's A operand, bf16 pairs: the
// accumulator layout is the A layout, so no value changes threads.
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
      asm volatile("" : "+r"(a[kk][r])::"memory");
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The running state a thread keeps for its two rows (i0 and i0 + 8):
// o[D/64 column blocks][accumulator layout], m in log2 units, l its own
// 16-column partial sums (quad_sum them at the end).
template <int D>
struct State {
  float o[D / 64][32];
  float m[2], l[2];
};

// Accumulator element e of column block b of a thread: its row (i0 or
// i0 + 8: half 0 or 1) and column.
__device__ __forceinline__ int acc_half(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int acc_col(int b, int e) {
  return 64 * b + 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
}

// Threads [tid0, tid0 + kBN) resolve keys [k0, k0 + kBN) of a kStaged
// policy into dst: the row index, or -1 where the key is not stored or
// lies past k_lim.
template <class Pol>
__device__ __forceinline__ void resolve_rows(const Pol& pol, int k0,
                                             int k_lim, int* dst, int tid0) {
  const int r = (int)threadIdx.x - tid0;
  if (r >= 0 && r < kBN)
    dst[r] = k0 + r < k_lim ? (int)pol.kv_row(k0 + r) : -1;
}

// Stage keys [k0, k0 + kBN) of k and v (rows below k_lim exist; the rest
// are zero-filled) into ring slot (ks_, vs_), and their int8 scales.  A
// kStaged policy's rows come from srows (resolve_rows, -1: zero-filled).
template <int D, typename KT, class Pol>
__device__ __forceinline__ void load_kv(const Pol& pol, const KT* __restrict__ k,
                                        const KT* __restrict__ v,
                                        const float* __restrict__ ksc,
                                        const float* __restrict__ vsc,
                                        int k0, int k_lim, uint32_t ks_,
                                        uint32_t vs_, float* ksm, float* vsm,
                                        int* srows) {
  const int tid = threadIdx.x;
  // row of key k0 + r in k/v (0 where it is not stored) and whether it is
  auto row_of = [&](int r, size_t& row) {
    if constexpr (Pol::kStaged) {
      const int sr = srows[r];
      row = sr >= 0 ? (size_t)sr : 0;
      return sr >= 0;
    } else {
      const bool ok = k0 + r < k_lim;
      row = ok ? (size_t)pol.kv_row(k0 + r) : 0;
      return ok;
    }
  };
  if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    constexpr int C = D / 8;                     // 16-byte chunks a row
    for (int idx = tid; idx < kBN * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      size_t row;
      const bool ok = row_of(r, row);
      cp16(ks_ + swz(r, c, kBN), k + row * D + c * 8, ok);
      cp16(vs_ + swz(r, c, kBN), v + row * D + c * 8, ok);
    }
  } else {                                       // int8: stage as bf16
    constexpr int C = D / 16;                    // 16-value chunks a row
    for (int idx = tid; idx < kBN * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      int4 kx = make_int4(0, 0, 0, 0), vx = kx;
      size_t row;
      if (row_of(r, row)) {
        kx = *reinterpret_cast<const int4*>(k + row * D + c * 16);
        vx = *reinterpret_cast<const int4*>(v + row * D + c * 16);
      }
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const int4 x = which ? vx : kx;
        const int xs[4] = {x.x, x.y, x.z, x.w};
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = i8_pair(xs[e >> 1], e & 1);
        const uint32_t base = which ? vs_ : ks_;
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         base + swz(r, 2 * c, kBN)),
                     "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                     : "memory");
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         base + swz(r, 2 * c + 1, kBN)),
                     "r"(w[4]), "r"(w[5]), "r"(w[6]), "r"(w[7])
                     : "memory");
      }
    }
    for (int r = tid; r < kBN; r += kThreads) {
      size_t row;
      const bool ok = row_of(r, row);
      ksm[r] = ok ? ksc[row] : 0.f;
      vsm[r] = ok ? vsc[row] : 0.f;
    }
  }
}

// Attend the CTA's 64 query rows to keys [k_begin, k_end) (k_begin a
// multiple of kBN).  qk2 = scale · log2 e.  The policy `pol` answers:
//   const __nv_bfloat16* q_row(int i)  query row i of the tile, or nullptr
//   kv_row(int t)                      row index of key t in k/v (and
//                                      scales); with kStaged, < 0 where
//                                      key t is not stored
//   int frontier(int i)                last key row i may see (inclusive)
//   static constexpr bool kStaged      whether keys may be unstored (their
//                                      rows are then resolved a tile at a
//                                      time into shared memory, two tiles
//                                      ahead)
// Rows past the policy's rows and keys past a row's frontier are masked;
// frontiers must not decrease with i.
template <int D, typename KT, class Pol>
__device__ __forceinline__ void attend(const Pol& pol, const KT* __restrict__ k,
                                       const KT* __restrict__ v,
                                       const float* __restrict__ ksc,
                                       const float* __restrict__ vsc,
                                       int k_begin, int k_end, float qk2,
                                       State<D>& st) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  constexpr int NB = D / 64;                     // 64-column blocks of D
  constexpr uint32_t kTile = kBN * D * 2;        // bytes of one K (or V) tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1024-byte aligned base, as the 128-byte swizzle needs
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(attn_tc_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ring = qs + kBM * D * 2;        // [stage][K, V] tiles
  float* scales = reinterpret_cast<float*>(
      attn_tc_smem + (ring - raw) + kStages * 2 * kTile);   // [stage][ks, vs][kBN]
  int* srows = reinterpret_cast<int*>(     // [kRowRing][kBN] (kStaged)
      scales + (kInt8 ? kStages * 2 * kBN : 0));

  {  // Q: 64 rows x D, zero rows past the policy's
    constexpr int C = D / 8;
    for (int idx = tid; idx < kBM * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      const __nv_bfloat16* src = pol.q_row(r);
      cp16(qs + swz(r, c, kBM), src ? src + c * 8 : pol.q_row(0), src != nullptr);
    }
  }
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;
  if constexpr (Pol::kStaged) {   // the first two tiles' rows, half each
    resolve_rows(pol, k_begin, k_end, srows, 0);
    resolve_rows(pol, k_begin + kBN, k_end, srows + kBN, kBN);
    __syncthreads();
  }
  load_kv<D, KT>(pol, k, v, ksc, vsc, k_begin, k_end, ring, ring + kTile,
                 scales, scales + kBN, srows);
  cp_commit();

  const int i0 = warp * 16 + (lane >> 2);
  const int f0 = pol.frontier(i0), f1 = pol.frontier(i0 + 8);
  const int front_first = pol.frontier(0);      // frontiers grow with i
  const int cq = 2 * (lane & 3);                // first column of the thread

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 32; ++e) st.o[b][e] = 0.f;
  st.m[0] = st.m[1] = kNeg;
  st.l[0] = st.l[1] = 0.f;
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it & 1, k0 = k_begin + it * kBN;
    if (it + 1 < n_tiles) {
      const uint32_t nxt = ring + (slot ^ 1) * 2 * kTile;
      float* nsc = scales + (slot ^ 1) * 2 * kBN;
      load_kv<D, KT>(pol, k, v, ksc, vsc, k0 + kBN, k_end, nxt, nxt + kTile,
                     nsc, nsc + kBN, srows + (it + 1) % kRowRing * kBN);
    }
    cp_commit();
    cp_wait<1>();           // this tile (and Q) landed; the next one flies
    fence_async_smem();
    __syncthreads();

    const uint32_t kt = ring + slot * 2 * kTile, vt = kt + kTile;
    const float* ksm = scales + slot * 2 * kBN;
    const float* vsm = ksm + kBN;

    // S = Q·Kᵀ over D in 16-wide steps
    wg_fence();
    mma_abt<D>(s, qs, kt);
    wg_commit();
    // two tiles ahead, while the product runs, into the ring slot tile
    // it - 1 was read from (a barrier of each loop step since)
    if constexpr (Pol::kStaged)
      if (it + 2 < n_tiles)
        resolve_rows(pol, k0 + 2 * kBN, k_end,
                     srows + (it + 2) % kRowRing * kBN, 0);
    wg_wait0();
    fence_regs(s);

    // scale, mask, online softmax (two rows a thread)
    const bool full = k0 + kBN - 1 <= front_first;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + cq + (e & 1);
        float x = s[4 * j + e] * qk2;
        if constexpr (kInt8) x *= ksm[col];
        if (!full && k0 + col > (e < 2 ? f0 : f1)) x = kNeg;
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(st.m[h], quad_max(mx[h]));
      alpha[h] = ex2(st.m[h] - m_new);
      st.m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * j + e] - st.m[e >> 1]);
        sum[e >> 1] += p;
        if constexpr (kInt8) s[4 * j + e] = p * vsm[8 * j + cq + (e & 1)];
        else s[4 * j + e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) st.o[b][e] *= alpha[acc_half(e)];

    // O += P·V: P from registers, 16 keys a step
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(st.o[b]);
    uint32_t a[kBN / 16][4];   // P in wgmma's A layout: S's, cast to bf16
    to_a(s, a);
    wg_fence();
    mma_ab<D>(st.o, a, vt);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(st.o[b]);
    __syncthreads();        // this slot is read; the next load may refill it
  }
  cp_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = quad_sum(st.l[h]);
}

}  // namespace attn_tc
