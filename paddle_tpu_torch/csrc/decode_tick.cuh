// Decode attention at a tick's widths for Hopper (sm_90a): the body that
// csrc/decode_attention.cu (a contiguous cache) and
// csrc/paged_decode_attention.cu (a block-table pool) run for R = Tq·G <
// r_tc packed query rows per kv head — the decode tick itself (R = 1, or
// G at Tq = 1) and narrow chunks.  Written over split_kv.cuh's `Rows`
// policy (where cache row t of batch row b lives); instantiated for
// ContiguousRows and PagedRows.
//
// Replaces: paddle_tpu/ops/decode_attention.py::_decode_call and
// ::_paged_call (the Pallas kernels at their pl.pallas_call,
// decode_attention.py:282 and :509) at those widths.
// Function: as split_kv.cuh's — query row r = tq·G + g of (b, kv head h)
// attends cache rows t <= pos[b] + tq; scores scale · (q · k) in fp32, int8
// rows scaled by their fp32 (row, head) scale, out in q's dtype.
//
// What bounds it on an H100: bytes.  Each live K/V row is read once and
// used for R <= 15 dot products (one on the main path's tick): about one
// multiply-add per byte, so the least time is the live K/V bytes over
// 3.35 TB/s (13.4 MB, 0.004 ms, at the main path's mid-serve tick).  At
// that size the time goes to latency: a few dependent trips to memory, so
// the design keeps many bytes in flight and few trips in a row.
//
// Design:
//  * One CTA (4 warps) per (tile of RT query rows, split, kv head, batch
//    row); RT = 1 for a lone query row, else 4 (R > 4 is cut into tiles,
//    whose CTAs re-read the same K/V rows from L2).  The RT rows' q
//    (pre-scaled by scale·log2 e) and their running max, sum and output
//    stay in registers.
//  * A cache row's 16-byte chunks are spread over LPR lanes (hd 128 bf16:
//    16 lanes × 8 elements), so a warp takes 32 / LPR rows at once; a
//    row's dot is summed over its lanes by shuffles.  Each warp issues U
//    row steps of K and V loads (8 of them for bf16, 4 for int8, whose 16
//    elements a lane already double the registers) before it uses any.
//  * Each lane group runs its own online softmax (log2 units, max -1e30,
//    so exp2 of a masked -inf score is 0); groups merge by shuffles, warps
//    through shared memory in warp order.
//  * Block tables (PagedRows): a row's block is one more trip to memory
//    in front of its K/V loads.  So a CTA reads its split's slice of the
//    table once (chunk / bs entries, 4 at the paged tick, one more where
//    a block straddles the split) into shared memory, in flight beside
//    pos's load (the slice depends on the split alone), and each lane
//    steps its rows' (block, row in block) by additions, with no division
//    in the load loop.  An unmapped block (-1) is never read.
//  * Splits: `chunk` rows each (ops/decode_attention.py `tick_plan` sizes
//    the grid from T, so that the splits live at a tick fill the card);
//    a split past the tile's last frontier returns at once.  A CTA alone
//    in its tile writes the output; otherwise each writes its (o, m, l)
//    and takes an integer ticket, and the last one merges the splits in
//    split order and zeroes the ticket for the next launch.  No float
//    atomics, no second kernel: a second call gives the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_vec.cuh"
#include "split_kv.cuh"

namespace tick {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// How one cache row of head dim HD in KT is spread over a warp.
template <typename KT, int HD>
struct Geo {
  static constexpr int NE = 16 / (int)sizeof(KT);   // elements a chunk
  static constexpr int CH = HD / NE;                // chunks a row
  static constexpr int LPR = CH < 32 ? CH : 32;     // lanes a row
  static constexpr int CPL = CH / LPR;              // chunks a lane
  static constexpr int RPW = 32 / LPR;              // rows a warp at once
  static constexpr int E = NE * CPL;                // elements a lane
  static constexpr int U = NE == 16 ? 4 : 8 / CPL;  // row steps in flight
};

// One CTA: query rows [r0, r0 + RT) of (batch row b, kv head h) against
// the cache rows of split s.  blockIdx.x = rt * nsplit + s.
template <typename QT, typename KT, int HD, int RT, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_tick_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ pos,
                   Rows rows, QT* __restrict__ out, float* __restrict__ o_part,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   int* __restrict__ tickets, int Tq, int Hq, int Hkv, int T,
                   int chunk, int nsplit, float scale) {
  using Gm = Geo<KT, HD>;
  constexpr int NE = Gm::NE, LPR = Gm::LPR, CPL = Gm::CPL, RPW = Gm::RPW;
  constexpr int E = Gm::E, U = Gm::U;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kStep = kWarps * RPW * U;  // rows a CTA takes a step
  __shared__ __align__(16) float so[kWarps][RT][HD];
  __shared__ float sm[kWarps][RT], sl[kWarps][RT];
  __shared__ int last;
  // PagedRows: the split's slice of the block table (dynamic,
  // rows.slice_len(chunk) entries), -1 where unmapped
  extern __shared__ int tick_tbl[];

  const int s = blockIdx.x % nsplit, rt = blockIdx.x / nsplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = Tq * G;
  const int r0 = rt * RT, Rc = min(RT, R - r0);
  const int t_begin = s * chunk;
  const int p_b = pos[b];
  if constexpr (!Rows::kDense)             // in flight beside pos's load
    rows.load_slice(tick_tbl, b, t_begin, chunk, kThreads);
  // rows the tile's last query row can see, and the splits they span
  const int n_valid = min(T, p_b + (r0 + Rc - 1) / G + 1);
  const int n_act = (n_valid + chunk - 1) / chunk;
  if (s >= n_act) return;
  const int t_end = min(t_begin + chunk, n_valid);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPR, j = lane % LPR;

  float qf[RT][E], acc[RT][E], m[RT], l[RT];
  int fr[RT];                             // each row's frontier
  const float qs = scale * kLog2e;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int pr = r0 + r;
    const QT* qp = q + ((size_t)(b * Tq + pr / G) * Hq + h * G + pr % G) * HD;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int n = 0; n < NE; ++n) {
        const int d = (j + LPR * i) * NE + n;
        qf[r][i * NE + n] = r < Rc ? row_vec::to_f(qp[d]) * qs : 0.f;
        acc[r][i * NE + n] = 0.f;
      }
    fr[r] = r < Rc ? p_b + pr / G : -1;
    m[r] = kNeg;
    l[r] = 0.f;
  }
  // PagedRows: the lane's first row of a step as (entry of the table
  // slice, row in the block), and a step's stride in the same terms
  int blk = 0, off = 0, step_b = 0, step_r = 0;
  if constexpr (!Rows::kDense) {
    const int t = t_begin + warp * RPW * U + grp;
    blk = t / rows.bs - t_begin / rows.bs;
    off = t % rows.bs;
    step_b = kStep / rows.bs;
    step_r = kStep % rows.bs;
    __syncthreads();                      // the table slice is in
  }

  for (int t0 = t_begin + warp * RPW * U; t0 < t_end; t0 += kStep) {
    uint4 kr[U][CPL], vr[U][CPL];
    float sk[U], sv[U];
    bool ok[U];
    int bu = blk, ou = off;
#pragma unroll
    for (int u = 0; u < U; ++u) {         // every load of the step, first
      const int t = t0 + u * RPW + grp;
      long long row = -1;
      if constexpr (Rows::kDense) {
        if (t < t_end) row = rows(b, t, h);
      } else {
        if (t < t_end) {
          const int pb = tick_tbl[bu];
          if (pb >= 0)
            row = (long long)((size_t)(pb * rows.bs + ou) * Hkv + h);
        }
        ou += RPW;                        // RPW <= 8 <= bs: one carry
        if (ou >= rows.bs) {
          ou -= rows.bs;
          ++bu;
        }
      }
      ok[u] = row >= 0;                   // an unstored row is never read
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const size_t off = (size_t)row * HD + (j + LPR * i) * NE;
        kr[u][i] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(k + off))
                         : make_uint4(0, 0, 0, 0);
        vr[u][i] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(v + off))
                         : make_uint4(0, 0, 0, 0);
      }
      if constexpr (kQuant) {
        sk[u] = ok[u] ? ks[row] : 0.f;
        sv[u] = ok[u] ? vs[row] : 0.f;
      }
    }
    float sc[U][RT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * RPW + grp;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i)
#pragma unroll
          for (int n = 0; n < NE; ++n)
            d = fmaf(qf[r][i * NE + n], row_vec::unpack<KT>(kr[u][i], n),
                     d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if constexpr (kQuant) d *= sk[u];
        sc[u][r] = ok[u] && t <= fr[r] ? d : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][r]);
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(sc[u][r] - mx);
        l[r] += p;
        sc[u][r] = kQuant ? p * sv[u] : p;   // the weight of V's row
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int n = 0; n < NE; ++n) {
          const float x = row_vec::unpack<KT>(vr[u][i], n);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            acc[r][i * NE + n] = fmaf(sc[u][r], x, acc[r][i * NE + n]);
        }
    if constexpr (!Rows::kDense) {
      blk += step_b;
      off += step_r;
      if (off >= rows.bs) {
        off -= rows.bs;
        ++blk;
      }
    }
  }

  // merge the warp's lane groups (lanes j, j + LPR, ... hold the same
  // columns); lane group 0 keeps the result
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = fmaxf(m[r], m2);
      const float a1 = exp2f(m[r] - mx), a2 = exp2f(m2 - mx);
      m[r] = mx;
      l[r] = l[r] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x2 = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * a1 + x2 * a2;
      }
    }
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int n = 0; n < NE; n += 4)
          *reinterpret_cast<float4*>(&so[warp][r][(j + LPR * i) * NE + n]) =
              make_float4(acc[r][i * NE + n], acc[r][i * NE + n + 1],
                          acc[r][i * NE + n + 2], acc[r][i * NE + n + 3]);
      if (lane == 0) {
        sm[warp][r] = m[r];
        sl[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // the output element (row r of the tile, column d)
  auto out_at = [&](int r, int d) {
    const int pr = r0 + r;
    return out + ((size_t)(b * Tq + pr / G) * Hq + h * G + pr % G) * HD + d;
  };
  // merge the warps in warp order: thread idx takes (row r, column d)
  const size_t part = (size_t)(b * Hkv + h) * nsplit * R + r0;
  for (int idx = threadIdx.x; idx < Rc * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float mx = sm[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm[w][r]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm[w][r] - mx);
      lt += sl[w][r] * c;
      a += so[w][r][d] * c;
    }
    if (n_act == 1) {
      row_vec::from_f(out_at(r, d), a / (lt == 0.f ? 1.f : lt));
    } else {
      const size_t i = part + (size_t)s * R + r;
      o_part[i * HD + d] = a;
      if (d == 0) {
        m_part[i] = mx;
        l_part[i] = lt;
      }
    }
  }
  if (n_act == 1) return;

  // the last split of the tile to finish merges all of them, in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* tk = tickets + ((size_t)(b * Hkv + h) * (gridDim.x / nsplit) + rt);
    last = atomicAdd(tk, 1) == n_act - 1;
    if (last) *tk = 0;                    // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < Rc * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float mx = kNeg;
    for (int sp = 0; sp < n_act; ++sp)
      mx = fmaxf(mx, __ldcg(m_part + part + (size_t)sp * R + r));
    float lt = 0.f, a = 0.f;
    for (int sp = 0; sp < n_act; ++sp) {
      const size_t i = part + (size_t)sp * R + r;
      const float c = exp2f(__ldcg(m_part + i) - mx);
      lt += __ldcg(l_part + i) * c;
      a += __ldcg(o_part + i * HD + d) * c;
    }
    row_vec::from_f(out_at(r, d), a / (lt == 0.f ? 1.f : lt));
  }
}

template <typename QT, typename KT, int HD, int RT, class Rows>
cudaError_t launch(const split_kv::Args& a, Rows rows, int* tickets) {
  const int R = a.Tq * (a.Hq / a.Hkv), n_rt = (R + RT - 1) / RT;
  size_t smem = 0;                        // the table slice (PagedRows)
  if constexpr (!Rows::kDense) smem = sizeof(int) * rows.slice_len(a.chunk);
  decode_tick_kernel<QT, KT, HD, RT, Rows>
      <<<dim3(a.nsplit * n_rt, a.Hkv, a.B), kThreads, smem, a.stream>>>(
          static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
          rows, static_cast<QT*>(a.out), static_cast<float*>(a.o_part),
          static_cast<float*>(a.m_part), static_cast<float*>(a.l_part),
          tickets, a.Tq, a.Hq, a.Hkv, a.T, a.chunk, a.nsplit, a.scale);
  return cudaGetLastError();
}

template <typename QT, typename KT, int HD, class Rows>
cudaError_t by_rt(const split_kv::Args& a, Rows rows, int* tickets) {
  if (a.Tq * (a.Hq / a.Hkv) == 1)
    return launch<QT, KT, HD, 1>(a, rows, tickets);
  return launch<QT, KT, HD, 4>(a, rows, tickets);
}

template <typename QT, typename KT, class Rows>
cudaError_t by_hd(int hd, const split_kv::Args& a, Rows rows, int* tickets) {
  if (hd == 64) return by_rt<QT, KT, 64>(a, rows, tickets);
  if (hd == 128) return by_rt<QT, KT, 128>(a, rows, tickets);
  if (hd == 256) return by_rt<QT, KT, 256>(a, rows, tickets);
  return cudaErrorInvalidValue;
}

template <typename QT, class Rows>
cudaError_t by_kv(int kv_dtype, int hd, const split_kv::Args& a, Rows rows,
                  int* tickets) {
  if (kv_dtype == 0) return by_hd<QT, float>(hd, a, rows, tickets);
  if (kv_dtype == 1) return by_hd<QT, __nv_bfloat16>(hd, a, rows, tickets);
  if (kv_dtype == 2) return by_hd<QT, int8_t>(hd, a, rows, tickets);
  return cudaErrorInvalidValue;
}

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it); kv_dtype: 0 =
// float32, 1 = bfloat16, 2 = int8 (then ks/vs are the per-row float32
// scales, else null).  Scratch as split_kv::run's (o_part
// [B, Hkv, nsplit, R, hd], m_part/l_part [B, Hkv, nsplit, R] float32);
// tickets: at least B · Hkv · ceil(R / RT) int32, all 0 (the kernel leaves
// them 0), needed when nsplit > 1.  R = Tq · Hq / Hkv <= kRMax; nsplit ·
// chunk >= T, chunk a multiple of 64.  Returns cudaGetLastError().
template <class Rows>
cudaError_t run(int q_dtype, int kv_dtype, int hd, const split_kv::Args& a,
                Rows rows, int* tickets) {
  if (a.B <= 0 || a.Tq <= 0 || a.T <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.Tq * (a.Hq / a.Hkv) > split_kv::kRMax || a.chunk <= 0 ||
      a.chunk % split_kv::kBT != 0 || a.nsplit <= 0 ||
      (long long)a.chunk * a.nsplit < a.T ||
      (a.nsplit > 1 && tickets == nullptr))
    return cudaErrorInvalidValue;
  if (q_dtype == 0) return by_kv<float>(kv_dtype, hd, a, rows, tickets);
  if (q_dtype == 1)
    return by_kv<__nv_bfloat16>(kv_dtype, hd, a, rows, tickets);
  return cudaErrorInvalidValue;
}

}  // namespace tick
