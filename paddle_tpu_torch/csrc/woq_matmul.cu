// W4A16 dequant-matmul for Hopper (sm_90a): x @ dequant(packed int4).
//
// Replaces: paddle_tpu/ops/woq_matmul.py::_w4_call (pallas_call at
// woq_matmul.py:157).
//   out[n, m] = Σ_k x[n, k] · w[k, m], accumulated in fp32, written in x's
//   dtype, where packed [K/2, M] int8 holds two signed nibbles per byte,
//   half-split along K: the low nibble of packed row i is weight row i, the
//   high nibble weight row i + K/2.  Row k uses scale group k / gs of
//   scale [G, 1, M] fp32 (gs = K / G), and the weight is dequantized in
//   the activation dtype, w = dt(q · dt(s)) — bit for bit the weight that
//   text/woq.py's `w` (and the Pallas body) builds.
//
// What bounds it on an H100: bytes.  At a decode tick (N = 8 rows of x)
// each packed byte feeds 2·N multiply-adds, so the least time is the
// packed bytes plus the scales over 3.35 TB/s (2.1 MB, 0.7 µs, for a
// 2048 × 2048 weight at gs 64).  The design streams the packed bytes once,
// never writes a dequantized copy, and keeps enough loads in flight:
//  * A CTA owns 128 columns (4 per lane, one 32-bit load of a packed row
//    per lane, a warp on 128 consecutive bytes) and kBN = 8 rows of x, and
//    walks a chunk of packed rows in 256-row steps: x's two halves for
//    those rows are staged in shared memory as fp32, the 8 warps take
//    contiguous eighths of the step, issuing kU = 8 rows' loads before it
//    uses the first, and a warp reloads its scales only when its row
//    crosses into the next group.  The warps' fp32 sums are added in warp
//    order at the end.
//  * Occupancy: at N = 8 a 2048-wide output is only 16 column tiles for
//    132 SMs, and one CTA walking all of K is bound by its own
//    instruction rate (the dequant and 2·kBN FMAs a byte), so K is split across
//    CTAs (`splits` chunks, chosen by the caller for about two CTAs per
//    SM while the fp32 partials stay within half the weight's bytes):
//    each writes an fp32 partial
//    [N, M] and a second kernel adds them in split order — the split-KV
//    pattern of csrc/split_kv.cuh, deterministic, no atomics.  With one
//    split the first kernel writes the output itself.
//  * Larger N (up to 256, the JAX package's cap for this kernel) runs more
//    8-row tiles, which re-read the weight from L2.  The products are fp32
//    FMAs on the CUDA cores: at N = 256 the kernel is bound by them, not
//    by bytes (a tensor-core body is later work).
//  * Any M: columns past M are masked, and rows whose bytes are not 4-byte
//    aligned take byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 8;                  // rows of x per CTA
constexpr int kCols = 4;                // columns per lane
constexpr int kBM = 32 * kCols;         // columns per CTA
constexpr int kKT = 256;                // packed rows staged per step
constexpr int kU = 8;                   // packed-row loads in flight a lane
constexpr int kSmem = kWarps * kBN * kBM;   // floats (>= 2 * kBN * kKT)
constexpr int kSumThreads = 256;
static_assert(2 * kBN * kKT <= kSmem, "x staging must fit the buffer");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round to the activation dtype and back: identity for fp32.
__device__ __forceinline__ float in_dt(float v, float) { return v; }
__device__ __forceinline__ float in_dt(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The four packed bytes of columns m..m+3 of one packed row (0 past M).
template <bool VEC>
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ row,
                                          int m, int M) {
  if (VEC && m + 3 < M) return *reinterpret_cast<const uint32_t*>(row + m);
  uint32_t u = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (m + c < M) u |= (uint32_t)(uint8_t)row[m + c] << (8 * c);
  return u;
}

// Scales of columns m..m+3 in group grp, rounded to the activation dtype.
template <typename T>
__device__ __forceinline__ void load_scales(const float* __restrict__ scale,
                                            int grp, int m, int M, float* s) {
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    s[c] = m + c < M ? in_dt(scale[(size_t)grp * M + m + c], T()) : 0.f;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
w4_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
          const float* __restrict__ scale, T* __restrict__ out,
          float* __restrict__ part, int N, int K, int M, int gs) {
  __shared__ float buf[kSmem];
  float* xs = buf;                      // [2][kBN][kKT] while walking
  const int Kp = K / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kBM + lane * kCols;
  const int n0 = blockIdx.z * kBN;
  const int chunk = (Kp + gridDim.y - 1) / gridDim.y;
  const int p0 = blockIdx.y * chunk, p1 = min(p0 + chunk, Kp);

  float acc[kBN][kCols];
#pragma unroll
  for (int n = 0; n < kBN; ++n)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[n][c] = 0.f;
  float slo[kCols], shi[kCols];
  int lo_end = -1, hi_end = -1;   // first row past each loaded scale group

  for (int t0 = p0; t0 < p1; t0 += kKT) {
    const int rows = min(kKT, p1 - t0);
    __syncthreads();                    // the previous step's xs is read
#pragma unroll                          // all of a thread's loads in flight
    for (int k = 0; k < 2 * kBN * kKT / kThreads; ++k) {
      const int idx = k * kThreads + threadIdx.x;
      const int h = idx / (kBN * kKT), n = (idx / kKT) % kBN, i = idx % kKT;
      float v = 0.f;
      if (n0 + n < N && i < rows)
        v = to_f(x[(size_t)(n0 + n) * K + h * Kp + t0 + i]);
      xs[idx] = v;
    }
    __syncthreads();
    const int per = (rows + kWarps - 1) / kWarps;
    const int i1 = min((warp + 1) * per, rows);
    for (int i0 = warp * per; i0 < i1; i0 += kU) {
      // kU packed rows' loads in flight before the first is used
      uint32_t u[kU];
#pragma unroll
      for (int j = 0; j < kU; ++j)
        u[j] = i0 + j < i1 ? load4<VEC>(packed + (size_t)(t0 + i0 + j) * M,
                                        m0, M)
                           : 0u;
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        const int i = i0 + j, r = t0 + i;
        if (i >= i1) break;
        if (r >= lo_end) {              // a warp's rows only increase
          lo_end = (r / gs + 1) * gs;
          load_scales<T>(scale, r / gs, m0, M, slo);
        }
        if (r + Kp >= hi_end) {
          hi_end = ((r + Kp) / gs + 1) * gs;
          load_scales<T>(scale, (r + Kp) / gs, m0, M, shi);
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int b = (int)(int8_t)(u[j] >> (8 * c));
          // sign-extend each nibble: low = (b << 4) >> 4 in 8 bits,
          // high = b >> 4
          const float wl =
              in_dt((float)((int8_t)(b << 4) >> 4) * slo[c], T());
          const float wh = in_dt((float)(b >> 4) * shi[c], T());
#pragma unroll
          for (int n = 0; n < kBN; ++n) {
            acc[n][c] = fmaf(xs[n * kKT + i], wl, acc[n][c]);
            acc[n][c] = fmaf(xs[(kBN + n) * kKT + i], wh, acc[n][c]);
          }
        }
      }
    }
  }

  __syncthreads();                      // xs is done; buf becomes red
  float* red = buf;                     // [kWarps][kBN][kBM]
#pragma unroll
  for (int n = 0; n < kBN; ++n)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      red[(warp * kBN + n) * kBM + lane * kCols + c] = acc[n][c];
  __syncthreads();
  for (int o = threadIdx.x; o < kBN * kBM; o += kThreads) {
    const int n = o / kBM, mc = o % kBM;
    const int m = blockIdx.x * kBM + mc;
    if (n0 + n >= N || m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * kBN + n) * kBM + mc];
    const size_t at = (size_t)(n0 + n) * M + m;
    if (part != nullptr)
      part[(size_t)blockIdx.y * N * M + at] = s;
    else
      store(out + at, s);
  }
}

// out = Σ_splits part[split] in split order, in x's dtype.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
w4_sum_kernel(const float* __restrict__ part, T* __restrict__ out, int splits,
              size_t NM) {
  const size_t at = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (at >= NM) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * NM + at];
  store(out + at, s);
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* packed, const void* scale,
                   void* out, void* part, int N, int K, int M, int gs,
                   int splits, cudaStream_t st) {
  const dim3 grid((M + kBM - 1) / kBM, splits, (N + kBN - 1) / kBN);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  w4_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<T*>(out), p, N, K, M, gs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t NM = (size_t)N * M;
  w4_sum_kernel<T><<<(unsigned)((NM + kSumThreads - 1) / kSumThreads),
                     kSumThreads, 0, st>>>(p, static_cast<T*>(out), splits,
                                           NM);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* packed, const void* scale,
                void* out, void* part, int N, int K, int M, int gs,
                int splits, cudaStream_t st) {
  if (M % 4 == 0 && (uintptr_t)packed % 4 == 0)
    return launch<T, true>(x, packed, scale, out, part, N, K, M, gs, splits,
                           st);
  return launch<T, false>(x, packed, scale, out, part, N, K, M, gs, splits,
                          st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x [N, K], packed [K/2, M]
// int8, scale [K/gs, 1, M] float32 and out [N, M], all contiguous; part
// [splits, N, M] float32 scratch when splits > 1 (else unused).  Returns
// cudaGetLastError() after its launches.
extern "C" int w4_matmul(const void* x, const void* packed, const void* scale,
                         void* out, void* part, int N, int K, int M, int gs,
                         int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || K <= 0 || K % 2 || M <= 0 || gs <= 0 || K % gs ||
      splits <= 0 || splits > 65535 || (N + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)run<float>(x, packed, scale, out, part, N, K, M, gs, splits,
                           st);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, packed, scale, out, part, N, K, M, gs,
                                   splits, st);
  return (int)cudaErrorInvalidValue;
}
