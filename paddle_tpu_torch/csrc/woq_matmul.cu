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
//   text/woq.py's `w` (and the Pallas body) builds.  The Pallas body
//   dequantizes a block and hands it to the MXU; here the tensor cores
//   take that role.  No repacked or dequantized copy is written anywhere.
//
// Two bodies, picked by the route (ops/woq_matmul.py `route`, decided the
// same way here and checked against the caller's):
//
// "tc" — bf16 x, gs % 16 == 0, K % 32 == 0: the tensor-core body.
//  What bounds it on an H100: at a decode tick (N = 8 rows of x) bytes —
//  the packed weight and its scales over 3.35 TB/s (2.1 MB, 0.7 µs, for a
//  2048 × 2048 weight at gs 64); at an admission (N = 256) operations —
//  2·N·K·M at 989 TFLOP/s (2.2 µs at 2048²), the bytes a little below.
//  Design:
//  * Swapped product: outᵀ = Wᵀ·xᵀ with wgmma m64nNk16.  A's 64 rows are
//    64 weight columns, built in registers in wgmma's A-fragment layout
//    straight from the packed bytes; B is the x tile in shared memory,
//    K-major (x rows are contiguous along K), 128-byte swizzled as in
//    attn_tc.cuh.  x's rows are wgmma's n: N pads to 8, 16, 32 or 64, so a
//    tick wastes no product rows; above 64 rows, each 64-row tile of x is
//    a CTA of its own (4 at N = 256), so an admission fills the card.
//  * A's row order is free: a thread's two A rows (lane/4 and lane/4 + 8
//    of its warp's 16) are the adjacent columns 2c and 2c + 1, so a k16
//    step reads its nibbles as four 16-bit shared-memory loads (rows 2q,
//    2q + 1, 2q + 8, 2q + 9 of the step, q = lane % 4).  Each byte gives a
//    low-half and a high-half value, so every staged packed tile feeds two
//    k16 chains: against x[:, t0 : t0 + 64] and x[:, K/2 + t0 : …].  A
//    nibble becomes bf16 by bit arithmetic (0x4300 | (q + 8) is 128 + q +
//    8, minus 136 exactly), then one bf16x2 multiply by the bf16 scale —
//    one rounding of the exact q · dt(s), as woq.w.  The epilogue writes
//    columns 2c and 2c + 1 as one bf16×2 store.
//  * Bytes in flight: a ring of 4 stages of 64 packed rows × 64 columns,
//    x's two 64-column halves and the stage's scale rows (one a half when
//    no group starts inside the stage, as at gs 64; else one a k16 step),
//    filled by 16-byte cp.async copies, zero past the split's rows, past M
//    and past N.  The copies, not the ring's depth, set the pace: staging
//    the scales 16 bytes a copy instead of 4 cut the time at every shape,
//    while 2 stages were level with 4 but at one shape and 8 lost at the
//    wide ones (PERF.md).  Packed rows
//    whose width or base is not a multiple of 16 bytes are staged by byte
//    loads, their scales 4 bytes a copy.  gs % 16 == 0 and K % 32 == 0
//    keep every k16 step inside one scale group in both halves.
//  * Filling the card: 2048 columns are only 32 CTAs of 64, so K is split
//    across CTAs in whole stages (`splits`, chosen by the caller for about
//    two CTAs per SM while the fp32 partials stay within half the weight's
//    bytes); each split writes an fp32 partial [N, M] and a second kernel
//    adds them in split order — deterministic, no atomics.  At N = 256
//    there is one split (4 row tiles × 32 column tiles at 2048²), and each
//    weight byte is read once per 64 rows of x, not once per 8.
//  * Budget: one warpgroup (128 threads) a CTA; accumulators N_pad / 2
//    fp32 registers a thread (32 at 64 rows) plus 32 for the A fragments
//    of a stage's 4 k16 steps in both halves.  Shared memory per stage:
//    2·N_pad·128 bytes of x + 5 KB of packed rows (80-byte pitch: the
//    16-bit reads of a warp hit distinct banks) + 2 KB of scales; 37 KB at
//    N = 8, 93 KB at 64 rows (two CTAs an SM).
//
// "fma" — fp32 x, or a gs or K the tensor-core body does not take: the
// fp32-FMA body below, unchanged since it was first written.  It streams
// the packed bytes once per 8-row tile of x:
//  * A CTA owns 128 columns (4 per lane, one 32-bit load of a packed row
//    per lane, a warp on 128 consecutive bytes) and kBN = 8 rows of x, and
//    walks a chunk of packed rows in 256-row steps: x's two halves for
//    those rows are staged in shared memory as fp32, the 8 warps take
//    contiguous eighths of the step, issuing kU = 8 rows' loads before it
//    uses the first, and a warp reloads its scales only when its row
//    crosses into the next group.  The warps' fp32 sums are added in warp
//    order at the end.
//  * K is split across CTAs as above (splits for about two CTAs per SM);
//    larger N runs more 8-row tiles, which re-read the weight from L2.
//    The products are fp32 FMAs on the CUDA cores, bound by them.
//  * Any M: columns past M are masked, and rows whose bytes are not 4-byte
//    aligned take byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tc.cuh"

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

// Launches the split sum of `splits` fp32 partials [N, M] into out.
template <typename T>
cudaError_t sum_splits(const float* part, void* out, int N, int M,
                       int splits, cudaStream_t st) {
  const size_t NM = (size_t)N * M;
  w4_sum_kernel<T><<<(unsigned)((NM + kSumThreads - 1) / kSumThreads),
                     kSumThreads, 0, st>>>(part, static_cast<T*>(out), splits,
                                           NM);
  return cudaGetLastError();
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
  return sum_splits<T>(p, out, N, M, splits, st);
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

namespace w4tc {

constexpr int kThreads = 128;            // one warpgroup
constexpr int kBM = 64;                  // weight columns a CTA: wgmma's m
constexpr int kBKp = 64;                 // packed rows a stage: x's 64-wide tile
constexpr int kSteps = kBKp / 16;        // k16 steps a stage, in each half
constexpr int kPitch = 80;               // bytes a staged packed row
constexpr int kPackedBytes = kBKp * kPitch;
constexpr int kScaleBytes = 2 * kSteps * kBM * 4;
constexpr int kNT = 64;                  // rows of x a CTA, at most
constexpr int kMaxN = 256;
constexpr int kStages = 4;              // ring depth
__host__ __device__ constexpr int stage_bytes(int BN) {
  return 2 * BN * 128 + kPackedBytes + kScaleBytes;
}
__host__ __device__ constexpr size_t smem_bytes(int BN) {
  return 1024 + (size_t)kStages * stage_bytes(BN);
}
static_assert(stage_bytes(8) % 1024 == 0, "x tiles stay 1024-byte aligned");
static_assert(smem_bytes(kNT) <= 232448, "the ring fits an SM");

extern __shared__ __align__(1024) unsigned char w4_smem[];

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The signed nibbles at bits 0-3 and 16-19 of v as a bf16 pair, each times
// the bf16 scale pair s2: dt(q · dt(s)), one rounding of an exact product.
__device__ __forceinline__ uint32_t deq(uint32_t v, uint32_t s2) {
  // 0x4300 | u is the bf16 128 + u; u = nibble ^ 8 = q + 8
  const uint32_t biased = ((v ^ 0x00080008u) & 0x000F000Fu) | 0x43004300u;
  const uint32_t q = fma_bf16x2(biased, 0x3F803F80u, 0xC308C308u);  // - 136
  return fma_bf16x2(q, s2, 0x80008000u);                            // + -0
}

// d += A·B, m64nNWk16: A (bf16 pairs) from registers, B from shared memory
// K-major.
template <int NW> struct Mma;

template <> struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int R>
__device__ __forceinline__ void fence_f(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One CTA: columns [m0, m0 + 64) of out, packed rows [p0, p1) of the split
// blockIdx.y (chunk rows each, a multiple of kBKp), rows [n0, n0 + BN) of
// x (n0 = 64 · blockIdx.z).
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
w4_tc_kernel(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ packed,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
             float* __restrict__ part, int N, int K, int M, int gs,
             int chunk) {
  constexpr int S = kStages;
  constexpr uint32_t kSt = stage_bytes(BN), kX = BN * 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Kp = K / 2, m0 = blockIdx.x * kBM, n0 = blockIdx.z * kNT;
  x += (size_t)n0 * K;                  // this CTA's rows: n0 + [0, Nt)
  const int Nt = min(BN, N - n0);
  const int p0 = blockIdx.y * chunk, p1 = min(p0 + chunk, Kp);
  const int n_it = p1 > p0 ? (p1 - p0 + kBKp - 1) / kBKp : 0;
  // scale rows staged a stage: one a half when no group starts inside a
  // stage (the vector walk), else one a k16 step
  const int n_sc = VEC && gs % kBKp == 0 && Kp % kBKp == 0 ? 1 : kSteps;

  // 1024-byte aligned ring, as the 128-byte swizzle needs
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(w4_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const ring = w4_smem + (base - raw);

  // Stage `it`: x's two halves for its packed rows (swizzled [BN][64]
  // bf16 tiles), the packed rows themselves and the scales of its k16
  // steps — zero past the split's rows, past M and past N.
  auto load = [&](int it) {
    const int t0 = p0 + it * kBKp, slot = it % S;
    const uint32_t st = base + slot * kSt;
    for (int idx = tid; idx < 2 * BN * 8; idx += kThreads) {
      const int h = idx / (BN * 8), r = (idx >> 3) % BN, c = idx & 7;
      const int col = t0 + 8 * c;
      const bool ok = r < Nt && col < p1;
      attn_tc::cp16(st + h * kX + r * 128 + ((c ^ (r & 7)) << 4),
                    ok ? x + (size_t)r * K + h * Kp + col : x, ok);
    }
    if constexpr (VEC) {
      for (int idx = tid; idx < kBKp * 4; idx += kThreads) {
        const int r = idx >> 2, c = idx & 3, row = t0 + r, col = m0 + 16 * c;
        const bool ok = row < p1 && col < M;
        attn_tc::cp16(st + 2 * kX + r * kPitch + 16 * c,
                      ok ? packed + (size_t)row * M + col : packed, ok);
      }
    } else {
      unsigned char* pk = ring + slot * kSt + 2 * kX;
      for (int idx = tid; idx < kBKp * kBM; idx += kThreads) {
        const int r = idx / kBM, c = idx % kBM, row = t0 + r, col = m0 + c;
        pk[r * kPitch + c] = row < p1 && col < M
            ? (unsigned char)packed[(size_t)row * M + col] : 0;
      }
    }
    const uint32_t sc = st + 2 * kX + kPackedBytes;
    if constexpr (VEC) {               // 4 scales a copy
      for (int idx = tid; idx < 2 * n_sc * kBM / 4; idx += kThreads) {
        const int h = idx / (n_sc * kBM / 4), i = (idx / (kBM / 4)) % n_sc;
        const int c = 4 * (idx % (kBM / 4)), row = t0 + 16 * i, col = m0 + c;
        const bool ok = row < p1 && col < M;
        attn_tc::cp16(sc + ((h * kSteps + i) * kBM + c) * 4,
                      ok ? scale + (size_t)((h * Kp + row) / gs) * M + col
                         : scale, ok);
      }
    } else {
      for (int idx = tid; idx < 2 * kSteps * kBM; idx += kThreads) {
        const int h = idx / (kSteps * kBM), i = (idx / kBM) % kSteps;
        const int c = idx % kBM, row = t0 + 16 * i, col = m0 + c;
        const bool ok = row < p1 && col < M;
        cp4(sc + 4 * idx,
            ok ? scale + (size_t)((h * Kp + row) / gs) * M + col : scale, ok);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_it) load(s);
    attn_tc::cp_commit();
  }
  const int q = lane & 3;
  // A rows lane/4 and lane/4 + 8 of this warp are columns colA, colA + 1
  const int colA = 16 * warp + 2 * (lane >> 2);

  for (int it = 0; it < n_it; ++it) {
    if (it + S - 1 < n_it) load(it + S - 1);
    attn_tc::cp_commit();
    attn_tc::cp_wait<S - 1>();         // stage it landed; later ones fly
    attn_tc::fence_async_smem();
    __syncthreads();

    const int slot = it % S;
    const uint32_t st = base + slot * kSt;
    const unsigned char* pk = ring + slot * kSt + 2 * kX;
    const float* sc = reinterpret_cast<const float*>(pk + kPackedBytes);
    uint32_t a[kSteps][2][4];          // [k16 step][low, high half][A regs]
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const unsigned char* pr = pk + (16 * i + 2 * q) * kPitch + colA;
      // bytes (column colA, colA + 1) of rows k and k + 1: the low byte of
      // each 16-bit half is column colA, shifted by 8 column colA + 1
      const uint32_t v0 = *reinterpret_cast<const uint16_t*>(pr) |
          (uint32_t)*reinterpret_cast<const uint16_t*>(pr + kPitch) << 16;
      const uint32_t v8 =
          *reinterpret_cast<const uint16_t*>(pr + 8 * kPitch) |
          (uint32_t)*reinterpret_cast<const uint16_t*>(pr + 9 * kPitch)
              << 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 s =
            *reinterpret_cast<const float2*>(
                sc + (h * kSteps + (n_sc == 1 ? 0 : i)) * kBM + colA);
        const uint32_t s0 = attn_tc::pack_bf16(s.x, s.x);
        const uint32_t s1 = attn_tc::pack_bf16(s.y, s.y);
        a[i][h][0] = deq(v0 >> (4 * h), s0);
        a[i][h][1] = deq(v0 >> (8 + 4 * h), s1);
        a[i][h][2] = deq(v8 >> (4 * h), s0);
        a[i][h][3] = deq(v8 >> (8 + 4 * h), s1);
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][h][r])::"memory");
      }
      attn_tc::wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        Mma<BN>::run(acc, a[i][h],
                     attn_tc::desc(st + h * kX + i * 32, 16, 1024));
    }
    attn_tc::wg_commit();
    attn_tc::wg_wait0();
    // the A fragments stay live (unchanged) until the products read them
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][h][r])::"memory");
    fence_f(acc);
    __syncthreads();                   // this slot is read; it may refill
  }
  attn_tc::cp_wait<0>();

  // accumulator element 4j + e: A row lane/4 + 8·(e / 2) (column colA +
  // e / 2), n = n0 + 8j + 2q + e % 2
  const int m = m0 + colA;
  if (m >= M) return;
  const bool pair = m + 1 < M;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 8 * j + 2 * q + e;
      if (n >= N) continue;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      const size_t at = (size_t)n * M + m;
      if (part != nullptr) {
        float* p = part + (size_t)blockIdx.y * N * M + at;
        p[0] = v0;
        if (pair) p[1] = v1;
      } else if (pair && M % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        out[at] = __float2bfloat16(v0);
        if (pair) out[at + 1] = __float2bfloat16(v1);
      }
    }
}

// Packed rows a split walks: whole stages, splits · chunk >= K/2.
inline int chunk_rows(int K, int splits) {
  const int Kp = K / 2;
  return ((Kp + splits - 1) / splits + kBKp - 1) / kBKp * kBKp;
}

template <int BN, bool VEC>
cudaError_t launch(const void* x, const void* packed, const void* scale,
                   void* out, void* part, int N, int K, int M, int gs,
                   int splits, cudaStream_t st) {
  const size_t smem = smem_bytes(BN);
  // The limit belongs to the current device: raise it once per card.
  static size_t attr_bytes[attn_tc::kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= attn_tc::kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    e = cudaFuncSetAttribute(w4_tc_kernel<BN, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = smem;
  }
  const dim3 grid((M + kBM - 1) / kBM, splits, (N + kNT - 1) / kNT);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  w4_tc_kernel<BN, VEC><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(packed), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), p, N, K, M, gs,
      chunk_rows(K, splits));
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return sum_splits<__nv_bfloat16>(p, out, N, M, splits, st);
}

template <bool VEC>
cudaError_t run_n(const void* x, const void* packed, const void* scale,
                  void* out, void* part, int N, int K, int M, int gs,
                  int splits, cudaStream_t st) {
#define W4_TC_AT(BN)                                                    \
  if (N <= BN)                                                          \
    return launch<BN, VEC>(x, packed, scale, out, part, N, K, M, gs,    \
                           splits, st);
  W4_TC_AT(8) W4_TC_AT(16) W4_TC_AT(32)
#undef W4_TC_AT
  return launch<kNT, VEC>(x, packed, scale, out, part, N, K, M, gs, splits,
                          st);
}

cudaError_t run(const void* x, const void* packed, const void* scale,
                void* out, void* part, int N, int K, int M, int gs,
                int splits, cudaStream_t st) {
  if (N > kMaxN || (uintptr_t)x % 16) return cudaErrorInvalidValue;
  if (M % 16 == 0 && (uintptr_t)packed % 16 == 0 &&
      (uintptr_t)scale % 16 == 0)
    return run_n<true>(x, packed, scale, out, part, N, K, M, gs, splits, st);
  return run_n<false>(x, packed, scale, out, part, N, K, M, gs, splits, st);
}

}  // namespace w4tc

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x [N, K], packed [K/2, M]
// int8, scale [K/gs, 1, M] float32 and out [N, M], all contiguous; part
// [splits, N, M] float32 scratch when splits > 1 (else unused).  route:
// 0 = "fma", 1 = "tc" (bf16 x with gs % 16 == 0 and K % 32 == 0; N <= 256
// and x 16-byte aligned) — the caller's route must be the one decided
// here.  Returns cudaGetLastError() after its launches.
extern "C" int w4_matmul(const void* x, const void* packed, const void* scale,
                         void* out, void* part, int N, int K, int M, int gs,
                         int splits, int dtype, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || K <= 0 || K % 2 || M <= 0 || gs <= 0 || K % gs ||
      splits <= 0 || splits > 65535 || (N + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const int tc = dtype == 1 && gs % 16 == 0 && K % 32 == 0;
  if (route != tc) return (int)cudaErrorInvalidValue;
  if (tc)
    return (int)w4tc::run(x, packed, scale, out, part, N, K, M, gs, splits,
                          st);
  if (dtype == 0)
    return (int)run<float>(x, packed, scale, out, part, N, K, M, gs, splits,
                           st);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, packed, scale, out, part, N, K, M, gs,
                                   splits, st);
  return (int)cudaErrorInvalidValue;
}
