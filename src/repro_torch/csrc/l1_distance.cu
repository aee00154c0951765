// Pairwise and per-query-row L1 distances for Hopper (sm_90a).
//
// Replaces the TPU kernels _l1_kernel / l1_distance_pallas and
// _l1_rows_kernel / l1_distance_rows_pallas
// (src/repro/kernels/l1_distance.py:42, :59, :86, :103).  Contract:
//   l1_pairwise: queries (Q, m), points (N, m)    -> (Q, N)
//   l1_rows:     queries (Q, m), rows   (Q, C, m) -> (Q, C)
// int32 and int16 inputs accumulate in int32 (two's-complement wraparound,
// as torch and XLA do), float32 and bfloat16 inputs in float32.
//
// Pairwise bound.  At the ground-truth shape (64 x 1 M x 128 int32) the
// kernel makes U = Q * N * m = 8.19e9 |q - x| updates against 0.77 GB read
// and written (0.229 ms at 3.35 TB/s), so instruction issue bounds it, not
// bytes.  Design (l1_pairwise_kernel):
//  * A block of 256 threads (16 x 16) takes 64 queries x 128 points.  Each
//    thread keeps 4 consecutive queries x 8 points (two groups of 4, 64
//    points apart) of sums in registers.
//  * 32 coordinates a stage are staged coordinate-major in shared memory,
//    sq[32][64 + 4] and sx[32][128 + 4]: rows stay 16-byte aligned, and the
//    transposing stores (8 coordinates x 4 rows a warp) hit 32 banks.  Per
//    coordinate a thread makes one 16-byte broadcast load of its queries
//    and two conflict-free 16-byte loads of its points for 32 updates.
//  * Global loads are scalar and coalesced (rows of m = 1, 3 or 17 are not
//    16-byte aligned); the next stage's values are loaded into registers
//    while the current stage computes.  Ragged Q, N and m read as zeros,
//    which add nothing.
//  * Two loops: the float loop (d = q - x; acc += |d|: two FADDs on the
//    128-lane FP32 pipe, |d| a free operand modifier) and the int32 loop
//    (uint32 absdiff, three integer instructions on the 64-lane pipe, which
//    wraps as torch and XLA do).
//
// Invariant of the float loop on integer inputs.  float32 holds every
// integer of magnitude <= 2^24 exactly, and the sum or difference of two
// such integers is exact when the true result is <= 2^24 in magnitude too.
// Per stage, the block takes M, the largest |value| it staged (both tiles,
// from the staged values only), and s, the stage's real coordinates: every
// |q - x| of the stage is <= 2M, and every float sum grows by at most
// inc = 2 M s.  The block keeps B, a bound on its float sums since their
// last flush, and decides for all its threads at once:
//  * inc > 2^24: the stage runs the int32 loop, into the uint32 sums;
//  * else, if B + inc > 2^24, it first flushes every float sum into its
//    uint32 sum (an exact F2I, a wrapping add) and sets B = 0; then
//    B += inc, and the stage runs the float loop, whose operands and
//    partial sums are integers <= B <= 2^24: exact.
// At the end the float sums are flushed once more and the uint32 sums are
// stored as int32.  A float stage adds the same |q - x| as int32 would (no
// difference of values <= 2^24 wraps), and uint32 adds are associative
// mod 2^32, so the result equals the plain version bit for bit.  int16
// values have M <= 32768, so inc <= 2^21: int16 always takes the float
// loop, flushing every 8 full stages at worst.  float32 and bfloat16
// inputs always take the float loop, with no uint32 sums.
//
// Per-query rows: every candidate row is read once against one query row,
// so bytes bound it.  One warp per candidate row: lanes stride over the m
// coordinates (neighbouring lanes on neighbouring addresses), accumulate,
// and reduce with shuffles in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQTile = 64;     // pairwise: queries per block
constexpr int kXTile = 128;    // pairwise: points per block
constexpr int kStage = 32;     // pairwise: coordinates staged per step
constexpr int kPad = 4;        // words after each staged row (16-byte rows)
constexpr int kThreads = 256;  // pairwise: 16 x 16 threads, 4 x 8 sums each
constexpr uint64_t kExact = 1ull << 24;  // float32 holds integers up to here
constexpr int kRowWarps = 8;   // l1_rows: warps per block
constexpr int kRowsPerBlock = 32;

// Integer sums run in uint32, which wraps like int32 without undefined
// behaviour; floats in float32.
template <typename T> struct Acc { using type = uint32_t; using out = int32_t; };
template <> struct Acc<float> { using type = float; using out = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; using out = float; };

__device__ __forceinline__ uint32_t widen(int32_t v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t widen(int16_t v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t absdiff(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return static_cast<int32_t>(d) < 0 ? 0u - d : d;
}
__device__ __forceinline__ float absdiff(float a, float b) { return fabsf(a - b); }

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// The bits a value is staged as: int32 bits for the int32 loop, else float.
template <typename T>
__device__ __forceinline__ uint32_t staged(T v, bool wide) {
  if constexpr (std::is_integral<T>::value) {
    const uint32_t w = widen(v);
    return wide ? w : __float_as_uint(static_cast<float>(static_cast<int32_t>(w)));
  } else {
    return __float_as_uint(widen(v));
  }
}

// ---- pairwise: register tiles, the float loop and the int32 loop ----------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
l1_pairwise_kernel(const T* __restrict__ queries, const T* __restrict__ points,
                   typename Acc<T>::out* __restrict__ out, int nq, int n, int m, int vec) {
  constexpr bool kInt = std::is_integral<T>::value;
  constexpr bool kWideLoop = kInt && sizeof(T) == 4;   // only int32 can need it
  __shared__ __align__(16) uint32_t sq[kStage][kQTile + kPad];
  __shared__ __align__(16) uint32_t sx[kStage][kXTile + kPad];
  __shared__ uint32_t smax[kThreads / 32];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int q0 = blockIdx.y * kQTile;
  const int n0 = blockIdx.x * kXTile;
  // staging: thread t loads coordinate sk of rows sr + 8 i (a warp reads 8
  // coordinates of 4 rows), of which the first vq (vx) exist
  const int sk = ((t >> 5) & 3) * 8 + (t & 7);
  const int sr = (t >> 7) * 4 + ((t >> 3) & 3);
  const int vq = (nq - q0 - sr + 7) / 8, vx = (n - n0 - sr + 7) / 8;
  const int off = sr * m + sk;    // in both tiles, from the tile's first row
  const T* qtile = queries + static_cast<size_t>(q0) * m;
  const T* xtile = points + static_cast<size_t>(n0) * m;
  const size_t step = static_cast<size_t>(8) * m;

  float facc[4][8];
  uint32_t uacc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      facc[a][b] = 0.f;
      uacc[a][b] = 0u;
    }
  uint32_t bound = 0;    // B: a bound on every float sum since its last flush

  T rq[kQTile / 8], rx[kXTile / 8];
  // The row pointers advance by one add a row; the empty asm keeps the
  // compiler from holding all 24 of them in registers across stages.
  auto load = [&](int k0) {
    const bool in = k0 + sk < m;
    const T* p = qtile + (off + k0);
#pragma unroll
    for (int i = 0; i < kQTile / 8; ++i, p += step) {
      asm volatile("" : "+l"(p));
      rq[i] = (in && i < vq) ? *p : zero<T>();
    }
    p = xtile + (off + k0);
#pragma unroll
    for (int i = 0; i < kXTile / 8; ++i, p += step) {
      asm volatile("" : "+l"(p));
      rx[i] = (in && i < vx) ? *p : zero<T>();
    }
  };
  auto flush = [&]() {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        uacc[a][b] += __float2uint_rn(facc[a][b]);
        facc[a][b] = 0.f;
      }
  };

  load(0);
  for (int k0 = 0; k0 < m; k0 += kStage) {
    if constexpr (kInt) {
      uint32_t mx = 0;
#pragma unroll
      for (int i = 0; i < kQTile / 8; ++i) mx = max(mx, absdiff(widen(rq[i]), 0u));
#pragma unroll
      for (int i = 0; i < kXTile / 8; ++i) mx = max(mx, absdiff(widen(rx[i]), 0u));
      mx = __reduce_max_sync(0xffffffffu, mx);
      if ((t & 31) == 0) smax[t >> 5] = mx;
    }
    __syncthreads();     // the previous stage's loops are done; smax is whole
    bool wide = false;
    if constexpr (kInt) {
      uint32_t big = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) big = max(big, smax[w]);
      const uint64_t inc = 2ull * big * static_cast<uint64_t>(min(kStage, m - k0));
      if (kWideLoop && inc > kExact) {
        wide = true;
      } else {
        if (bound + inc > kExact) {
          flush();
          bound = 0;
        }
        bound += static_cast<uint32_t>(inc);   // inc <= 2^24 here
      }
    }
#pragma unroll
    for (int i = 0; i < kQTile / 8; ++i) sq[sk][sr + 8 * i] = staged(rq[i], wide);
#pragma unroll
    for (int i = 0; i < kXTile / 8; ++i) sx[sk][sr + 8 * i] = staged(rx[i], wide);
    __syncthreads();
    if (k0 + kStage < m) load(k0 + kStage);   // in flight while this stage runs
    if (kWideLoop && wide) {
      // unrolled 4, not 8: at 8 the int32 kernel spills at 128 registers
#pragma unroll 4
      for (int k = 0; k < kStage; ++k) {
        const uint4 qv = *reinterpret_cast<const uint4*>(&sq[k][ty * 4]);
        const uint4 x0 = *reinterpret_cast<const uint4*>(&sx[k][tx * 4]);
        const uint4 x1 = *reinterpret_cast<const uint4*>(&sx[k][64 + tx * 4]);
        const uint32_t qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const uint32_t xb[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) uacc[a][b] += absdiff(qa[a], xb[b]);
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < kStage; ++k) {
        const float4 qv = *reinterpret_cast<const float4*>(&sq[k][ty * 4]);
        const float4 x0 = *reinterpret_cast<const float4*>(&sx[k][tx * 4]);
        const float4 x1 = *reinterpret_cast<const float4*>(&sx[k][64 + tx * 4]);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float xb[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) facc[a][b] += fabsf(qa[a] - xb[b]);
      }
    }
  }
  if constexpr (kInt) flush();

  using Out = typename Acc<T>::out;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qr = q0 + ty * 4 + a;
    if (qr >= nq) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xr = n0 + 64 * h + tx * 4;
      Out v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if constexpr (kInt) {
          v[b] = static_cast<Out>(uacc[a][4 * h + b]);
        } else {
          v[b] = facc[a][4 * h + b];
        }
      }
      Out* dst = out + static_cast<size_t>(qr) * n + xr;
      if (vec && xr + 3 < n) {
        if constexpr (kInt) {
          *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (xr + b < n) dst[b] = v[b];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
l1_rows_kernel(const T* __restrict__ queries, const T* __restrict__ rows,
               typename Acc<T>::out* __restrict__ out, int c, int m, int chunks) {
  using A = typename Acc<T>::type;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * kRowsPerBlock;
  const int c1 = min(c, c0 + kRowsPerBlock);
  const T* qrow = queries + static_cast<size_t>(q) * m;
  for (int j = c0 + warp; j < c1; j += kRowWarps) {
    const T* row = rows + (static_cast<size_t>(q) * c + j) * m;
    A acc = A(0);
    for (int k = lane; k < m; k += 32) acc += absdiff(widen(row[k]), widen(qrow[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[static_cast<size_t>(q) * c + j] = static_cast<typename Acc<T>::out>(acc);
  }
}

template <typename T>
int launch_pairwise(const void* queries, const void* points, void* out, int nq, int n, int m,
                    void* stream) {
  const dim3 grid((n + kXTile - 1) / kXTile, (nq + kQTile - 1) / kQTile);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  l1_pairwise_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(queries), static_cast<const T*>(points),
      static_cast<typename Acc<T>::out*>(out), nq, n, m, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* queries, const void* rows, void* out, int nq, int c, int m,
                void* stream) {
  const int chunks = (c + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = static_cast<long long>(nq) * chunks;
  l1_rows_kernel<T><<<static_cast<unsigned>(blocks), kRowWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(queries), static_cast<const T*>(rows),
      static_cast<typename Acc<T>::out*>(out), c, m, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every pointer is a contiguous tensor on the card; Q, N, C, m > 0.
#define L1_ENTRIES(SUFFIX, T)                                                          \
  extern "C" int l1_pairwise_##SUFFIX(const void* queries, const void* points, void* out, \
                                      int nq, int n, int m, void* stream) {              \
    return launch_pairwise<T>(queries, points, out, nq, n, m, stream);                   \
  }                                                                                      \
  extern "C" int l1_rows_##SUFFIX(const void* queries, const void* rows, void* out,      \
                                  int nq, int c, int m, void* stream) {                  \
    return launch_rows<T>(queries, rows, out, nq, c, m, stream);                         \
  }

L1_ENTRIES(i32, int32_t)
L1_ENTRIES(i16, int16_t)
L1_ENTRIES(f32, float)
L1_ENTRIES(bf16, __nv_bfloat16)
