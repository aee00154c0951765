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
// Bound.  Pairwise at the ground-truth shape (64 x 1 M x 128 int32): each
// point row is read once (512 MB) against 3 integer operations (subtract,
// absolute value, add) per query and coordinate, 2.5e10 in all, so the
// operations bound it.  Design: the TPU kernel's sequential m-axis becomes a
// loop inside the block; a block of 256 threads takes 64 queries x 64 points
// and stages a 32-coordinate slice of both tiles in shared memory,
// coordinate-major (one padding column, so the transposing stores have no
// bank conflicts); each thread keeps a 4 x 4 block of sums in registers, so
// 8 shared loads feed 16 |a - b| + acc updates.  Ragged Q, N and m read as
// zeros, which add nothing.
//
// Per-query rows: every candidate row is read once against one query row,
// so bytes bound it.  One warp per candidate row: lanes stride over the m
// coordinates (neighbouring lanes on neighbouring addresses), accumulate,
// and reduce with shuffles in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // queries and points per pairwise block
constexpr int kSlice = 32;     // coordinates staged per step
constexpr int kSide = 16;      // 16 x 16 threads, 4 x 4 outputs each
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

template <typename T>
__global__ void __launch_bounds__(kSide * kSide)
l1_pairwise_kernel(const T* __restrict__ queries, const T* __restrict__ points,
                   typename Acc<T>::out* __restrict__ out, int nq, int n, int m) {
  using A = typename Acc<T>::type;
  __shared__ A sq[kSlice][kTile + 1];
  __shared__ A sx[kSlice][kTile + 1];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int q0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  A acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = A(0);

  for (int k0 = 0; k0 < m; k0 += kSlice) {
    for (int e = threadIdx.x; e < kTile * kSlice; e += kSide * kSide) {
      const int r = e / kSlice, k = k0 + e % kSlice;
      const int qr = q0 + r, xr = n0 + r;
      sq[e % kSlice][r] = (qr < nq && k < m) ? widen(queries[static_cast<size_t>(qr) * m + k]) : A(0);
      sx[e % kSlice][r] = (xr < n && k < m) ? widen(points[static_cast<size_t>(xr) * m + k]) : A(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kSlice; ++k) {
      A qa[4], xb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sq[k][ty + kSide * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) xb[b] = sx[k][tx + kSide * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += absdiff(qa[a], xb[b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qr = q0 + ty + kSide * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int xr = n0 + tx + kSide * b;
      if (qr < nq && xr < n) {
        out[static_cast<size_t>(qr) * n + xr] = static_cast<typename Acc<T>::out>(acc[a][b]);
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
  const dim3 grid((n + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
  l1_pairwise_kernel<T><<<grid, kSide * kSide, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(queries), static_cast<const T*>(points),
      static_cast<typename Acc<T>::out*>(out), nq, n, m);
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
