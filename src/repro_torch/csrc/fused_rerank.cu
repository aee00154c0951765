// Fused candidate gather + exact L1 distance + top-k with duplicate
// suppression, for Hopper (sm_90a).
//
// Replaces the TPU kernel _fused_kernel / fused_rerank_pallas
// (src/repro/kernels/fused_rerank.py:78, :140).  Contract: the k
// lex-(dist, id)-smallest pairs over the unique valid candidate ids of each
// query row (an id < 0 or >= n is invalid; ids arrive un-deduplicated),
// ascending; empty slots carry (INT32_MAX/2, -1).
//
// Bound: bytes.  Every valid candidate costs one dataset row (m * 2 or 4
// bytes, a random gather) against a few integer operations per element.
// Design:
//  * one block per query; the query row is staged in shared memory as int32;
//  * each warp takes every kWarps-th candidate; its lanes split the row with
//    16-byte loads (4 int32 or 8 int16 per lane), accumulate |diff| in int32
//    and reduce with shuffles — one warp reads one row as whole 16-byte
//    sectors, so the gather moves no byte it does not use;
//  * selection runs on packed 64-bit keys (dist << 32) | id, which order
//    exactly as (dist, id) since dist < 2^31 and valid ids are >= 0;
//  * each warp keeps a sorted running list of its k best keys in shared
//    memory.  A key >= the list's worst is dropped at once (the common case
//    once the list fills); a key equal to one already listed is a duplicate
//    and is skipped.  This dedup is exact: a later copy of an id has the
//    identical key, and if the first copy left the list (or never entered)
//    the list's worst has only fallen since, so the copy is dropped too;
//  * thread 0 merges the kWarps lists, skipping equal keys again.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kBigDist = 0x7FFFFFFF / 2;

__device__ __forceinline__ int absdiff(int a, int b) { return a > b ? a - b : b - a; }

// L1 distance between one dataset row and the staged query; every lane
// returns the full sum.
template <typename T>
__device__ __forceinline__ int row_l1(const T* __restrict__ row, const int* __restrict__ qs,
                                      int m, int lane, bool vec) {
  int acc = 0;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int nvec = m / kPer;
    const int4* r4 = reinterpret_cast<const int4*>(row);
    for (int v = lane; v < nvec; v += 32) {
      const int4 x = __ldg(r4 + v);
      const T* e = reinterpret_cast<const T*>(&x);
      const int* qv = qs + v * kPer;
#pragma unroll
      for (int u = 0; u < kPer; ++u) acc += absdiff(static_cast<int>(e[u]), qv[u]);
    }
  } else {
    for (int e = lane; e < m; e += 32) acc += absdiff(static_cast<int>(row[e]), qs[e]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <typename T>
__global__ void fused_rerank_kernel(const T* __restrict__ dataset, const int* __restrict__ queries,
                                    const int* __restrict__ ids, int* __restrict__ dout,
                                    int* __restrict__ iout, int n, int m, int ctot, int k,
                                    int vec) {
  extern __shared__ unsigned long long smem[];
  const int q = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned long long* list = smem + warp * k;
  int* qs = reinterpret_cast<int*>(smem + kWarps * k);

  for (int e = threadIdx.x; e < m; e += blockDim.x) qs[e] = queries[static_cast<size_t>(q) * m + e];
  for (int j = lane; j < k; j += 32) list[j] = kEmpty;
  __syncthreads();

  const int* row_ids = ids + static_cast<size_t>(q) * ctot;
  unsigned long long worst = kEmpty;
  for (int c = warp; c < ctot; c += kWarps) {
    const int id = row_ids[c];
    if (id < 0 || id >= n) continue;  // warp-uniform
    const int d = row_l1(dataset + static_cast<size_t>(id) * m, qs, m, lane, vec != 0);
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<unsigned>(d)) << 32) | static_cast<unsigned>(id);
    if (key >= worst) continue;
    bool dup = false;
    for (int j = lane; j < k; j += 32) dup |= (list[j] == key);
    if (__any_sync(0xffffffffu, dup)) continue;
    if (lane == 0) {
      int pos = k - 1;
      while (pos > 0 && list[pos - 1] > key) {
        list[pos] = list[pos - 1];
        --pos;
      }
      list[pos] = key;
    }
    __syncwarp();
    worst = list[k - 1];
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int head[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) head[w] = 0;
    const size_t out = static_cast<size_t>(q) * k;
    unsigned long long prev = kEmpty;
    int filled = 0;
    while (filled < k) {
      unsigned long long best = kEmpty;
      int bw = -1;
      for (int w = 0; w < kWarps; ++w) {
        if (head[w] < k) {
          const unsigned long long v = smem[w * k + head[w]];
          if (v < best) { best = v; bw = w; }
        }
      }
      if (bw < 0) break;  // every list is exhausted or holds only empties
      ++head[bw];
      if (best == prev) continue;
      prev = best;
      dout[out + filled] = static_cast<int>(best >> 32);
      iout[out + filled] = static_cast<int>(best & 0xffffffffu);
      ++filled;
    }
    for (; filled < k; ++filled) {
      dout[out + filled] = kBigDist;
      iout[out + filled] = -1;
    }
  }
}

template <typename T>
int launch(const void* dataset, const void* queries, const void* ids, void* dout, void* iout,
           int q, int n, int m, int ctot, int k, int vec, void* stream) {
  const size_t smem = static_cast<size_t>(kWarps) * k * sizeof(unsigned long long) +
                      static_cast<size_t>(m) * sizeof(int);
  fused_rerank_kernel<T><<<q, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dataset), static_cast<const int*>(queries),
      static_cast<const int*>(ids), static_cast<int*>(dout), static_cast<int*>(iout),
      n, m, ctot, k, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_rerank_i32(const void* dataset, const void* queries, const void* ids,
                                void* dout, void* iout, int q, int n, int m, int ctot, int k,
                                int vec, void* stream) {
  return launch<int32_t>(dataset, queries, ids, dout, iout, q, n, m, ctot, k, vec, stream);
}

extern "C" int fused_rerank_i16(const void* dataset, const void* queries, const void* ids,
                                void* dout, void* iout, int q, int n, int m, int ctot, int k,
                                int vec, void* stream) {
  return launch<int16_t>(dataset, queries, ids, dout, iout, q, n, m, ctot, k, vec, stream);
}
