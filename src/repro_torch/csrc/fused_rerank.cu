// Fused candidate gather + exact L1 distance + top-k with duplicate
// suppression, for Hopper (sm_90a).
//
// Replaces the TPU kernel _fused_kernel / fused_rerank_pallas
// (src/repro/kernels/fused_rerank.py:78, :140).  Contract: the k
// lex-(dist, id)-smallest pairs over the unique valid candidate ids of each
// query row (an id < 0 or >= n is invalid; ids arrive un-deduplicated),
// ascending; empty slots carry (INT32_MAX/2, -1).  The kernel needs every
// valid candidate's int32 distance below INT32_MAX/2 (BIG_DIST): the
// reference ranks a valid candidate at or beyond it after the row's
// invalid and duplicate slots, whose number needs a count of the row's
// distinct ids.  The serving entry points refuse data and queries whose
// coordinate range could reach it (SegmentedIndex.admit_points and
// admit_queries), so they never hand the kernel such a row.
//
// Bound: bytes, and in practice the latency of dependent loads.  Every valid
// candidate costs one dataset row (m * 2 or 4 bytes, a random gather) after
// the load of its id, against a few integer operations per element.  The
// first design (since deleted) ran one block per query, so a 64-query batch
// filled 64 of 132 SMs, and each warp walked its candidates one row at a
// time: two dependent trips to memory per candidate and one 16-byte load
// per lane in flight.  This design:
//  * grid (Q, S): each query's ctot slots are cut into chunks of kThreads
//    (256) slots, and slice s takes chunks s, s + S, s + 2S, ...  Interleaved
//    rather than contiguous slices, because a row's valid ids are packed to
//    its front (the probe compacts them, tail slots hold the sentinel): with
//    contiguous slices the blocks of a row's tail have nothing to do while
//    those of its head hold the wave up.  The wrapper
//    picks S from Q, ctot and the blocks the card keeps resident (SM count
//    and occupancy read from the device, fused_rerank_resident_*), so the
//    grid's equal blocks fill about one wave;
//  * ids a warp at a time: each warp loads 32 ids in one coalesced load (the
//    next 32 are prefetched while these are processed), keeps the valid ones
//    with a ballot and takes them 4 at a time, so each lane has 4 independent
//    16-byte row loads in flight;
//  * each lane reads the same 16-byte vector of every row, so where a row is
//    at most one vector a lane (m <= 128 int32 or 256 int16, the served
//    width) the lane keeps its slice of the query in registers; longer rows
//    and rows that cannot be read as aligned 16-byte vectors read the query
//    from shared memory;
//  * the 4 candidates' partial sums reduce with 6 shuffles instead of 20
//    (halving exchanges at distances 16 and 8, then a butterfly), leaving
//    each candidate's distance in one group of 8 lanes;
//  * selection runs on packed 64-bit keys ((dist ^ 2^31) << 32) | id, which
//    order exactly as (dist, id) for any int32 dist (a wrapped sum is
//    negative and sorts first, as in the reference) since valid ids are
//    >= 0.  Each
//    warp keeps a sorted running list of its k best keys in shared memory.
//    A key >= the list's worst is dropped at once (one ballot decides the
//    common case for all 4 candidates); a key equal to one already listed is
//    a duplicate and is skipped.  This dedup is exact: a later copy of an id
//    has the identical key, and if the first copy left the list (or never
//    entered) the list's worst has only fallen since, so the copy is dropped;
//  * warp 0 merges the block's 8 lists, one list a lane, skipping equal keys,
//    into the slice's k keys: the result itself when S == 1, else a row of a
//    (Q, S, k) int64 workspace that the wrapper allocates;
//  * a second, small launch merges each query's S lists the same way, one
//    warp a query and one list a lane (so S <= 32).  A second launch was
//    chosen over a last-block-done merge in the first: it needs no counters
//    that outlive a call, no fences and no atomics, and costs one dependent
//    launch of a few microseconds against a rerank of a millisecond.  Either
//    way no result is written by an atomic, so the output is deterministic.
//
// Exactness of the split: a key in the global top-k of unique keys has fewer
// than k smaller unique keys anywhere, so fewer than k in any slice that
// holds it, so it is in that slice's list.  Equal keys are the same id (the
// id is the key's low word).  So the union of the slice lists, equal keys
// skipped, first k, equals the top-k of the whole row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;         // candidates a warp has in flight
constexpr int kMaxSlices = 32;     // the slice merge gives each list a lane
constexpr int kMergeWarps = 4;     // queries a block of the slice merge takes
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kBigDist = 0x7FFFFFFF / 2;

// How a block reads a row: kRegVec, one aligned 16-byte vector a lane with
// the lane's slice of the query in registers; kSharedVec, aligned vectors
// with the query in shared memory (longer rows); kScalar, one element a lane
// per step (m not a multiple of the vector width, or an unaligned base).
constexpr int kRegVec = 1;
constexpr int kSharedVec = 0;
constexpr int kScalar = -1;

__device__ __forceinline__ int absdiff(int a, int b) { return a > b ? a - b : b - a; }

__device__ __forceinline__ int word(const int4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Element w (a compile-time index) of a 16-byte vector of T, widened to int.
template <typename T>
__device__ __forceinline__ int elem(const int4& x, int w);
template <>
__device__ __forceinline__ int elem<int32_t>(const int4& x, int w) { return word(x, w); }
template <>
__device__ __forceinline__ int elem<int16_t>(const int4& x, int w) {
  const int wd = word(x, w >> 1);
  return (w & 1) ? (wd >> 16) : static_cast<int>(static_cast<int16_t>(wd & 0xffff));
}

// The sign bit of d is flipped so that unsigned keys order as signed
// distances: a wrapped (negative) int32 sum sorts first, as in the
// reference.  An empty slot (all ones) stays above every key, whose id word
// is below 2^31 - 1.
constexpr unsigned kSignFlip = 0x80000000u;

__device__ __forceinline__ unsigned long long make_key(int d, int id) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(d) ^ kSignFlip) << 32) |
         static_cast<unsigned>(id);
}

__device__ __forceinline__ int key_dist(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key >> 32) ^ kSignFlip);
}

// Per-lane partial L1 sums of up to kUnroll candidate rows (cid[u] < 0: no
// row; its sum is garbage and ignored) against the query.
template <typename T, int MODE>
__device__ __forceinline__ void partial_l1(const T* __restrict__ dataset, const int (&cid)[kUnroll],
                                           const int* qr, const int* __restrict__ qs, int m,
                                           int lane, int (&acc)[kUnroll]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = 0;
  if constexpr (MODE == kRegVec) {
    const bool live = lane < m / kPer;  // lanes past the row add |0 - 0|
    int4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int4* r4 = reinterpret_cast<const int4*>(
          dataset + static_cast<size_t>(cid[u] < 0 ? 0 : cid[u]) * m);
      x[u] = (cid[u] >= 0 && live) ? __ldg(r4 + lane) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int w = 0; w < kPer; ++w) acc[u] += absdiff(elem<T>(x[u], w), qr[w]);
  } else if constexpr (MODE == kSharedVec) {
    const int nvec = m / kPer;
    const int4* r4[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      r4[u] = reinterpret_cast<const int4*>(dataset + static_cast<size_t>(cid[u] < 0 ? 0 : cid[u]) * m);
    for (int v = lane; v < nvec; v += 32) {
      int4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = cid[u] >= 0 ? __ldg(r4[u] + v) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int w = 0; w < kPer; ++w) {
        const int qv = qs[v * kPer + w];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u] += absdiff(elem<T>(x[u], w), qv);
      }
    }
  } else {
    const T* row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) row[u] = dataset + static_cast<size_t>(cid[u] < 0 ? 0 : cid[u]) * m;
    for (int e = lane; e < m; e += 32) {
      int x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = cid[u] >= 0 ? static_cast<int>(__ldg(row[u] + e)) : 0;
      const int qv = qs[e];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] += absdiff(x[u], qv);
    }
  }
}

// Reduce the 4 candidates' partial sums over the warp with 6 shuffles; lane
// L returns the full distance of candidate L >> 3.  Integer adds wrap, so
// the order of the sum changes no bit.
__device__ __forceinline__ int reduce4(const int (&acc)[kUnroll], int lane) {
  const bool hi16 = lane & 16;   // keeps candidates 2, 3 (else 0, 1)
  int k0 = hi16 ? acc[2] : acc[0];
  int k1 = hi16 ? acc[3] : acc[1];
  k0 += __shfl_xor_sync(kFull, hi16 ? acc[0] : acc[2], 16);
  k1 += __shfl_xor_sync(kFull, hi16 ? acc[1] : acc[3], 16);
  const bool hi8 = lane & 8;     // keeps the odd candidate of the pair
  int d = hi8 ? k1 : k0;
  d += __shfl_xor_sync(kFull, hi8 ? k0 : k1, 8);
  d += __shfl_xor_sync(kFull, d, 4);
  d += __shfl_xor_sync(kFull, d, 2);
  d += __shfl_xor_sync(kFull, d, 1);
  return d;
}

// Insert key into the warp's sorted list of k keys unless it is already
// there (warp-uniform key); returns the list's new worst.
__device__ __forceinline__ unsigned long long insert_key(unsigned long long* list, int k,
                                                         unsigned long long key, int lane,
                                                         unsigned long long worst) {
  bool dup = false;
  for (int j = lane; j < k; j += 32) dup |= (list[j] == key);
  if (__any_sync(kFull, dup)) return worst;
  if (lane == 0) {
    int pos = k - 1;
    while (pos > 0 && list[pos - 1] > key) {
      list[pos] = list[pos - 1];
      --pos;
    }
    list[pos] = key;
  }
  __syncwarp();
  return list[k - 1];
}

// One warp merges nlists sorted lists of unique keys (list j at lists + j*k,
// empties last; lane j < nlists owns list j) into their first k unique keys:
// each round the warp's least head is the next key, and every lane whose
// head equals it advances, so a key held by several lists is taken once.
// Writes keys to keys_out, or (dist, id) pairs to dout/iout when keys_out is
// null, with (BIG, -1) for empty slots.
__device__ void warp_merge(const unsigned long long* lists, int nlists, int k, int lane,
                           unsigned long long* keys_out, int* dout, int* iout) {
  const unsigned long long* mine = lists + static_cast<size_t>(lane < nlists ? lane : 0) * k;
  int head = 0;
  unsigned long long cur = lane < nlists ? mine[0] : kEmpty;
  int r = 0;
  for (; r < k; ++r) {
    unsigned long long best = cur;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, best, off);
      best = o < best ? o : best;
    }
    if (best == kEmpty) break;  // warp-uniform
    if (lane == 0) {
      if (keys_out) {
        keys_out[r] = best;
      } else {
        dout[r] = key_dist(best);
        iout[r] = static_cast<int>(best & 0xffffffffu);
      }
    }
    if (cur == best) {
      ++head;
      cur = head < k ? mine[head] : kEmpty;
    }
  }
  for (int j = r + lane; j < k; j += 32) {
    if (keys_out) {
      keys_out[j] = kEmpty;
    } else {
      dout[j] = kBigDist;
      iout[j] = -1;
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
rerank_slice_kernel(const T* __restrict__ dataset, const int* __restrict__ queries,
                    const int* __restrict__ ids, unsigned long long* __restrict__ work,
                    int* __restrict__ dout, int* __restrict__ iout, int n, int m, int ctot,
                    int k) {
  constexpr int kPer = 16 / sizeof(T);
  extern __shared__ unsigned long long smem[];
  const int q = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned long long* list = smem + warp * k;
  int* qs = reinterpret_cast<int*>(smem + kWarps * k);

  const int* qrow = queries + static_cast<size_t>(q) * m;
  int qr[kPer];
  if constexpr (MODE == kRegVec) {
#pragma unroll
    for (int w = 0; w < kPer; ++w) qr[w] = lane * kPer + w < m ? __ldg(qrow + lane * kPer + w) : 0;
  } else {
    for (int e = threadIdx.x; e < m; e += kThreads) qs[e] = qrow[e];
  }
  for (int j = lane; j < k; j += 32) list[j] = kEmpty;
  __syncthreads();

  // this slice's chunks: s, s + S, ...; warp w reads slots [32w, 32w + 32)
  // of each, the next chunk's ids prefetched while these are processed
  const long long stride = static_cast<long long>(gridDim.y) * kThreads;
  const int* row_ids = ids + static_cast<size_t>(q) * ctot;
  unsigned long long worst = kEmpty;
  long long pos = static_cast<long long>(s) * kThreads + warp * 32 + lane;
  int id_next = pos < ctot ? __ldg(row_ids + pos) : -1;
  for (long long base = pos - lane; base < ctot; base += stride) {
    const int id = id_next;
    pos = base + stride + lane;
    id_next = pos < ctot ? __ldg(row_ids + pos) : -1;
    unsigned valid = __ballot_sync(kFull, id >= 0 && id < n);
    while (valid) {  // warp-uniform
      int cid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int got = __shfl_sync(kFull, id, valid ? __ffs(valid) - 1 : 0);
        cid[u] = valid ? got : -1;
        valid &= valid - 1;
      }
      int acc[kUnroll];
      partial_l1<T, MODE>(dataset, cid, qr, qs, m, lane, acc);
      const int d = reduce4(acc, lane);
      const int g = lane >> 3;
      const int my_id = g == 0 ? cid[0] : g == 1 ? cid[1] : g == 2 ? cid[2] : cid[3];
      const unsigned long long key = make_key(d, my_id);
      unsigned pass = __ballot_sync(kFull, (lane & 7) == 0 && my_id >= 0 && key < worst);
      while (pass) {  // rare once the list is full
        const int src = __ffs(pass) - 1;
        pass &= pass - 1;
        const unsigned long long kb = __shfl_sync(kFull, key, src);
        if (kb < worst) worst = insert_key(list, k, kb, lane, worst);
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    const size_t out = static_cast<size_t>(q) * k;
    if (gridDim.y == 1) {
      warp_merge(smem, kWarps, k, lane, nullptr, dout + out, iout + out);
    } else {
      warp_merge(smem, kWarps, k, lane,
                 work + (static_cast<size_t>(q) * gridDim.y + s) * k, nullptr, nullptr);
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
merge_slices_kernel(const unsigned long long* __restrict__ work, int* __restrict__ dout,
                    int* __restrict__ iout, int q, int slices, int k) {
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (row >= q) return;  // warp-uniform; the kernel has no block barrier
  const size_t out = static_cast<size_t>(row) * k;
  warp_merge(work + static_cast<size_t>(row) * slices * k, slices, k, threadIdx.x % 32,
             nullptr, dout + out, iout + out);
}

template <typename T>
using SliceKernel = void (*)(const T*, const int*, const int*, unsigned long long*, int*, int*,
                             int, int, int, int);

template <typename T>
SliceKernel<T> pick(int m, int vec) {
  constexpr int kPer = 16 / sizeof(T);
  if (!vec) return rerank_slice_kernel<T, kScalar>;
  if (m / kPer <= 32) return rerank_slice_kernel<T, kRegVec>;
  return rerank_slice_kernel<T, kSharedVec>;
}

size_t smem_bytes(int m, int k) {
  return static_cast<size_t>(kWarps) * k * sizeof(unsigned long long) +
         static_cast<size_t>(m) * sizeof(int);
}

// Blocks of the slice kernel for (m, k, vec) the current device keeps
// resident at once (SMs x blocks per SM); < 0 is a CUDA error.
template <typename T>
int resident(int m, int k, int vec) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick<T>(m, vec), kThreads,
                                                           smem_bytes(m, k))) != cudaSuccess) {
    return -static_cast<int>(err);
  }
  return sms * (per_sm > 0 ? per_sm : 1);
}

// ids (q, ctot) int32 and queries (q, m) int32 contiguous; work holds
// (q, slices, k) int64 when slices > 1.
template <typename T>
int launch(const void* dataset, const void* queries, const void* ids, void* work, void* dout,
           void* iout, int q, int n, int m, int ctot, int k, int vec, int slices, void* stream) {
  if (slices < 1 || slices > kMaxSlices || (slices > 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pick<T>(m, vec)<<<dim3(q, slices), kThreads, smem_bytes(m, k), st>>>(
      static_cast<const T*>(dataset), static_cast<const int*>(queries),
      static_cast<const int*>(ids), static_cast<unsigned long long*>(work),
      static_cast<int*>(dout), static_cast<int*>(iout), n, m, ctot, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  merge_slices_kernel<<<(q + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, st>>>(
      static_cast<const unsigned long long*>(work), static_cast<int*>(dout),
      static_cast<int*>(iout), q, slices, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_rerank_resident_i32(int m, int k, int vec) { return resident<int32_t>(m, k, vec); }
extern "C" int fused_rerank_resident_i16(int m, int k, int vec) { return resident<int16_t>(m, k, vec); }

extern "C" int fused_rerank_i32(const void* dataset, const void* queries, const void* ids,
                                void* work, void* dout, void* iout, int q, int n, int m,
                                int ctot, int k, int vec, int slices, void* stream) {
  return launch<int32_t>(dataset, queries, ids, work, dout, iout, q, n, m, ctot, k, vec, slices,
                         stream);
}

extern "C" int fused_rerank_i16(const void* dataset, const void* queries, const void* ids,
                                void* work, void* dout, void* iout, int q, int n, int m,
                                int ctot, int k, int vec, int slices, void* stream) {
  return launch<int16_t>(dataset, queries, ids, work, dout, iout, q, n, m, ctot, k, vec, slices,
                         stream);
}
