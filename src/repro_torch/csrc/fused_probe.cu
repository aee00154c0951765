// Fused bucket lookup + compacted candidate gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel _probe_kernel / fused_probe_pallas
// (src/repro/kernels/fused_probe.py:110, :158).  For each query and each
// (table, probe): the extent of the probed bucket in the table's sorted keys,
// clamped to `cap`; the clamped buckets' ids are packed to the front of the
// query's (cbucket,) output row in (table, probe, offset) order and the tail
// holds the sentinel n; counts[q] is the untruncated total.  Like the TPU
// kernel it searches from the probe keys and takes no phase-A extents.
//
// Keys are uint32 values carried as int64.  The search runs over exactly n
// keys per table (no padded tail), so a probe key of 0xFFFFFFFF cannot count
// pad rows, and n = 1 needs no special case (n = 0 never launches).
//
// Bound: bytes.  A query moves its L*P probe keys, one key and one run
// length per hit test, and the ids it gathers; the binary search adds
// log2(n) dependent key reads per probe, mostly L2 hits on the top levels.
// Design: one block per query.  Threads take the probes in chunks of the
// block size, in probe order; each runs a lower-bound search in its table and
// reads the bucket's occupancy from the build-time run-length table
// (occ_from[lo] on a hit) or, without one, from an upper-bound search.  A
// block exclusive scan (CUB) gives each probe its output offset, and the
// thread copies its bucket's first min(occ, cap) ids there — a scatter in
// place of the TPU kernel's slot -> segment bisection, with the same bits.
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const long long* __restrict__ keys, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const long long* __restrict__ keys, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void fused_probe_kernel(const long long* __restrict__ sorted_keys,
                                   const int* __restrict__ sorted_ids,
                                   const int* __restrict__ occ_from,  // may be null
                                   const long long* __restrict__ probe_keys,
                                   int* __restrict__ out, int* __restrict__ counts,
                                   int n, int lp, int p, int cap, int cbucket) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  const int q = blockIdx.x;
  const long long* pk = probe_keys + static_cast<size_t>(q) * lp;
  int* row = out + static_cast<size_t>(q) * cbucket;

  int base = 0;  // output offset of the current chunk
  for (int c0 = 0; c0 < lp; c0 += kThreads) {
    const int j = c0 + threadIdx.x;
    int lo = 0, cnt = 0;
    size_t table_off = 0;
    if (j < lp) {
      table_off = static_cast<size_t>(j / p) * n;
      const long long* keys = sorted_keys + table_off;
      const long long key = pk[j];
      lo = lower_bound(keys, n, key);
      int occ;
      if (occ_from != nullptr) {
        occ = (lo < n && keys[lo] == key) ? occ_from[table_off + lo] : 0;
      } else {
        occ = upper_bound(keys, n, key) - lo;
      }
      cnt = min(occ, cap);
    }
    int excl, chunk_total;
    Scan(scan_tmp).ExclusiveSum(cnt, excl, chunk_total);
    __syncthreads();  // scan_tmp is reused by the next chunk
    const int start = base + excl;
    const int stop = min(start + cnt, cbucket);
    const int* ids = sorted_ids + table_off + lo;
    for (int s = start; s < stop; ++s) row[s] = ids[s - start];
    base += chunk_total;
  }
  for (int s = min(base, cbucket) + threadIdx.x; s < cbucket; s += kThreads) row[s] = n;
  if (threadIdx.x == 0) counts[q] = base;
}

}  // namespace

extern "C" int fused_probe_launch(const void* sorted_keys, const void* sorted_ids,
                                  const void* occ_from, const void* probe_keys, void* out,
                                  void* counts, int q, int n, int lp, int p, int cap,
                                  int cbucket, void* stream) {
  fused_probe_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted_keys), static_cast<const int*>(sorted_ids),
      static_cast<const int*>(occ_from), static_cast<const long long*>(probe_keys),
      static_cast<int*>(out), static_cast<int*>(counts), n, lp, p, cap, cbucket);
  return static_cast<int>(cudaGetLastError());
}
