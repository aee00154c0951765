// Bucket lookup + compacted candidate gather, for Hopper (sm_90a), as two
// launches: a card-wide extents search and a slot-parallel gather from
// those extents.
//
// Replaces the TPU kernel _probe_kernel / fused_probe_pallas
// (src/repro/kernels/fused_probe.py:110, :158), which searches the sorted
// keys again in VMEM because carrying extents through HBM costs more on the
// TPU.  On the card phase A's extents already sit in device memory, so the
// served gather takes them and does not search at all.
//
// Output contract (both routes, and the JAX package's): for each query and
// each (table, probe), the probed bucket's extent in the table's sorted keys
// clamped to `cap`; the clamped buckets' ids packed to the front of the
// query's (cbucket,) output row in (table, probe, offset) order, the tail
// holding the sentinel n; counts[q] the untruncated total.
//
// fused_probe_extents_launch (phase A, probe_extents_xla's counterpart):
// one thread per (query, table*probe) over the whole card, grid
// (ceil(L*P / 256), Q), so a 64-query batch of 1,600 probes is 102,400
// threads and not 64 blocks.  Each thread runs a lower-bound search over
// exactly n keys (no padded tail, so a probe key of 0xFFFFFFFF counts no pad
// rows and n = 1 needs no special case; n = 0 never launches), then the
// build-time run length occ_from[lo] on a hit or an upper-bound search from
// lo, and writes lo and the raw occupancy.  counts[q] = sum min(occ, cap)
// is a block reduce and one integer atomic a block (exact in any order).
// Bound: latency.  The search is ~log2(n) dependent loads, the top levels
// L2 hits and the bottom ones trips to device memory; the bytes (probe
// keys in, lo and occ out) are a few microseconds' worth.
//
// fused_probe_gather_launch (phase B, compact_gather_xla's counterpart):
// takes lo, the raw occupancies and a cap that may be tighter than the
// extents' (the truncate rung).  Grid (Q, S): each block builds its
// query's exclusive scan of min(occ, cap) in shared memory ((L*P + 1) ints,
// 6.4 KB at L*P = 1,600), then takes interleaved 256-slot chunks of the
// output row, chunks s, s + S, s + 2S, ..., as the split rerank does, so
// buckets of skewed size cannot leave one block holding the wave.  A slot
// finds its bucket by a binary search of the scan in shared memory and
// reads sorted_ids[table * n + lo + offset]: writes are coalesced, reads
// are coalesced within a bucket's run, and the sentinel tail is written the
// same way.  The wrapper picks S from the blocks the card keeps resident
// (SM count and occupancy read from the device), aiming at one wave.
// Bound: bytes: the extents in, the gathered ids in, the (Q, cbucket)
// output row out.  Measured at ~3.7x that bound at the served batch, and a
// variant with 4 id loads in flight a thread and lo in shared memory was
// no faster, so the id load's latency is not what holds it (PERF.md).
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // also the gather's chunk: slots a block takes a step
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;

// First index in keys[0, n) whose key is >= key (lower) or > key (upper).
template <bool kUpper>
__device__ __forceinline__ int search(const long long* __restrict__ keys, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const long long k = keys[mid];
    if (kUpper ? k <= key : k < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
extents_kernel(const long long* __restrict__ sorted_keys, const int* __restrict__ occ_from,
               const long long* __restrict__ probe_keys, int* __restrict__ lo_out,
               int* __restrict__ occ_out, int* __restrict__ counts, int n, int lp, int p,
               int cap) {
  const int q = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  int c = 0;
  if (j < lp) {
    const size_t table_off = static_cast<size_t>(j / p) * n;
    const long long* keys = sorted_keys + table_off;
    const size_t at = static_cast<size_t>(q) * lp + j;
    const long long key = probe_keys[at];
    const int lo = search<false>(keys, n, key);
    int occ;
    if (occ_from != nullptr) {
      occ = (lo < n && keys[lo] == key) ? occ_from[table_off + lo] : 0;
    } else {
      occ = search<true>(keys + lo, n - lo, key);  // the run from lo
    }
    lo_out[at] = lo;
    occ_out[at] = occ;
    c = min(occ, cap);
  }
  __shared__ int part[kWarps];
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
  if (lane == 0) part[threadIdx.x / 32] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = lane < kWarps ? part[lane] : 0;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
    if (lane == 0 && c != 0) atomicAdd(counts + q, c);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ sorted_ids, const int* __restrict__ lo,
              const int* __restrict__ occ, int* __restrict__ out, int* __restrict__ counts,
              int n, int lp, int p, int cap, int cbucket) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  extern __shared__ int start[];  // lp + 1: start[j] of bucket j, start[lp] = total
  const int q = blockIdx.x;
  const int* occ_row = occ + static_cast<size_t>(q) * lp;
  const int* lo_row = lo + static_cast<size_t>(q) * lp;

  // the query's exclusive scan of min(occ, cap): coalesced loads, a serial
  // scan of each thread's run of ceil(lp / 256), a block scan of the runs
  for (int j = threadIdx.x; j < lp; j += kThreads) start[j] = min(__ldg(occ_row + j), cap);
  __syncthreads();
  const int per = (lp + kThreads - 1) / kThreads;
  const int begin = min(threadIdx.x * per, lp);
  const int end = min(begin + per, lp);
  int run = 0;
  for (int j = begin; j < end; ++j) run += start[j];
  int excl, total;
  Scan(scan_tmp).ExclusiveSum(run, excl, total);
  for (int j = begin; j < end; ++j) {
    const int c = start[j];
    start[j] = excl;
    excl += c;
  }
  __syncthreads();
  if (blockIdx.y == 0 && threadIdx.x == 0) counts[q] = total;

  const int limit = min(total, cbucket);
  int* row = out + static_cast<size_t>(q) * cbucket;
  const long long stride = static_cast<long long>(gridDim.y) * kThreads;
  for (long long x = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x; x < cbucket;
       x += stride) {
    int v = n;
    if (x < limit) {
      // the last bucket starting at or before x holds it (an empty bucket
      // shares its start with the next one)
      int a = 0, b = lp - 1;
      while (a < b) {
        const int mid = (a + b + 1) >> 1;
        if (start[mid] <= x) a = mid; else b = mid - 1;
      }
      v = __ldg(sorted_ids + static_cast<size_t>(a / p) * n + __ldg(lo_row + a) +
                (static_cast<int>(x) - start[a]));
    }
    row[x] = v;
  }
}

size_t gather_smem(int lp) { return static_cast<size_t>(lp + 1) * sizeof(int); }

// Lets the gather take more than the default 48 KB of shared memory when a
// query's L*P needs it (up to the device's opt-in limit).
cudaError_t gather_allow(size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// probe_keys (q, lp) int64; lo, occ (q, lp) int32; counts (q,) int32,
// zeroed here on the stream.
extern "C" int fused_probe_extents_launch(const void* sorted_keys, const void* occ_from,
                                          const void* probe_keys, void* lo, void* occ,
                                          void* counts, int q, int n, int lp, int p, int cap,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, static_cast<size_t>(q) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  extents_kernel<<<dim3((lp + kThreads - 1) / kThreads, q), kThreads, 0, st>>>(
      static_cast<const long long*>(sorted_keys), static_cast<const int*>(occ_from),
      static_cast<const long long*>(probe_keys), static_cast<int*>(lo), static_cast<int*>(occ),
      static_cast<int*>(counts), n, lp, p, cap);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the gather for lp the current device keeps resident at once
// (SMs x blocks per SM); < 0 is a CUDA error.
extern "C" int fused_probe_gather_resident(int lp) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = gather_allow(gather_smem(lp))) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_kernel, kThreads,
                                                           gather_smem(lp))) != cudaSuccess) {
    return -static_cast<int>(err);
  }
  return sms * (per_sm > 0 ? per_sm : 1);
}

// lo, occ (q, lp) int32; out (q, cbucket) int32; counts (q,) int32.
extern "C" int fused_probe_gather_launch(const void* sorted_ids, const void* lo, const void* occ,
                                         void* out, void* counts, int q, int n, int lp, int p,
                                         int cap, int cbucket, int slices, void* stream) {
  const size_t smem = gather_smem(lp);
  cudaError_t err = gather_allow(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<dim3(q, slices), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_ids), static_cast<const int*>(lo),
      static_cast<const int*>(occ), static_cast<int*>(out), static_cast<int*>(counts), n, lp,
      p, cap, cbucket);
  return static_cast<int>(cudaGetLastError());
}
