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
//
// The windowed path (one cooperative launch, rerank_slice_kernel<T, MODE,
// kWindowed>).  The sliced grid above reads a dataset row from device
// memory once for every (query, slot) pair that names it: at a batch of
// 1,024 queries over 1 M rows of 3,840 bytes each row is named ~52 times,
// and the blocks walk their own queries' slots in probe order, so a row's
// next read comes ~1 M row reads later, long after the 50 MB L2 has let it
// go.  That path runs at the card's HBM rate over the pairs' bytes.  The
// windowed path cuts the row ids into windows of R = 2^shift rows whose
// bytes fit a share of L2, and has the whole batch read window w's rows
// while they are there, in three phases split by grid-wide barriers:
//  1. partition in place: each (query, chunk of kPart slots) is loaded into
//     shared memory and counting-sorted by window (id >> shift); the valid
//     ids are written back to the chunk's front grouped by window, a slot
//     past them that held a valid id gets -1, so each row keeps its
//     multiset of valid ids (the caller's ids are reordered: the served
//     path's last use of them), and the (q, chunks, windows + 1) uint16
//     bin offsets go to the workspace; the same pass empties each query's
//     running list;
//  2. (query, window) items by an atomic ticket in window-major order, so
//     the resident blocks work on at most about two adjacent windows
//     whatever the dispatch order: a block gathers its item's ids from the
//     chunks' segments into shared memory and runs the sliced path's
//     device code over them (partial_l1, reduce4, the per-warp lists with
//     insert_key's exact dedup), with the query's running list's worst key
//     as the starting bound; then, under the query's lock, warp 0 merges
//     its 8 lists and the running list into the running list (warp_merge);
//  3. each query's running list becomes its (dist, id) pairs.
// Exactness: an id lies in one window, so every copy of it meets in one
// item, where the sliced path's dedup holds; a key of the global top-k is
// below any k unique keys' worst, so no bound drops it; the merges take
// the first k unique keys of a union, in any order, so the lock orders the
// work but decides nothing, and the result is the sliced path's bit for
// bit.  Bound: the HBM bytes of the distinct rows (each read about once a
// batch) and the L2 bytes of the pairs (every pair's row from L2), with
// the INT32 issue of |x - q| below both.  At 1,024 queries x 50,600 valid
// slots over 1 M rows of 3,840 bytes it takes 26.4 ms against the sliced
// path's 63.6 (the pairs' 199 GB at 7.5 TB/s, the distinct rows' 3.8 GB
// once); over 50 M rows of 512 bytes, 139,773 valid slots a query, 16.7
// ms against 26.1, where a row is named only ~3 times a batch and the
// gain is mostly the window's locality in device memory.  The rule that
// picks it (fused_rerank.plan_windows): the batch's expected reuse, Q x
// ctot / n slots a row, at or above WINDOW_REUSE_MIN (the sliced path won
// at 0.17-0.34, the windowed one from 0.67 up; the rule keeps a margin);
// windows of the largest power of two of rows within Q / 2G of
// the L2 for G resident blocks (they work on about G / Q windows at once),
// between an eighth and half of it, doubled while the offsets pass the
// workspace limit; and at least two windows.
//
// The grouped item (rerank_slice_kernel<T, MODE, kGrouped>, the same one
// cooperative launch with blocks of kGroupThreads).  The (query, window)
// item above still reads every (query, row) pair's row from L2: at gist1m's
// shape (a row named ~52 times a batch) 199 GB a batch, which is what bounds
// it.  A grouped item is (G consecutive queries, window w): the block stages
// the G queries in shared memory (Hopper's opt-in, up to 227 KB), every id of
// the G queries' window-w segments sets bit j of its row's 64-bit mask
// (query j of the group), and warp v takes the named rows v, v + 16, ...:
// it loads the row once into registers (one row ahead, so the next row's
// loads fly while this one is computed) and sums |x - q| (__sad, one
// VABSDIFF a value) against each query the mask names, up to 4 a round,
// reduced like the sliced path's 4 candidates.  Keys go into the group's
// per-query lists in shared memory under a per-query lock, with the same
// insert_key and the cut min(list worst, the running list's worst when the
// item began); at the item's end each query's list merges into its running
// list under the query's lock, as above.  Exactness: the mask takes each
// (query, id) pair once, so a query's repeats of an id are computed once;
// an id lies in one window, so all its copies for a query meet in one item;
// the cut only drops keys no better than k unique ones; the merges take the
// first k unique keys of a union in any order; so the result is the sliced
// path's bit for bit (the wrapped sums included: adds wrap alike).  Bound:
// a row load now serves the pairs its mask names (the reuse, pairs / row
// loads, 2.56 at gist1m's batch against 1), and the item is held by its row
// loads: one row in flight a warp, 16 warps an SM (the queries leave room
// for one block), so its time follows the row loads and not the pairs'
// bytes.  At gist1m's batch (1,024 x 50,600 valid slots over 1 M rows of
// 3,840 bytes) 18.2 ms against 29.2 for (query, window) items; at 480 to
// 2,048-byte rows it wins only where a row is reused often, and on int16
// rows it loses (the (query, window) path reads half the bytes; PERF.md
// section 6), so only int32 rows are built grouped and launch_window
// refuses a group on int16 rows.  The rule (fused_rerank.plan_group):
// int32 rows of at least GROUP_ROW_BYTES_MIN bytes, G the most queries
// whose block fits the opt-in shared memory at windows of kGroupRowsMax
// rows (at most 64, the mask), and the expected bytes a row load saves,
// r(G) x row bytes with r(G) = G p / (1 - (1 - p)^G) and p = ctot / n, at
// least WINDOW_GROUP_BYTES (p counts slots, padding included: the
// threshold was read at a slot fill of about 39%).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;         // candidates a warp has in flight
constexpr int kMaxSlices = 32;     // the slice merge gives each list a lane
constexpr int kMergeWarps = 4;     // queries a block of the slice merge takes
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kBigDist = 0x7FFFFFFF / 2;
// The windowed path: kPart slots a partition chunk (sorted in shared
// memory; a bin offset fits 16 bits), at most kMaxWindows windows and
// kMaxChunks chunks a row.  fused_rerank.py's WINDOW_PART, MAX_WINDOWS and
// MAX_WINDOW_CHUNKS are these.
constexpr int kWindowed = 2;
constexpr int kPart = 8192;
constexpr int kMaxWindows = 2048;
constexpr int kMaxChunks = 64;
// The grouped item (kGrouped): at most kGroupMax queries an item (a row's
// queries are one 64-bit mask), kGroupRowsMax rows a window (their masks sit
// in shared memory) and kGroupElems values a lane holds of a row (rows of at
// most 32 x 32 values).  fused_rerank.py's WINDOW_GROUP_MAX, GROUP_ROWS_MAX,
// GROUP_DIM_MAX and GROUP_WARPS are these.
constexpr int kGrouped = 3;
constexpr int kGroupThreads = 512;  // a grouped block: 16 warps share its queries
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kGroupMax = 64;
constexpr int kGroupRowsMax = 4096;
constexpr int kGroupElems = 32;

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

// The windowed path's arguments; the workspace holds lists, locks, ticket
// and offsets in that order (fused_rerank.window_workspace_bytes).
template <typename T>
struct Window {
  const T* dataset;
  const int* queries;
  int* ids;                    // (q, ctot), reordered in place
  int* dout;
  int* iout;
  unsigned long long* lists;   // (q, k) running lists of keys
  int* locks;                  // (q) 1 while a block merges into the list
  unsigned* ticket;            // the next (group, window) item
  unsigned short* offsets;     // (q, chunks, windows + 1) bin starts
  unsigned long long* stats;   // 6 words: row loads, pairs, four timer stamps
  int q, n, m, ctot, k, shift, windows, chunks, group;
};

// The launch's 6 stats words (fused_rerank.py's STATS_WORDS): the rows
// phase 2 loaded and the (query, row) pairs it computed, summed over its
// items; block 0's %globaltimer (ns) at the start, at each grid barrier and
// at its end.

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Exclusive prefix sums of v[0, count) in place by a block of NT threads;
// returns the total.  Ends with a barrier.
template <int NT>
__device__ int block_exclusive_scan(int* v, int count, int* wsum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (count + NT - 1) / NT;
  const int lo = threadIdx.x * per;
  int own = 0;
  for (int j = 0; j < per; ++j) own += lo + j < count ? v[lo + j] : 0;
  int inc = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int run = inc - own, total = 0;
#pragma unroll
  for (int j = 0; j < NT / 32; ++j) {
    run += j < warp ? wsum[j] : 0;
    total += wsum[j];
  }
  for (int j = 0; j < per && lo + j < count; ++j) {
    const int x = v[lo + j];
    v[lo + j] = run;
    run += x;
  }
  __syncthreads();
  return total;
}

// Phase 1 for one (row, chunk) by a block of NT threads: counting sort of
// the chunk's valid ids by window, in place; the bin starts and the valid
// count to the offsets.
template <typename T, int NT>
__device__ void partition_chunk(const Window<T>& a, int row, int c, int* buf, int* hist,
                                int* wsum) {
  int* ids = a.ids + static_cast<size_t>(row) * a.ctot + static_cast<size_t>(c) * kPart;
  const int len = min(kPart, a.ctot - c * kPart);
  for (int i = threadIdx.x; i < len; i += NT) buf[i] = ids[i];
  for (int b = threadIdx.x; b < a.windows; b += NT) hist[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += NT) {
    const int id = buf[i];
    if (id >= 0 && id < a.n) atomicAdd(hist + (id >> a.shift), 1);
  }
  __syncthreads();
  const int total = block_exclusive_scan<NT>(hist, a.windows, wsum);
  unsigned short* off =
      a.offsets + (static_cast<size_t>(row) * a.chunks + c) * (a.windows + 1);
  for (int b = threadIdx.x; b < a.windows; b += NT) off[b] = static_cast<unsigned short>(hist[b]);
  if (threadIdx.x == 0) off[a.windows] = static_cast<unsigned short>(total);
  __syncthreads();  // the offsets are read from hist before it turns into cursors
  for (int i = threadIdx.x; i < len; i += NT) {
    const int id = buf[i];
    if (id >= 0 && id < a.n) {
      ids[atomicAdd(hist + (id >> a.shift), 1)] = id;  // a slot below total
      if (i >= total) ids[i] = -1;                      // a slot past them
    }
  }
  __syncthreads();  // buf and hist serve the next chunk
}

// Phase 2 for one (row, window) item; see the note at the top.
template <typename T, int MODE>
__device__ void rerank_item(const Window<T>& a, int row, int w, unsigned long long* smem,
                            int* qs, int* sid, int* seg_start, int* seg_pre, int* s_total) {
  constexpr int kPer = 16 / sizeof(T);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k = a.k;
  if (warp == 0) {
    // the item's segment in each chunk, the empty ones dropped: its start
    // in the row and its first position in the item's concatenated ids
    const unsigned short* off =
        a.offsets + static_cast<size_t>(row) * a.chunks * (a.windows + 1) + w;
    int run = 0, nseg = 0;
    for (int c0 = 0; c0 < a.chunks; c0 += 32) {
      const int c = c0 + lane;
      int lo = 0, len = 0;
      if (c < a.chunks) {
        const unsigned short* o = off + static_cast<size_t>(c) * (a.windows + 1);
        lo = __ldcg(o);
        len = static_cast<int>(__ldcg(o + 1)) - lo;
      }
      int inc = len;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += o;
      }
      const unsigned busy = __ballot_sync(kFull, len > 0);
      if (len > 0) {
        const int slot = nseg + __popc(busy & ((1u << lane) - 1u));
        seg_start[slot] = c * kPart + lo;
        seg_pre[slot] = run + inc - len;
      }
      run += __shfl_sync(kFull, inc, 31);
      nseg += __popc(busy);
    }
    if (lane == 0) {
      seg_pre[nseg] = run;
      s_total[0] = nseg;
      s_total[1] = run;
    }
  }
  const unsigned long long bound = __ldcg(a.lists + static_cast<size_t>(row) * k + k - 1);
  const int* qrow = a.queries + static_cast<size_t>(row) * a.m;
  int qr[kPer];
  if constexpr (MODE == kRegVec) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) qr[e] = lane * kPer + e < a.m ? __ldg(qrow + lane * kPer + e) : 0;
  } else {
    for (int e = threadIdx.x; e < a.m; e += kThreads) qs[e] = __ldg(qrow + e);
  }
  unsigned long long* list = smem + warp * k;
  for (int j = lane; j < k; j += 32) list[j] = kEmpty;
  __syncthreads();
  const int nseg = s_total[0];
  const int total = s_total[1];
  const int* row_ids = a.ids + static_cast<size_t>(row) * a.ctot;
  unsigned long long worst = bound;
  for (int b0 = 0; b0 < total; b0 += kPart) {
    const int nb = min(kPart, total - b0);
    for (int p = threadIdx.x; p < nb; p += kThreads) {
      const int at = b0 + p;
      int lo = 0, hi = nseg - 1;  // the last segment starting at or before at
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (seg_pre[mid] <= at) lo = mid; else hi = mid - 1;
      }
      sid[p] = __ldcg(row_ids + seg_start[lo] + (at - seg_pre[lo]));
    }
    __syncthreads();
    // round r: warp w takes the item's ids 32r + 4w .. 32r + 4w + 3
    for (int base = kUnroll * warp; base < nb; base += kUnroll * kWarps) {
      int cid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cid[u] = base + u < nb ? sid[base + u] : -1;
      int acc[kUnroll];
      partial_l1<T, MODE>(a.dataset, cid, qr, qs, a.m, lane, acc);
      const int d = reduce4(acc, lane);
      const int g = lane >> 3;
      const int my_id = g == 0 ? cid[0] : g == 1 ? cid[1] : g == 2 ? cid[2] : cid[3];
      const unsigned long long key = make_key(d, my_id);
      unsigned pass = __ballot_sync(kFull, (lane & 7) == 0 && my_id >= 0 && key < worst);
      while (pass) {
        const int src = __ffs(pass) - 1;
        pass &= pass - 1;
        const unsigned long long kb = __shfl_sync(kFull, key, src);
        if (kb < worst) {
          const unsigned long long last = insert_key(list, k, kb, lane, worst);
          worst = last < bound ? last : bound;
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    const bool found = lane < kWarps && smem[lane * k] != kEmpty;
    if (__any_sync(kFull, found)) {
      unsigned long long* run_list = a.lists + static_cast<size_t>(row) * k;
      if (lane == 0) {
        while (atomicCAS(a.locks + row, 0, 1) != 0) __nanosleep(64);
      }
      __syncwarp();
      __threadfence();
      for (int j = lane; j < k; j += 32) smem[kWarps * k + j] = __ldcg(run_list + j);
      __syncwarp();
      warp_merge(smem, kWarps + 1, k, lane, run_list, nullptr, nullptr);
      __threadfence();
      __syncwarp();
      if (lane == 0) atomicExch(a.locks + row, 0);
    }
  }
}

// Byte offsets of a grouped item's shared memory (fused_rerank.py's
// group_smem_bytes sums the same): the group's lists (G, k) and cut (G)
// keys, each warp's merge scratch (2k keys), the window's row masks (rows),
// the group's queries (G, m), the list locks, the segments' starts and
// prefix sums (G * chunks), the scan's warp sums.
struct GroupLayout {
  size_t cut, scratch, mask, qs, lock, seg_start, seg_pre, wsum, bytes;
};

__host__ __device__ inline GroupLayout group_layout(int m, int k, int g, int rows, int chunks) {
  GroupLayout l;
  const size_t segs = static_cast<size_t>(g) * chunks;
  size_t b = sizeof(unsigned long long) * static_cast<size_t>(g) * k;
  l.cut = b;
  b += sizeof(unsigned long long) * g;
  l.scratch = b;
  b += sizeof(unsigned long long) * kGroupWarps * 2 * k;
  l.mask = b;
  b += sizeof(unsigned long long) * rows;
  b = (b + 15) & ~static_cast<size_t>(15);
  l.qs = b;
  b += sizeof(int) * static_cast<size_t>(g) * m;
  l.lock = b;
  b += sizeof(int) * g;
  l.seg_start = b;
  b += sizeof(int) * segs;
  l.seg_pre = b;
  b += sizeof(int) * (segs + 1);
  l.wsum = b;
  b += sizeof(int) * kGroupWarps;
  l.bytes = b;
  return l;
}

// A lane's part of the row a warp holds in a grouped item: one 16-byte
// vector (kRegVec), NR vectors (kSharedVec) or 32 values (kScalar) of it,
// NE values kept as int in registers.
template <typename T, int MODE>
struct Held {
  static constexpr int kPer = 16 / sizeof(T);
  static constexpr int NR = MODE == kRegVec ? 1 : MODE == kSharedVec ? kGroupElems / kPer
                                                                       : kGroupElems;
  static constexpr int NE = MODE == kScalar ? kGroupElems : NR * kPer;
  using Raw = typename std::conditional<MODE == kScalar, T, int4>::type;
};

// Issue the loads of row `row` (< 0: none); they land in raw.
template <typename T, int MODE>
__device__ __forceinline__ void load_held(const T* __restrict__ dataset, int row, int m, int lane,
                                          typename Held<T, MODE>::Raw (&raw)[Held<T, MODE>::NR]) {
  using H = Held<T, MODE>;
  const T* base = dataset + static_cast<size_t>(row < 0 ? 0 : row) * m;
  if constexpr (MODE == kScalar) {
#pragma unroll
    for (int i = 0; i < H::NR; ++i) {
      const int e = i * 32 + lane;
      raw[i] = (row >= 0 && e < m) ? __ldg(base + e) : T(0);
    }
  } else {
    const int nvec = m / H::kPer;
    const int4* r4 = reinterpret_cast<const int4*>(base);
#pragma unroll
    for (int i = 0; i < H::NR; ++i) {
      const int v = i * 32 + lane;
      raw[i] = (row >= 0 && v < nvec) ? __ldg(r4 + v) : make_int4(0, 0, 0, 0);
    }
  }
}

// The held values as int.
template <typename T, int MODE>
__device__ __forceinline__ void unpack_held(const typename Held<T, MODE>::Raw (&raw)[Held<T, MODE>::NR],
                                            int (&x)[Held<T, MODE>::NE]) {
  using H = Held<T, MODE>;
#pragma unroll
  for (int i = 0; i < H::NR; ++i) {
    if constexpr (MODE == kScalar) {
      x[i] = static_cast<int>(raw[i]);
    } else {
#pragma unroll
      for (int w = 0; w < H::kPer; ++w) x[i * H::kPer + w] = elem<T>(raw[i], w);
    }
  }
}

// The lane's L1 sums of C pairs: the held row against queries jq[0, C) of
// the group (shared memory), over the values the lane holds; each value
// costs one __sad (|x - q| + acc, a single VABSDIFF), where absdiff takes
// three operations.  C is the round's pair count, so no load or operation
// is spent on a pair the round does not have, and the C sums are
// independent chains.  Adds wrap, so every bit is the sliced path's.
template <typename T, int MODE, int C>
__device__ __forceinline__ void pair_l1(const int (&x)[Held<T, MODE>::NE], const int (&jq)[kUnroll],
                                          const int* qs, int m, int lane, int (&acc)[kUnroll]) {
  using H = Held<T, MODE>;
  const int* q[C];
#pragma unroll
  for (int t = 0; t < C; ++t) q[t] = qs + jq[t] * m;
  if constexpr (MODE == kScalar) {
#pragma unroll
    for (int i = 0; i < H::NR; ++i) {
      if (i * 32 >= m) break;  // warp-uniform
      const int e = i * 32 + lane;
      if (e < m) {
#pragma unroll
        for (int t = 0; t < C; ++t) acc[t] = __sad(x[i], q[t][e], acc[t]);
      }
    }
  } else {
    const int nvec = m / H::kPer;
#pragma unroll
    for (int i = 0; i < H::NR; ++i) {
      if (i * 32 >= nvec) break;  // warp-uniform
      const int v = i * 32 + lane;
      if (v < nvec) {
#pragma unroll
        for (int h = 0; h < H::kPer / 4; ++h) {
          int4 qv[C];
#pragma unroll
          for (int t = 0; t < C; ++t) qv[t] = reinterpret_cast<const int4*>(q[t] + v * H::kPer)[h];
          const int e = i * H::kPer + 4 * h;
#pragma unroll
          for (int t = 0; t < C; ++t) {
            acc[t] = __sad(x[e], qv[t].x, acc[t]);
            acc[t] = __sad(x[e + 1], qv[t].y, acc[t]);
            acc[t] = __sad(x[e + 2], qv[t].z, acc[t]);
            acc[t] = __sad(x[e + 3], qv[t].w, acc[t]);
          }
        }
      }
    }
  }
}

// Insert key into query j's list of the group under its shared-memory lock,
// unless it is listed or no longer below the list's cut (warp-uniform key
// and j); the cut becomes min(the list's worst, the running list's bound).
__device__ __forceinline__ void insert_locked(unsigned long long* list, unsigned long long* cut,
                                              int* lock, int k, unsigned long long key, int lane) {
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) {
    }
  }
  __syncwarp();
  __threadfence_block();
  const unsigned long long c = *reinterpret_cast<volatile unsigned long long*>(cut);
  if (key < c) {
    const unsigned long long last = insert_key(list, k, key, lane, c);
    if (lane == 0) *cut = last < c ? last : c;
  }
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(lock, 0);
}

// Phase 2 for one (group, window) item of the grouped path, by a block of
// kGroupThreads: see the note at the top.  tally[0] and [1] count the
// warp's row loads and pairs.
template <typename T, int MODE>
__device__ void group_item(const Window<T>& a, int grp, int w, unsigned long long* smem,
                           unsigned long long (&tally)[2]) {
  using H = Held<T, MODE>;
  constexpr int NT = kGroupThreads, NW = kGroupWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k = a.k;
  const int m = a.m;
  const int q0 = grp * a.group;
  const int gq = min(a.group, a.q - q0);
  const int first = w << a.shift;
  const int rows = min(1 << a.shift, a.n - first);
  const int nseg = gq * a.chunks;
  const GroupLayout l = group_layout(m, k, a.group, 1 << a.shift, a.chunks);
  char* base = reinterpret_cast<char*>(smem);
  unsigned long long* lists = smem;
  unsigned long long* cut = reinterpret_cast<unsigned long long*>(base + l.cut);
  unsigned long long* mask = reinterpret_cast<unsigned long long*>(base + l.mask);
  int* qs = reinterpret_cast<int*>(base + l.qs);
  int* lock = reinterpret_cast<int*>(base + l.lock);
  int* seg_start = reinterpret_cast<int*>(base + l.seg_start);
  int* seg_pre = reinterpret_cast<int*>(base + l.seg_pre);

  // 1. empty lists, each query's bound, clear masks; the group's queries;
  // the length and start of each (query, chunk) segment of window w
  for (int i = threadIdx.x; i < gq * k; i += NT) lists[i] = kEmpty;
  for (int j = threadIdx.x; j < gq; j += NT) {
    cut[j] = __ldcg(a.lists + static_cast<size_t>(q0 + j) * k + k - 1);
    lock[j] = 0;
  }
  for (int r = threadIdx.x; r < rows; r += NT) mask[r] = 0ull;
  const int* qsrc = a.queries + static_cast<size_t>(q0) * m;
  if ((m & 3) == 0 && (reinterpret_cast<uintptr_t>(a.queries) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(qsrc);
    int4* d4 = reinterpret_cast<int4*>(qs);
    const int n4 = gq * m / 4;
    int i = threadIdx.x;
    for (; i + 3 * NT < n4; i += 4 * NT) {  // 4 loads in flight
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(s4 + i + u * NT);
#pragma unroll
      for (int u = 0; u < 4; ++u) d4[i + u * NT] = v[u];
    }
    for (; i < n4; i += NT) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < gq * m; i += NT) qs[i] = __ldg(qsrc + i);
  }
  for (int s = threadIdx.x; s < nseg; s += NT) {
    const int j = s / a.chunks, c = s % a.chunks;
    const unsigned short* o =
        a.offsets + (static_cast<size_t>(q0 + j) * a.chunks + c) * (a.windows + 1) + w;
    const int lo = __ldcg(o);
    seg_pre[s] = static_cast<int>(__ldcg(o + 1)) - lo;
    seg_start[s] = c * kPart + lo;
  }
  __syncthreads();
  const int total = block_exclusive_scan<NT>(seg_pre, nseg, reinterpret_cast<int*>(base + l.wsum));

  // 2. every id of the item sets its (row, query) bit: a query's repeats of
  // an id set one bit, so each distinct pair is computed once
  for (int p0 = threadIdx.x; p0 < total; p0 += kUnroll * NT) {  // 4 loads in flight
    int id[kUnroll], jj[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * NT;
      int lo = 0, hi = nseg - 1;  // the last segment starting at or before p
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (seg_pre[mid] <= p) lo = mid; else hi = mid - 1;
      }
      jj[u] = lo / a.chunks;
      id[u] = p < total ? __ldcg(a.ids + static_cast<size_t>(q0 + jj[u]) * a.ctot + seg_start[lo] +
                                 (p - seg_pre[lo]))
                        : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (id[u] >= 0) atomicOr(mask + (id[u] - first), 1ull << jj[u]);
  }
  __syncthreads();

  // 3. warp w takes the named rows among w, w + NW, ..., one at a time, the
  // next one's loads in flight while this one's pairs are computed, up to 4
  // of its queries a round
  int at = warp;  // the first of the 32 candidate rows the ballot covers
  unsigned pend = __ballot_sync(kFull, at + NW * lane < rows && mask[at + NW * lane] != 0ull);
  auto next_row = [&]() -> int {
    while (pend == 0u) {
      at += 32 * NW;
      if (at >= rows) return -1;
      pend = __ballot_sync(kFull, at + NW * lane < rows && mask[at + NW * lane] != 0ull);
    }
    const int i = __ffs(pend) - 1;
    pend &= pend - 1u;
    return at + NW * i;
  };
  int nxt = next_row();
  typename H::Raw raw[H::NR];
  load_held<T, MODE>(a.dataset, nxt < 0 ? -1 : first + nxt, m, lane, raw);
  unsigned loads = 0, pairs = 0;
  while (nxt >= 0) {
    const int cur = nxt;
    const unsigned long long named = mask[cur];
    unsigned lo = static_cast<unsigned>(named), hi = static_cast<unsigned>(named >> 32);
    int x[H::NE];
    unpack_held<T, MODE>(raw, x);
    nxt = next_row();
    load_held<T, MODE>(a.dataset, nxt < 0 ? -1 : first + nxt, m, lane, raw);
    ++loads;
    while (lo | hi) {  // warp-uniform
      int jq[kUnroll], acc[kUnroll] = {0, 0, 0, 0};
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {  // the next named query, lowest first
        const bool low = lo != 0u;
        const unsigned word = low ? lo : hi;
        jq[t] = word ? __ffs(word) - (low ? 1 : -31) : -1;
        const unsigned rest = word & (word - 1u);
        lo = low ? rest : lo;
        hi = low ? hi : rest;
      }
      const int c = 1 + (jq[1] >= 0) + (jq[2] >= 0) + (jq[3] >= 0);
      switch (c) {
        case 1: pair_l1<T, MODE, 1>(x, jq, qs, m, lane, acc); break;
        case 2: pair_l1<T, MODE, 2>(x, jq, qs, m, lane, acc); break;
        case 3: pair_l1<T, MODE, 3>(x, jq, qs, m, lane, acc); break;
        default: pair_l1<T, MODE, 4>(x, jq, qs, m, lane, acc); break;
      }
      pairs += c;
      const int g = lane >> 3;
      const int jg = g == 0 ? jq[0] : g == 1 ? jq[1] : g == 2 ? jq[2] : jq[3];
      const int d = reduce4(acc, lane);
      const unsigned long long key = make_key(d, first + cur);
      unsigned pass = __ballot_sync(
          kFull, (lane & 7) == 0 && jg >= 0 &&
                     key < *reinterpret_cast<volatile unsigned long long*>(cut + (jg < 0 ? 0 : jg)));
      while (pass) {
        const int src = __ffs(pass) - 1;
        pass &= pass - 1;
        const unsigned long long kb = __shfl_sync(kFull, key, src);
        const int jb = __shfl_sync(kFull, jg, src);
        insert_locked(lists + jb * k, cut + jb, lock + jb, k, kb, lane);
      }
    }
  }
  tally[0] += loads;
  tally[1] += pairs;
  __syncthreads();

  // 4. each query's list into its running list, under the query's lock
  for (int j = warp; j < gq; j += NW) {
    if (lists[j * k] == kEmpty) continue;  // warp-uniform
    unsigned long long* run_list = a.lists + static_cast<size_t>(q0 + j) * k;
    unsigned long long* sc = reinterpret_cast<unsigned long long*>(base + l.scratch) + warp * 2 * k;
    if (lane == 0) {
      while (atomicCAS(a.locks + q0 + j, 0, 1) != 0) __nanosleep(64);
    }
    __syncwarp();
    __threadfence();
    for (int i = lane; i < k; i += 32) {
      sc[i] = lists[j * k + i];
      sc[k + i] = __ldcg(run_list + i);
    }
    __syncwarp();
    warp_merge(sc, 2, k, lane, run_list, nullptr, nullptr);
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(a.locks + q0 + j, 0);
  }
}

// Dynamic shared memory of the windowed kernel: phase 1's chunk, bins and
// warp sums, or phase 2's lists (8 warps' and the running one), query,
// gathered ids and segments, whichever is larger.
size_t window_smem_bytes(int m, int k) {
  const size_t part = sizeof(int) * (kPart + kMaxWindows + kWarps);
  const size_t item = sizeof(unsigned long long) * (kWarps + 1) * k +
                      sizeof(int) * (static_cast<size_t>(m) + kPart + 2 * kMaxChunks + 1);
  return part > item ? part : item;
}

// The grouped kernel's: phase 1's or a grouped item's (group_layout).
size_t group_smem_bytes(int m, int k, int g, int rows, int chunks) {
  const size_t part = sizeof(int) * (kPart + kMaxWindows + kGroupWarps);
  const size_t item = group_layout(m, k, g, rows, chunks).bytes;
  return part > item ? part : item;
}

template <typename T, int MODE, int PATH>
__global__ void __launch_bounds__(PATH == kGrouped ? kGroupThreads : kThreads)
    rerank_slice_kernel(const Window<T> a) {
  static_assert(PATH == kWindowed || PATH == kGrouped, "the sliced path has its own kernel above");
  constexpr int NT = PATH == kGrouped ? kGroupThreads : kThreads;
  extern __shared__ unsigned long long smem[];
  __shared__ int s_item[3];  // ticket, then segments and ids of the item
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;
  if (stamp) {
    a.stats[0] = 0ull;
    a.stats[1] = 0ull;
    a.stats[2] = globaltimer();
  }
  const size_t at = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * NT;
  for (size_t i = at; i < static_cast<size_t>(a.q) * a.k; i += stride) a.lists[i] = kEmpty;
  for (size_t i = at; i < static_cast<size_t>(a.q); i += stride) a.locks[i] = 0;
  if (at == 0) *a.ticket = 0u;
  {
    int* buf = reinterpret_cast<int*>(smem);
    for (int t = blockIdx.x; t < a.q * a.chunks; t += gridDim.x)
      partition_chunk<T, NT>(a, t / a.chunks, t % a.chunks, buf, buf + kPart,
                             buf + kPart + kMaxWindows);
  }
  grid.sync();
  if (stamp) a.stats[3] = globaltimer();

  // items in window-major order: item t is (t % groups, t / groups)
  const unsigned groups = PATH == kGrouped ? static_cast<unsigned>((a.q + a.group - 1) / a.group)
                                           : static_cast<unsigned>(a.q);
  const unsigned items = groups * a.windows;
  unsigned long long tally[2] = {0ull, 0ull};  // row loads, pairs
  unsigned next = 0;
  if (threadIdx.x == 0) next = atomicAdd(a.ticket, 1u);
  for (;;) {
    if (threadIdx.x == 0) s_item[0] = static_cast<int>(next);
    __syncthreads();
    const unsigned t = static_cast<unsigned>(s_item[0]);
    if (t >= items) break;
    if (threadIdx.x == 0) next = atomicAdd(a.ticket, 1u);  // the next item's, early
    if constexpr (PATH == kGrouped) {
      group_item<T, MODE>(a, static_cast<int>(t % groups), static_cast<int>(t / groups), smem,
                          tally);
    } else {
      int* qs = reinterpret_cast<int*>(smem + (kWarps + 1) * a.k);
      int* sid = qs + a.m;
      int* seg_start = sid + kPart;
      int* seg_pre = seg_start + kMaxChunks;
      rerank_item<T, MODE>(a, static_cast<int>(t % a.q), static_cast<int>(t / a.q), smem, qs, sid,
                           seg_start, seg_pre, s_item + 1);
      if (threadIdx.x == 0) {  // each id of the item loaded its row for one pair
        tally[0] += static_cast<unsigned>(s_item[2]);
        tally[1] += static_cast<unsigned>(s_item[2]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x % 32 == 0 && tally[1] != 0ull) {
    atomicAdd(a.stats, tally[0]);
    atomicAdd(a.stats + 1, tally[1]);
  }
  grid.sync();
  if (stamp) a.stats[4] = globaltimer();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = blockIdx.x * (NT / 32) + warp; r < a.q; r += gridDim.x * (NT / 32)) {
    for (int j = lane; j < a.k; j += 32) {
      const size_t o = static_cast<size_t>(r) * a.k + j;
      const unsigned long long key = __ldcg(a.lists + o);
      a.dout[o] = key == kEmpty ? kBigDist : key_dist(key);
      a.iout[o] = key == kEmpty ? -1 : static_cast<int>(key & 0xffffffffu);
    }
  }
  if (stamp) a.stats[5] = globaltimer();
}

template <typename T>
using WindowKernel = void (*)(Window<T>);

template <typename T>
WindowKernel<T> pick_window(int m, int vec) {
  constexpr int kPer = 16 / sizeof(T);
  if (!vec) return rerank_slice_kernel<T, kScalar, kWindowed>;
  if (m / kPer <= 32) return rerank_slice_kernel<T, kRegVec, kWindowed>;
  return rerank_slice_kernel<T, kSharedVec, kWindowed>;
}

// Grouped items take int32 rows only: on int16 rows the (query, window)
// item, which reads half the bytes, won (fused_rerank.plan_group).
WindowKernel<int32_t> pick_group(int m, int vec) {
  if (!vec) return rerank_slice_kernel<int32_t, kScalar, kGrouped>;
  if (m / 4 <= 32) return rerank_slice_kernel<int32_t, kRegVec, kGrouped>;
  return rerank_slice_kernel<int32_t, kSharedVec, kGrouped>;
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

// Blocks of the windowed kernel for (m, k, vec) the current device keeps
// resident at once, the most its cooperative launch may have; < 0 is a
// CUDA error.
template <typename T>
int window_resident(int m, int k, int vec) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick_window<T>(m, vec), kThreads,
                                                           window_smem_bytes(m, k))) != cudaSuccess) {
    return -static_cast<int>(err);
  }
  return sms * per_sm;
}

// Blocks of the grouped kernel for (m, vec) at smem bytes of dynamic shared
// memory (above 48 KB by Hopper's opt-in) the current device keeps resident
// at once; < 0 is a CUDA error.
int group_resident(int m, int vec, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  const WindowKernel<int32_t> kernel = pick_group(m, vec);
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGroupThreads, smem)) !=
          cudaSuccess) {
    return -static_cast<int>(err);
  }
  return sms * per_sm;
}

// ids (q, ctot) int32, reordered in place; work holds the windowed path's
// workspace, stats the 6 stats words; group 1 runs (query, window) items,
// group > 1 (group, window) items, int32 rows only; grid at most the
// resident blocks.
template <typename T>
int launch_window(const void* dataset, const void* queries, void* ids, void* work, void* stats,
                  void* dout, void* iout, int q, int n, int m, int ctot, int k, int vec, int shift,
                  int windows, int group, int grid, void* stream) {
  const int chunks = (ctot + kPart - 1) / kPart;
  if (work == nullptr || stats == nullptr || grid < 1 || shift < 0 || shift > 30 || windows < 1 ||
      windows > kMaxWindows || chunks > kMaxChunks ||
      (static_cast<long long>(windows) << shift) < n || group < 1 || group > kGroupMax ||
      (group > 1 && (!std::is_same<T, int32_t>::value || (1 << shift) > kGroupRowsMax ||
                     m > kGroupElems * 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Window<T> a;
  a.dataset = static_cast<const T*>(dataset);
  a.queries = static_cast<const int*>(queries);
  a.ids = static_cast<int*>(ids);
  a.dout = static_cast<int*>(dout);
  a.iout = static_cast<int*>(iout);
  char* w = static_cast<char*>(work);
  a.lists = reinterpret_cast<unsigned long long*>(w);
  w += sizeof(unsigned long long) * q * k;
  a.locks = reinterpret_cast<int*>(w);
  w += sizeof(int) * q;
  a.ticket = reinterpret_cast<unsigned*>(w);
  w += 16;
  a.offsets = reinterpret_cast<unsigned short*>(w);
  a.stats = static_cast<unsigned long long*>(stats);
  a.q = q;
  a.n = n;
  a.m = m;
  a.ctot = ctot;
  a.k = k;
  a.shift = shift;
  a.windows = windows;
  a.chunks = chunks;
  a.group = group;
  WindowKernel<T> kernel = pick_window<T>(m, vec);
  size_t smem = window_smem_bytes(m, k);
  if constexpr (std::is_same<T, int32_t>::value) {
    if (group > 1) {
      kernel = pick_group(m, vec);
      smem = group_smem_bytes(m, k, group, 1 << shift, chunks);
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(group > 1 ? kGroupThreads : kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_rerank_l2_bytes() {
  int dev = 0, bytes = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev)) != cudaSuccess) {
    return -static_cast<int>(err);
  }
  return bytes;
}

extern "C" int fused_rerank_smem_optin() {
  int dev = 0, bytes = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess) {
    return -static_cast<int>(err);
  }
  return bytes;
}

extern "C" int fused_rerank_window_resident_i32(int m, int k, int vec) {
  return window_resident<int32_t>(m, k, vec);
}
extern "C" int fused_rerank_window_resident_i16(int m, int k, int vec) {
  return window_resident<int16_t>(m, k, vec);
}

extern "C" int fused_rerank_group_resident_i32(int m, int vec, int smem) {
  return group_resident(m, vec, smem);
}

extern "C" int fused_rerank_window_i32(const void* dataset, const void* queries, void* ids,
                                       void* work, void* stats, void* dout, void* iout, int q,
                                       int n, int m, int ctot, int k, int vec, int shift,
                                       int windows, int group, int grid, void* stream) {
  return launch_window<int32_t>(dataset, queries, ids, work, stats, dout, iout, q, n, m, ctot, k,
                                vec, shift, windows, group, grid, stream);
}

extern "C" int fused_rerank_window_i16(const void* dataset, const void* queries, void* ids,
                                       void* work, void* stats, void* dout, void* iout, int q,
                                       int n, int m, int ctot, int k, int vec, int shift,
                                       int windows, int group, int grid, void* stream) {
  return launch_window<int16_t>(dataset, queries, ids, work, stats, dout, iout, q, n, m, ctot, k,
                                vec, shift, windows, group, grid, stream);
}

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
