// Random-walk raw hash for Hopper (sm_90a).
//
// Replaces the TPU kernel _rw_hash_kernel / rw_hash_pallas
// (src/repro/kernels/rw_hash.py:29, :55).  Contract, for every int32 input:
//
//   out[r, f] = sum_{i, u < U2} 1{u < points[r, i] >> 1} * pairs[f, i, u]
//
// The TPU kernel builds the 0/1 thermometer code in VMEM and feeds it to the
// MXU.  Here the same sum is read from prefix sums of the steps:
// sum_{u < t} pairs[f, i, u] = prefix[f, i, clamp(t, 0, U2)], since the code
// is all zeros for t <= 0 and all ones for t >= U2.  The clamp is what makes
// the two forms equal on negative, odd and above-universe coordinates.
//
// Bound: bytes at the build's shape (n = 1 M, F = 96, m = 128): the points
// (n * m * 4 bytes) are read once and the hashes (n * F * 4) written once;
// the least work is n * F * m integer adds.  The thermometer product on the
// int8 tensor cores would do 2 * U2 = 510 times more operations for the
// same sum, so the design takes the prefix form, in two launches:
//
//  * rw_table_kernel writes every prefix table once a call, into a
//    workspace tab (m, U2 + 1, Fp) int32 (Fp = F rounded up to 32, columns
//    F..Fp-1 zero): tab[i, u, f] = sum_{v < u} pairs[f, i, v].  Block
//    (dimension, 32 functions): it copies the 32 step rows with reads
//    coalesced along u, and scans them with a segmented scan (each of the
//    16 warps sums a 1/16 segment, one lane per function, then rewrites its
//    segment as running sums from the segments before it).  Its writes are
//    rows of 128 contiguous bytes.  int32, since a prefix of int8 steps can
//    reach 128 * U2.  At the build's shape the table is 12.6 MB, which L2
//    holds for the second launch.
//  * rw_hash_kernel takes 512 rows x 32 functions a block (one function a
//    lane, 64 rows a thread).  For each chunk of 16 dimensions it stages the
//    rows' clamped offsets in shared memory, read row by row so that 16
//    lanes read one row's 64 contiguous bytes; for each dimension it copies
//    the 32 functions' table slice ((U2 + 1) rows of 128 bytes) with 16-byte
//    loads and adds table[offset(row) + lane] for its rows.  The lanes of a
//    warp read one broadcast offset and 32 consecutive words of one table
//    row, so the lookups have no bank conflicts.  Two blocks are resident on
//    an SM, so one block's copy overlaps the other's lookups.
//
// When rows x function tiles give fewer blocks than the card holds at once
// (a served batch of 64 queries), the dimensions are split over blockIdx.z
// and the slices add into a zeroed output with integer atomics, which give
// the same bits in any order.  The caller plans the split.
//
// Any U2: both launches take a `span`, the most steps (table kernel) and
// span + 1 table rows (hash kernel) that one pass holds in shared memory;
// the caller plans it as min(U2, the limit rw_hash_setup returns), and the
// number of hash windows n_win = ceil((U2 + 1) / (span + 1)) with it.  The
// table kernel scans the steps in chunks of span, carrying each function's
// running sum from one chunk to the next.  The hash kernel copies each
// dimension's slice in n_win windows of span + 1 rows,
// [w (span + 1), (w + 1)(span + 1)), and adds a row's entry only in the
// window that holds its offset; each offset lies in exactly one window, and
// integer adds give the same bits in any order.  With n_win == 1 there is
// one chunk and one window, and the launch takes the one-window
// instantiation, which adds without the window test: on an H100 the test
// costs 2.8-4.0% of the hash's device time at U2 255 and 1 M rows (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFns = 32;                   // hash functions per block, one per lane

// ---- prefix table: the segmented scan of 32 functions' steps --------------
constexpr int kScanWarps = 16;
constexpr int kScanThreads = kScanWarps * 32;

// Bytes between two functions' step rows in shared memory: U2 rounded up
// to an odd number of words, so 32 lanes reading one step each hit 32 banks.
__host__ __device__ inline int raw_stride(int u2) { return 4 * (((u2 + 3) / 4) | 1); }

__host__ __device__ inline int table_smem(int u2) {
  return static_cast<int>(kScanWarps * kFns * sizeof(int)) + kFns * raw_stride(u2);
}

__global__ void __launch_bounds__(kScanThreads)
rw_table_kernel(const int8_t* __restrict__ pairs, int* __restrict__ tab,
                int n_fns, int m, int u2, int fp, int span) {
  extern __shared__ int smem[];
  int* s_part = smem;                       // kScanWarps x kFns segment sums
  int8_t* s_raw = reinterpret_cast<int8_t*>(s_part + kScanWarps * kFns);  // kFns step rows
  const int stride = raw_stride(span);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x;
  const int f0 = blockIdx.y * kFns;
  const int fw = min(kFns, n_fns - f0);
  int* dst = tab + static_cast<size_t>(i) * (u2 + 1) * fp + f0;
  if (warp == 0) dst[lane] = 0;
  int base = 0;                             // this lane's sum over the chunks before
  for (int v0 = 0; v0 < u2; v0 += span) {
    const int len = min(span, u2 - v0);
    // the chunk's step rows, consecutive threads on consecutive steps of a
    // row; the padding functions' rows are zero
    for (int e = threadIdx.x; e < kFns * len; e += kScanThreads) {
      const int fl = e / len, u = e - fl * len;
      s_raw[fl * stride + u] =
          fl < fw ? pairs[(static_cast<size_t>(f0 + fl) * m + i) * u2 + v0 + u] : 0;
    }
    __syncthreads();
    const int seg = (len + kScanWarps - 1) / kScanWarps;
    const int u_lo = min(len, warp * seg);
    const int u_hi = min(len, u_lo + seg);
    const int8_t* raw = s_raw + lane * stride;
    int sum = 0;
    for (int u = u_lo; u < u_hi; ++u) sum += raw[u];
    s_part[warp * kFns + lane] = sum;
    __syncthreads();
    int carry = base, total = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      const int part = s_part[w * kFns + lane];
      if (w < warp) carry += part;
      total += part;
    }
    for (int u = u_lo; u < u_hi; ++u) {
      carry += raw[u];
      dst[(v0 + u + 1) * fp + lane] = carry;  // one 128-byte row a warp
    }
    base += total;
    __syncthreads();                        // the chunk's buffers are free again
  }
}

// ---- row-tile hash over the table ------------------------------------------
constexpr int kWarps = 8;                  // 256 threads
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 512;                 // rows per block
constexpr int kPerThread = kRows / kWarps; // rows (accumulators) per thread
constexpr int kDims = 16;                  // dimensions whose offsets are staged at once

__host__ __device__ inline int hash_smem(int u2) {
  return static_cast<int>(((u2 + 1) * kFns + kRows * kDims) * sizeof(int));
}

template <bool kWindowed>
__global__ void __launch_bounds__(kThreads, 2)
rw_hash_kernel(const int* __restrict__ points, const int* __restrict__ tab,
               int* __restrict__ out, int n, int n_fns, int m, int u2, int fp,
               int fn_tiles, int dims_per_slice, int span, int n_win) {
  extern __shared__ int4 smem4[];
  int* s_tab = reinterpret_cast<int*>(smem4);   // a window of (span + 1) x kFns table rows
  int* s_off = s_tab + (span + 1) * kFns;       // kRows x kDims offsets into the slice
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x / fn_tiles;
  const int f0 = (blockIdx.x - tile * fn_tiles) * kFns;
  const int row0 = tile * kRows;
  const int rows = min(kRows, n - row0);
  const int i_lo = blockIdx.z * dims_per_slice;
  const int i_hi = min(m, i_lo + dims_per_slice);
  const int win = span + 1;                     // table rows a window
  const int fp4 = fp / 4;

  int acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0;

  for (int c = i_lo; c < i_hi; c += kDims) {
    const int dims = min(kDims, i_hi - c);
    for (int e = threadIdx.x; e < rows * kDims; e += kThreads) {
      const int r = e / kDims, d = e % kDims;
      const int t = d < dims ? points[static_cast<size_t>(row0 + r) * m + c + d] >> 1 : 0;
      s_off[e] = min(max(t, 0), u2) * kFns;
    }
    for (int d = 0; d < dims; ++d) {
      const int4* src = reinterpret_cast<const int4*>(
          tab + static_cast<size_t>(c + d) * (u2 + 1) * fp + f0);
      for (int w = 0; w < (kWindowed ? n_win : 1); ++w) {
        const int u0 = w * win;
        const int vecs = min(win, u2 + 1 - u0) * (kFns / 4);  // 16-byte words of the window
        for (int e = threadIdx.x; e < vecs; e += kThreads) {
          const int u = e / (kFns / 4), q = e % (kFns / 4);
          smem4[e] = src[(u0 + u) * fp4 + q];
        }
        __syncthreads();
        // the offset relative to the window, unsigned: below 0 wraps high
        const unsigned lo = static_cast<unsigned>(u0 * kFns);
        const unsigned extent = static_cast<unsigned>(vecs * 4);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int r = warp + j * kWarps;
          const unsigned o = static_cast<unsigned>(s_off[r * kDims + d]) - lo;
          if (r < rows && (!kWindowed || o < extent)) acc[j] += s_tab[o + lane];
        }
        __syncthreads();                        // the window and offsets are free again
      }
    }
  }

  if (f0 + lane >= n_fns) return;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int r = warp + j * kWarps;
    if (r < rows) {
      int* o = out + static_cast<size_t>(row0 + r) * n_fns + f0 + lane;
      if (gridDim.z == 1) {
        *o = acc[j];
      } else {
        atomicAdd(o, acc[j]);
      }
    }
  }
}

}  // namespace

// Sets each kernel's dynamic shared memory limit to the current device's
// opt-in maximum (once a device: a launch then asks no attribute) and
// returns the largest span (steps of a table chunk, span + 1 rows of a hash
// window) both launches hold in one pass there, or minus a CUDA error.
extern "C" int rw_hash_setup() {
  int dev = 0, limit = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
          != cudaSuccess ||
      (err = cudaFuncSetAttribute(rw_table_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, limit))
          != cudaSuccess ||
      (err = cudaFuncSetAttribute(rw_hash_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, limit))
          != cudaSuccess ||
      (err = cudaFuncSetAttribute(rw_hash_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, limit))
          != cudaSuccess) {
    return -static_cast<int>(err);
  }
  int span = 0;
  while (hash_smem(span + 1) <= limit && table_smem(span + 1) <= limit) ++span;
  return span;
}

// Blocks of rw_hash_kernel the current device keeps resident at once at
// this span (SMs x blocks an SM), or minus a CUDA error.  After
// rw_hash_setup.  Both instantiations take the same shared memory.
extern "C" int rw_hash_resident(int span) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
          != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rw_hash_kernel<false>, kThreads, hash_smem(span))) != cudaSuccess) {
    return -static_cast<int>(err);
  }
  return sms * per_sm;
}

// pairs (F, m, U2) int8 -> tab (m, U2 + 1, Fp) int32, Fp = F rounded up to a
// multiple of 32; both contiguous.  F, m > 0, U2 >= 0 and
// 0 < span <= max(1, min(U2, rw_hash_setup())).
extern "C" int rw_prefix_table(const void* pairs, void* tab, int n_fns, int m, int u2,
                               int span, void* stream) {
  const int fp = (n_fns + kFns - 1) / kFns * kFns;
  rw_table_kernel<<<dim3(m, fp / kFns), kScanThreads, table_smem(span),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pairs), static_cast<int*>(tab), n_fns, m, u2, fp, span);
  return static_cast<int>(cudaGetLastError());
}

// pairs (F, m, U2) int8, points (n, m) int32, tab (m, U2 + 1, Fp) int32
// workspace, out (n, F) int32; all contiguous.  n, F, m, U2 > 0,
// 0 < span <= min(U2, rw_hash_setup()), n_win = ceil((U2 + 1) / (span + 1)),
// and 1 <= slices <= m with no slice empty (slices == ceil(m / ceil(m /
// slices))).  Launches the table kernel, the memset of a split output and
// the hash kernel.
extern "C" int rw_hash(const void* pairs, const void* points, void* tab, void* out,
                       int n, int n_fns, int m, int u2, int span, int n_win,
                       int slices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = rw_prefix_table(pairs, tab, n_fns, m, u2, span, stream);
  if (err != 0) return err;
  if (slices > 1) {
    err = static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(n) * n_fns * sizeof(int), s));
    if (err != 0) return err;
  }
  const int fp = (n_fns + kFns - 1) / kFns * kFns;
  const int fn_tiles = fp / kFns;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows) * fn_tiles, 1, slices);
  const int per_slice = (m + slices - 1) / slices;
  auto kernel = n_win == 1 ? &rw_hash_kernel<false> : &rw_hash_kernel<true>;
  kernel<<<grid, kThreads, hash_smem(span), s>>>(
      static_cast<const int*>(points), static_cast<const int*>(tab),
      static_cast<int*>(out), n, n_fns, m, u2, fp, fn_tiles, per_slice, span, n_win);
  return static_cast<int>(cudaGetLastError());
}
