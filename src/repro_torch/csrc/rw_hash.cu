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
// same sum, so the design takes the prefix form.  A block takes 1024 rows
// and 32 hash functions (one per lane) and, for each dimension in turn:
//  * copies the 32 functions' U2 steps (int8, one coalesced run each) and
//    the rows' clamped offsets into shared memory;
//  * scans the steps into the (U2+1) x 32 prefix table: each of the 16
//    warps sums a 1/16 segment of the steps, one lane per function, then
//    rewrites its segment as running sums from the segments before it.  The
//    step rows are padded to an odd number of words, so the 32 lanes read
//    32 banks;
//  * adds table[offset(row) + lane] for its 64 rows per thread.  The lanes
//    of a warp read 32 consecutive words of one table row, so the lookups
//    have no bank conflicts.
// No table leaves the block: the kernel reads pairs (F * m * U2 bytes per
// row tile) and points, and writes the hashes.  When rows x functions give
// fewer blocks than the card holds at once (a served batch of 64 queries),
// the dimensions are split over blockIdx.z and the slices add into a zeroed
// output with integer atomics, which give the same bits in any order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFns = 32;                   // hash functions per block, one per lane
constexpr int kWarps = 16;                 // 512 threads
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 1024;                // rows per block
constexpr int kPerThread = kRows / kWarps; // rows (accumulators) per thread

// Bytes between two functions' step rows in shared memory: U2 rounded up
// to an odd number of words, so 32 lanes reading one step each hit 32 banks.
__host__ __device__ inline int raw_stride(int u2) { return 4 * (((u2 + 3) / 4) | 1); }

__host__ __device__ inline int smem_bytes(int u2) {
  return static_cast<int>(((u2 + 1) * kFns + kRows + kWarps * kFns) * sizeof(int))
         + kFns * raw_stride(u2);
}

__global__ void __launch_bounds__(kThreads, 1)
rw_hash_kernel(const int8_t* __restrict__ pairs, const int* __restrict__ points,
               int* __restrict__ out, int n, int n_fns, int m, int u2, int dims_per_slice) {
  extern __shared__ int smem[];
  int* s_tab = smem;                        // (u2 + 1) x kFns prefix sums
  int* s_off = s_tab + (u2 + 1) * kFns;     // kRows offsets into s_tab
  int* s_part = s_off + kRows;              // kWarps x kFns segment sums
  int8_t* s_raw = reinterpret_cast<int8_t*>(s_part + kWarps * kFns);  // kFns step rows
  const int stride = raw_stride(u2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRows;
  const int f0 = blockIdx.y * kFns;
  const int fw = min(kFns, n_fns - f0);
  const int i_lo = blockIdx.z * dims_per_slice;
  const int i_hi = min(m, i_lo + dims_per_slice);
  const int seg = (u2 + kWarps - 1) / kWarps;
  const int u_lo = min(u2, warp * seg);
  const int u_hi = min(u2, u_lo + seg);
  const int8_t* raw = s_raw + lane * stride;

  int acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0;

  for (int i = i_lo; i < i_hi; ++i) {
    __syncthreads();                        // the previous dimension's reads are done
    for (int e = threadIdx.x; e < kFns * u2; e += kThreads) {
      const int fl = e / u2, u = e - fl * u2;
      s_raw[fl * stride + u] =
          fl < fw ? pairs[(static_cast<size_t>(f0 + fl) * m + i) * u2 + u] : 0;
    }
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const int row = row0 + r;
      const int t = row < n ? (points[static_cast<size_t>(row) * m + i] >> 1) : 0;
      s_off[r] = min(max(t, 0), u2) * kFns;
    }
    __syncthreads();
    int sum = 0;
    for (int u = u_lo; u < u_hi; ++u) sum += raw[u];
    s_part[warp * kFns + lane] = sum;
    __syncthreads();
    int carry = 0;
    for (int w = 0; w < warp; ++w) carry += s_part[w * kFns + lane];
    if (warp == 0) s_tab[lane] = 0;
    for (int u = u_lo; u < u_hi; ++u) {
      carry += raw[u];
      s_tab[(u + 1) * kFns + lane] = carry;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[j] += s_tab[s_off[warp + j * kWarps] + lane];
  }

  if (lane >= fw) return;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int row = row0 + warp + j * kWarps;
    if (row < n) {
      int* o = out + static_cast<size_t>(row) * n_fns + f0 + lane;
      if (gridDim.z == 1) {
        *o = acc[j];
      } else {
        atomicAdd(o, acc[j]);
      }
    }
  }
}

}  // namespace

// The largest U2 whose block fits the current device's shared memory.
extern "C" int rw_hash_max_u2() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
          != cudaSuccess) {
    return -1;
  }
  int u2 = 0;
  while (smem_bytes(u2 + 1) <= limit) ++u2;
  return u2;
}

// pairs (F, m, U2) int8, points (n, m) int32, out (n, F) int32; all
// contiguous.  n, F, m > 0 and 0 < U2 <= rw_hash_max_u2().
extern "C" int rw_hash(const void* pairs, const void* points, void* out,
                       int n, int n_fns, int m, int u2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(u2);
  cudaError_t err = cudaFuncSetAttribute(
      rw_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
          != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rw_hash_kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // split the dimensions until the grid holds as many blocks as are resident
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int fn_tiles = (n_fns + kFns - 1) / kFns;
  const long long row_tiles = (static_cast<long long>(n) + kRows - 1) / kRows;
  const long long blocks = row_tiles * fn_tiles;
  const long long want = blocks < resident ? (resident + blocks - 1) / blocks : 1;
  int slices = static_cast<int>(want < m ? want : m);
  const int dims_per_slice = (m + slices - 1) / slices;
  slices = (m + dims_per_slice - 1) / dims_per_slice;
  if (slices > 1) {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * n_fns * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rw_hash_kernel<<<dim3(static_cast<unsigned>(row_tiles), fn_tiles, slices),
                   kThreads, smem, s>>>(
      static_cast<const int8_t*>(pairs), static_cast<const int*>(points),
      static_cast<int*>(out), n, n_fns, m, u2, dims_per_slice);
  return static_cast<int>(cudaGetLastError());
}
