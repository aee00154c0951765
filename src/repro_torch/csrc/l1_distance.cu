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
// Per-query rows bound.  Every candidate row is read once against its one
// query row: at the 'scan' rerank's and SRS's shapes (64 x 4,096 x 128 and
// 256 x 512 x 128) a launch reads 67-134 MB and makes one |q - x| update a
// value, so bytes bound it (0.020-0.040 ms at 3.35 TB/s), not operations.
//
// What the first design lacked: bytes in flight, and at 16 bits, issue.
// One warp took one row, lanes strided over m with scalar loads (64 B a
// warp-wide load at int16), each lane read the query again for every row,
// and each sum was stored from lane 0.  Timed by events around 50 launches
// (scripts/l1_rows_ab.py), it sat at 0.83 of the bound at int32 but 0.52 at
// int16 and 0.55 at bfloat16: 2-byte loads and 5-7 integer instructions a
// value left the card short of loads in flight.
//
// Design (l1_rows_vec_kernel, chosen by the wrapper's plan_rows when a row
// is a whole number of 16-byte vectors and both pointers are 16-byte
// aligned; V = m * sizeof(T) / 16 vectors a row):
//  * A block of 8 warps takes one query and a tile of its rows, which lie
//    in one contiguous span, in passes of kRowLoads (4) 16-byte loads a
//    lane (8 int16 or bf16 values, or 4 int32 or float32, a load), a fixed
//    trip, unrolled.  A warp issues its next pass's loads before it sums
//    the current pass, so 8 loads a lane (4 KB a warp) are in flight; at
//    4 blocks an SM that is 128 KB.  The loads skip L1 and ask L2 for the
//    whole 256-byte line.
//  * A row takes a segment of S lanes (S = V rounded up to a power of two
//    when V <= 32, so one warp-wide load covers 32 / S whole rows), or,
//    when V > 32, a whole warp over K slots of 32 vectors (K = ceil(V / 32)
//    rounded up to 1, 2, 4 or 8; wider rows loop over chunks of 8 slots).
//    A lane so always meets the same query vectors: it loads them once into
//    registers (rows over 8 chunks' width reload them a chunk, from the
//    query row staged in shared memory).  Lanes past V and rows past C
//    load nothing and add nothing.
//  * int16 sums |x - q| as max - min of each signed 16-bit pair (Hopper's
//    VIMNMX.S16x2), summed by two-way dot products (IDP.2A) with (1, 1) and
//    (-1, -1): four instructions for two values, in int32 arithmetic that
//    wraps as the plain sums do.  bfloat16 widens by a shift.
//  * Each row's lane sums are reduced with __shfl_xor_sync over the
//    segment in a fixed order; the segment's first lane puts the sum in
//    shared memory, and the block stores its tile's sums coalesced.
// Otherwise (l1_rows_scalar_kernel) a warp takes a row and its lanes stride
// over m with scalar loads, against the query staged once a block in
// shared memory; the same tiles and stores.  Both paths sum integers in
// uint32 (int32's wrap) and give the same integers bit for bit.  A query
// row over kRowQueryMax bytes is read from global memory (L1) instead.
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
constexpr int kRowLoads = 4;   // l1_rows: 16-byte loads a lane a pass (K > 4: K)
constexpr int kRowMaxSlots = 8;           // l1_rows: 32-vector slots a row a chunk
constexpr int kRowMaxTile = 2048;         // l1_rows: rows a block (sums in shared memory)
constexpr int kRowQueryMax = 32 * 1024;   // l1_rows: query bytes staged in shared memory
constexpr size_t kRowSmemMax = 48 * 1024; // l1_rows: without an opt-in attribute

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

// ---- per-query rows: 16-byte vector loads, or scalar loads ----------------

__host__ __device__ constexpr size_t round16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// A row vector read once: not kept in L1, and L2 fetches the 256-byte
// line around it (the next lanes' and passes' vectors)
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// |x - q| of the values packed in one 32-bit word, added to acc (the tag
// names the input type)
__device__ __forceinline__ void add_word(uint32_t& acc, uint32_t x, uint32_t q, int32_t*) {
  acc += absdiff(x, q);
}
__device__ __forceinline__ void add_word(uint32_t& acc, uint32_t x, uint32_t q, int16_t*) {
  // |x - q| = max - min per signed half (Hopper's 16x2 min and max), the
  // sums of the maxima and of the minima taken by two-way dot products
  // with (1, 1) and (-1, -1): int32 arithmetic that wraps as the sums do
  const int mx = static_cast<int>(__vmaxs2(x, q)), mn = static_cast<int>(__vmins2(x, q));
  acc = static_cast<uint32_t>(__dp2a_lo(mx, 0x0101, static_cast<int>(acc)));
  acc = static_cast<uint32_t>(__dp2a_lo(mn, 0xffff, static_cast<int>(acc)));
}
__device__ __forceinline__ void add_word(float& acc, uint32_t x, uint32_t q, float*) {
  acc += fabsf(__uint_as_float(x) - __uint_as_float(q));
}
__device__ __forceinline__ void add_word(float& acc, uint32_t x, uint32_t q, __nv_bfloat16*) {
  // a bfloat16 is the high half of the float32 it widens to
  acc += fabsf(__uint_as_float(x << 16) - __uint_as_float(q << 16));
  acc += fabsf(__uint_as_float(x & 0xffff0000u) - __uint_as_float(q & 0xffff0000u));
}

template <typename T, typename A>
__device__ __forceinline__ void add_vec(A& acc, const uint4& x, const uint4& q) {
  T* tag = nullptr;
  add_word(acc, x.x, q.x, tag);
  add_word(acc, x.y, q.y, tag);
  add_word(acc, x.z, q.z, tag);
  add_word(acc, x.w, q.w, tag);
}

// Block b takes query b / tiles and rows [t * tile, min(C, (t + 1) * tile))
// of it, t = b % tiles.  Shared memory: the tile's sums, then the staged
// query row.
template <typename T, int K>
__global__ void __launch_bounds__(kRowWarps * 32)
l1_rows_vec_kernel(const T* __restrict__ queries, const T* __restrict__ rows,
                   typename Acc<T>::out* __restrict__ out, int c, int m, int seg, int tile,
                   int stage) {
  using A = typename Acc<T>::type;
  using Out = typename Acc<T>::out;
  constexpr int kHeld = K < kRowLoads ? kRowLoads / K : 1;  // rows (segments) a lane a pass
  extern __shared__ __align__(16) unsigned char l1_rows_smem[];
  Out* sums = reinterpret_cast<Out*>(l1_rows_smem);
  uint4* sq = reinterpret_cast<uint4*>(l1_rows_smem + round16(tile * sizeof(Out)));
  const int nv = static_cast<int>(static_cast<size_t>(m) * sizeof(T) / 16);  // V
  const int tiles = (c + tile - 1) / tile;
  const int q = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - q * tiles) * tile;
  const int nrows = min(tile, c - r0);
  const uint4* qg = reinterpret_cast<const uint4*>(queries) + static_cast<size_t>(q) * nv;
  const uint4* xg =
      reinterpret_cast<const uint4*>(rows) + (static_cast<size_t>(q) * c + r0) * nv;
  if (stage) {        // only for rows of several chunks (V > 256)
    for (int i = threadIdx.x; i < nv; i += blockDim.x) sq[i] = qg[i];
    __syncthreads();
  }
  const uint4* qs = stage ? sq : qg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane & (seg - 1);      // the lane's place in its row's segment
  const int per = 32 / seg;              // rows one warp-wide load covers
  const int lrow = lane / seg;           // the lane's row among them
  const int group = per * kHeld;         // rows a warp takes a pass
  const int span = 32 * K;               // vectors of a row a chunk
  const int chunks = (nv + span - 1) / span;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  uint4 qv[K];
  auto load_query = [&](int v0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int v = v0 + sub + 32 * j;
      qv[j] = v < nv ? (stage ? qs[v] : __ldg(qs + v)) : zero4;
    }
  };
  const int stride = kRowWarps * group;  // rows the block takes a pass
  // the loads of one pass: kHeld rows (segments) x K vectors a lane
  auto load_rows = [&](uint4 (&x)[kHeld][K], int base, int v0) {
#pragma unroll
    for (int p = 0; p < kHeld; ++p)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int row = base + p * per + lrow;
        const int v = v0 + sub + 32 * j;
        x[p][j] = row < nrows && v < nv ? load_stream(xg + static_cast<size_t>(row) * nv + v)
                                        : zero4;
      }
  };
  auto add_rows = [&](A (&acc)[kHeld], const uint4 (&x)[kHeld][K]) {
#pragma unroll
    for (int p = 0; p < kHeld; ++p)
#pragma unroll
      for (int j = 0; j < K; ++j) add_vec<T>(acc[p], x[p][j], qv[j]);
  };
  auto put_sums = [&](A (&acc)[kHeld], int base) {
#pragma unroll
    for (int p = 0; p < kHeld; ++p) {
      for (int off = seg >> 1; off > 0; off >>= 1)
        acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], off);
      const int row = base + p * per + lrow;
      if (sub == 0 && row < nrows) sums[row] = static_cast<Out>(acc[p]);
    }
  };
  if (chunks == 1) {
    // one chunk a row: the next pass's loads are in flight while this
    // pass's values are summed
    load_query(0);
    uint4 x[kHeld][K];
    load_rows(x, warp * group, 0);
    for (int base = warp * group; base < nrows; base += stride) {
      uint4 nx[kHeld][K];
      load_rows(nx, base + stride, 0);
      A acc[kHeld];
#pragma unroll
      for (int p = 0; p < kHeld; ++p) acc[p] = A(0);
      add_rows(acc, x);
      put_sums(acc, base);
#pragma unroll
      for (int p = 0; p < kHeld; ++p)
#pragma unroll
        for (int j = 0; j < K; ++j) x[p][j] = nx[p][j];
    }
  } else {
    for (int base = warp * group; base < nrows; base += stride) {
      A acc[kHeld];
#pragma unroll
      for (int p = 0; p < kHeld; ++p) acc[p] = A(0);
      for (int ch = 0; ch < chunks; ++ch) {
        load_query(ch * span);
        uint4 x[kHeld][K];
        load_rows(x, base, ch * span);
        add_rows(acc, x);
      }
      put_sums(acc, base);
    }
  }
  __syncthreads();
  Out* dst = out + static_cast<size_t>(q) * c + r0;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) dst[i] = sums[i];
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
l1_rows_scalar_kernel(const T* __restrict__ queries, const T* __restrict__ rows,
                      typename Acc<T>::out* __restrict__ out, int c, int m, int tile,
                      int stage) {
  using A = typename Acc<T>::type;
  using Out = typename Acc<T>::out;
  extern __shared__ __align__(16) unsigned char l1_rows_smem[];
  Out* sums = reinterpret_cast<Out*>(l1_rows_smem);
  T* sq = reinterpret_cast<T*>(l1_rows_smem + round16(tile * sizeof(Out)));
  const int tiles = (c + tile - 1) / tile;
  const int q = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - q * tiles) * tile;
  const int nrows = min(tile, c - r0);
  const T* qg = queries + static_cast<size_t>(q) * m;
  if (stage) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) sq[i] = qg[i];
    __syncthreads();
  }
  const T* qs = stage ? sq : qg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < nrows; j += kRowWarps) {
    const T* row = rows + (static_cast<size_t>(q) * c + r0 + j) * m;
    A acc = A(0);
#pragma unroll 4
    for (int k = lane; k < m; k += 32) acc += absdiff(widen(row[k]), widen(qs[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sums[j] = static_cast<Out>(acc);
  }
  __syncthreads();
  Out* dst = out + static_cast<size_t>(q) * c + r0;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) dst[i] = sums[i];
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

// The plan (slots, seg, tile, stage) is the wrapper's plan_rows: slots 0
// takes the scalar path, slots K > 0 the vector path with K 32-vector slots
// a row (seg lanes a row when K is 1, else 32).  A plan this kernel family
// cannot take returns cudaErrorInvalidValue and launches nothing.
template <typename T>
int launch_rows(const void* queries, const void* rows, void* out, int nq, int c, int m,
                int slots, int seg, int tile, int stage, void* stream) {
  using Out = typename Acc<T>::out;
  const size_t row_bytes = static_cast<size_t>(m) * sizeof(T);
  const bool aligned = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0
                       && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const long long blocks = static_cast<long long>(nq) * ((c + tile - 1) / tile);
  const size_t smem = round16(static_cast<size_t>(tile) * sizeof(Out))
                      + (stage ? round16(row_bytes) : 0);
  const bool seg_ok = seg >= 1 && seg <= 32 && (seg & (seg - 1)) == 0
                      && (slots <= 1 || seg == 32);
  if (tile < 1 || tile > kRowMaxTile || !seg_ok || (slots > 0 && !aligned)
      || (stage && row_bytes > kRowQueryMax) || smem > kRowSmemMax || blocks >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(queries);
  const T* rp = static_cast<const T*>(rows);
  Out* op = static_cast<Out*>(out);
  switch (slots) {
    case 0:
      l1_rows_scalar_kernel<T><<<grid, kRowWarps * 32, smem, st>>>(qp, rp, op, c, m, tile,
                                                                    stage);
      break;
    case 1:
      l1_rows_vec_kernel<T, 1><<<grid, kRowWarps * 32, smem, st>>>(qp, rp, op, c, m, seg,
                                                                    tile, stage);
      break;
    case 2:
      l1_rows_vec_kernel<T, 2><<<grid, kRowWarps * 32, smem, st>>>(qp, rp, op, c, m, seg,
                                                                    tile, stage);
      break;
    case 4:
      l1_rows_vec_kernel<T, 4><<<grid, kRowWarps * 32, smem, st>>>(qp, rp, op, c, m, seg,
                                                                    tile, stage);
      break;
    case kRowMaxSlots:
      l1_rows_vec_kernel<T, kRowMaxSlots><<<grid, kRowWarps * 32, smem, st>>>(
          qp, rp, op, c, m, seg, tile, stage);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
                                  int nq, int c, int m, int slots, int seg, int tile,    \
                                  int stage, void* stream) {                             \
    return launch_rows<T>(queries, rows, out, nq, c, m, slots, seg, tile, stage, stream); \
  }

L1_ENTRIES(i32, int32_t)
L1_ENTRIES(i16, int16_t)
L1_ENTRIES(f32, float)
L1_ENTRIES(bf16, __nv_bfloat16)
