// Two-way top-k merge of lex-(dist, id) ascending lists, for Hopper (sm_90a).
//
// Replaces the TPU kernel _merge_kernel / topk_merge_pallas
// (src/repro/kernels/topk_merge.py:115, :122).  Same network, element for
// element: k is padded to a power of two kp with (pad, -1) — pad is
// INT32_MAX/2 for int32 distances and +inf for float32 — stage 0 keeps the
// lex-min of a[j] and reversed b[kp-1-j] (the k smallest of a bitonic 2kp
// sequence), then log2(kp) bitonic clean-up stages at distances kp/2 .. 1.
// The pads take part in the compares, so an input at dist >= pad with id >= 0
// ranks after a pad exactly as in the TPU kernel.
//
// Bound: bytes.  Each row reads 4 k-entry int32 arrays and writes 2; the
// network is O(k log k) compares on 8-byte pairs in shared memory, far below
// the memory time.  Design: one warp per row, lanes stride over the kp
// positions of each stage, the row lives in shared memory between stages
// (__syncwarp, no block barrier), loads and stores of neighbouring lanes
// touch neighbouring addresses.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename D>
__device__ __forceinline__ bool lex_gt(D d1, int i1, D d2, int i2) {
  return (d1 > d2) || (d1 == d2 && i1 > i2);
}

template <typename D>
__global__ void topk_merge_kernel(const D* __restrict__ da, const int* __restrict__ ia,
                                  const D* __restrict__ db, const int* __restrict__ ib,
                                  D* __restrict__ dout, int* __restrict__ iout,
                                  int q, int k, int kp, D pad) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= q) return;  // warp-uniform; the kernel has no block barrier
  D* sd = reinterpret_cast<D*>(smem) + warp * kp;
  int* si = reinterpret_cast<int*>(smem + kWarpsPerBlock * kp * sizeof(D)) + warp * kp;
  const size_t base = static_cast<size_t>(row) * k;

  for (int j = lane; j < kp; j += 32) {
    const int jr = kp - 1 - j;
    const D a_d = j < k ? da[base + j] : pad;
    const int a_i = j < k ? ia[base + j] : -1;
    const D b_d = jr < k ? db[base + jr] : pad;
    const int b_i = jr < k ? ib[base + jr] : -1;
    const bool take_a = !lex_gt(a_d, a_i, b_d, b_i);
    sd[j] = take_a ? a_d : b_d;
    si[j] = take_a ? a_i : b_i;
  }
  __syncwarp();
  for (int s = kp / 2; s >= 1; s >>= 1) {
    for (int p = lane; p < kp / 2; p += 32) {
      const int lo = (p / s) * 2 * s + (p % s);
      const int hi = lo + s;
      const D ld = sd[lo], hd = sd[hi];
      const int li = si[lo], hi_i = si[hi];
      if (lex_gt(ld, li, hd, hi_i)) {
        sd[lo] = hd; sd[hi] = ld;
        si[lo] = hi_i; si[hi] = li;
      }
    }
    __syncwarp();
  }
  for (int j = lane; j < k; j += 32) {
    dout[base + j] = sd[j];
    iout[base + j] = si[j];
  }
}

template <typename D>
int launch(const void* da, const void* ia, const void* db, const void* ib,
           void* dout, void* iout, int q, int k, D pad, void* stream) {
  int kp = 1;
  while (kp < k) kp <<= 1;
  const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * kp * (sizeof(D) + sizeof(int));
  topk_merge_kernel<D><<<blocks, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const D*>(da), static_cast<const int*>(ia),
      static_cast<const D*>(db), static_cast<const int*>(ib),
      static_cast<D*>(dout), static_cast<int*>(iout), q, k, kp, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int topk_merge_i32(const void* da, const void* ia, const void* db, const void* ib,
                              void* dout, void* iout, int q, int k, void* stream) {
  return launch<int>(da, ia, db, ib, dout, iout, q, k, 0x7FFFFFFF / 2, stream);
}

extern "C" int topk_merge_f32(const void* da, const void* ia, const void* db, const void* ib,
                              void* dout, void* iout, int q, int k, void* stream) {
  return launch<float>(da, ia, db, ib, dout, iout, q, k, INFINITY, stream);
}
