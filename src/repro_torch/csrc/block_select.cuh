// block_select.cuh: the per-row value bisection shared by block_topk.cu and
// ef_update.cu — the selection of the Pallas kernels
// src/repro/kernels/block_topk.py (_block_topk_kernel) and
// src/repro/kernels/ef_update.py (_ef_update_kernel):
//
//   mag = |v|;  hi = max(mag) (NaN propagates);  lo = 0
//   40 times:   mid = 0.5 * (lo + hi)
//               pred = count(mag >= mid) >= k
//               lo = pred ? mid : lo;  hi = pred ? hi : mid
//   mask = mag >= lo
//
// This is a VALUE bisection, not exact Top-K: a NaN makes hi NaN and keeps
// every non-NaN element, an inf keeps everything unless k = 1, and a k-th
// magnitude below rowmax * 2^-40 keeps the whole row, zeros included. Those
// are the reference kernel's results and this reproduces them.
//
// Denormals: the reference's platforms (XLA on the CPU, the TPU) read
// denormal operands as zero and write denormal results as zero. PyTorch and
// nvcc (without --use_fast_math) keep them, so the selection flushes by hand:
// the magnitudes and every mid go through flush(), and the plain PyTorch
// twins (kernels/block_topk.py) do the same.
//
// One CTA holds one row in registers, ITEMS elements a thread (thread t
// holds elements t, t + T, t + 2T, ...: coalesced loads), so the row is
// read from device memory once and the 40 counts run on chip. Each count is
// a warp __reduce_add_sync and one pass over per-warp partials in shared
// memory; the partials alternate between two buffers so one __syncthreads
// a step is enough.
//
// Rows longer than MAX_BLOCK do not fit in registers. select_lo_wide runs
// the same bisection with MAX_THREADS threads that re-read the row from
// device memory (through L2) at every step, element idx by thread
// idx % MAX_THREADS; counts are integers and the max is order-free, so its
// lo equals select_lo's bit for bit on any row both take.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace block_select {

constexpr int ITEMS = 16;                         // elements a thread holds
constexpr int MAX_THREADS = 1024;
constexpr int MAX_BLOCK = ITEMS * MAX_THREADS;    // 16384 elements a row
constexpr int N_ITERS = 40;

// Denormal -> zero of the same sign (what DAZ/FTZ do to it).
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

// Threads a CTA needs for a row of `block` elements: a multiple of 32.
inline int threads_for(int block) {
  const int t = (block + ITEMS - 1) / ITEMS;
  return ((t + 31) / 32) * 32;
}

struct Scratch {
  unsigned umax[32];
  int sums[2][32];
};

// Block-wide max of one unsigned per thread; every thread gets it.
__device__ __forceinline__ unsigned block_max(unsigned v, Scratch& s) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s.umax[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned m = 0u;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) m = s.umax[w] > m ? s.umax[w] : m;
  return m;
}

// Block-wide sum of one int per thread into buffer `b`; every thread gets it.
__device__ __forceinline__ int block_sum(int v, Scratch& s, int b) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s.sums[b][threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total += s.sums[b][w];
  return total;
}

// The bisection over this thread's values v[0..ITEMS) of a row of `block`
// elements; returns lo (the row's mask is flush(|v|) >= lo). Every thread of
// the CTA must call it.
__device__ __forceinline__ float select_lo(const float (&v)[ITEMS], int block,
                                           int k, Scratch& s) {
  // max on the bit patterns of the (non-negative) magnitudes: NaN patterns
  // order above inf, so a NaN in the row makes hi NaN, as jnp.max does
  unsigned mx = 0u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    const unsigned b = __float_as_uint(flush(fabsf(v[i])));
    if (idx < block && b > mx) mx = b;
  }
  float hi = __uint_as_float(block_max(mx, s));
  float lo = 0.0f;
  for (int it = 0; it < N_ITERS; ++it) {
    const float mid = flush(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = threadIdx.x + i * blockDim.x;
      cnt += (idx < block && flush(fabsf(v[i])) >= mid) ? 1 : 0;
    }
    const bool pred = block_sum(cnt, s, it & 1) >= k;
    lo = pred ? mid : lo;
    hi = pred ? hi : mid;
  }
  return lo;
}

// The bisection over a row of any length, each value read through
// `value(idx)` (0 <= idx < block) once per step; returns lo as select_lo.
// Every thread of the CTA must call it.
template <typename Value>
__device__ __forceinline__ float select_lo_wide(const Value& value, int block,
                                                int k, Scratch& s) {
  unsigned mx = 0u;
  for (int idx = threadIdx.x; idx < block; idx += blockDim.x) {
    const unsigned b = __float_as_uint(flush(fabsf(value(idx))));
    if (b > mx) mx = b;
  }
  float hi = __uint_as_float(block_max(mx, s));
  float lo = 0.0f;
  for (int it = 0; it < N_ITERS; ++it) {
    const float mid = flush(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
    int cnt = 0;
    for (int idx = threadIdx.x; idx < block; idx += blockDim.x)
      cnt += flush(fabsf(value(idx))) >= mid ? 1 : 0;
    const bool pred = block_sum(cnt, s, it & 1) >= k;
    lo = pred ? mid : lo;
    hi = pred ? hi : mid;
  }
  return lo;
}

}  // namespace block_select
