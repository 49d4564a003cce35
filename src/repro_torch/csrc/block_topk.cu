// block_topk: per-row magnitude Top-K of x [nb, block], the reference
// kernel's value bisection.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_topk.py
// (block_topk_pallas / _block_topk_kernel): the selection of
// block_select.cuh (an exact radix select of the k-th flushed magnitude in
// 4 digit passes and 10 barriers, then the reference's 40 bisection steps
// as a scalar recurrence: the same lo, bit for bit), then
// vals = mask ? x : 0 and an int8 mask. The TPU kernel tiles 8 rows x block
// lanes and needs block % 128 == 0 and nb % 8 == 0; here one CTA owns one
// row, any block and any nb. A row of up to block_select::MAX_BLOCK (16384)
// is held in registers and read once; a longer one goes to
// block_topk_wide_kernel (select_kth_wide, the same lo), which re-reads it
// from device memory in each of the 4 passes and for the outputs (5 reads).
//
// Bound on the card: bytes. x is read once (4 B an element) and vals + mask
// written once (5 B): 9 B an element. The digit passes run on the row held
// in registers: a shift, a compare and at most one shared atomic an element
// a pass.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

using namespace block_select;

template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                  int8_t* __restrict__ mask, int block, int k) {
  __shared__ Scratch s;
  const size_t base = (size_t)blockIdx.x * block;
  float v[ITEMS];
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) {
      const int idx = item_index<true>(4 * j);
      const float4 q = idx < block ? x4[idx >> 2] : make_float4(0, 0, 0, 0);
      v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = item_index<false>(i);
      v[i] = idx < block ? x[base + idx] : 0.0f;
    }
  }
  const float lo = select_kth<VEC>(v, block, k, s);
  float out[ITEMS];
  unsigned m = 0u;                               // bit i: element i kept
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool keep = flush(fabsf(v[i])) >= lo;
    out[i] = keep ? v[i] : 0.0f;
    m |= (keep ? 1u : 0u) << i;
  }
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) {
      const int idx = item_index<true>(4 * j);
      if (idx < block) {
        reinterpret_cast<float4*>(vals + base)[idx >> 2] = make_float4(
            out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
        // four int8 0/1 flags in one 32-bit store (little-endian)
        const unsigned nib = (m >> (4 * j)) & 0xfu;
        reinterpret_cast<unsigned*>(mask + base)[idx >> 2] =
            (nib & 1u) | ((nib >> 1) & 1u) << 8 | ((nib >> 2) & 1u) << 16 |
            (nib >> 3) << 24;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = item_index<false>(i);
      if (idx < block) {
        vals[base + idx] = out[i];
        mask[base + idx] = (m >> i) & 1u;
      }
    }
  }
}

__global__ void __launch_bounds__(WIDE_THREADS)
block_topk_wide_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int8_t* __restrict__ mask, int block, int k) {
  __shared__ Scratch s;
  const size_t base = (size_t)blockIdx.x * block;
  const float* row = x + base;
  auto value = [row](int i) { return row[i]; };
  const float lo = select_kth_wide(value, block, k, s);
  for_each_wide(value, block, [&](int idx, float v) {
    const bool m = flush(fabsf(v)) >= lo;
    vals[base + idx] = m ? v : 0.0f;
    mask[base + idx] = m ? 1 : 0;
  });
}

}  // namespace

// x: [nb, block] f32 contiguous; vals: [nb, block] f32 out; mask:
// [nb, block] int8 out; block >= 1, 1 <= k <= block.
extern "C" int block_topk_launch(const void* x, void* vals, void* mask,
                                 long long nb, int block, int k,
                                 void* stream) {
  if (block < 1 || k < 1 || k > block || nb < 1 || nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  auto* vp = static_cast<float*>(vals);
  auto* mp = static_cast<int8_t*>(mask);
  if (block <= MAX_BLOCK) {
    const bool vec =
        block % 4 == 0 &&
        ((uintptr_t)x | (uintptr_t)vals | (uintptr_t)mask) % 16 == 0;
    if (vec)
      block_topk_kernel<true><<<(unsigned)nb, threads_for(block), 0, st>>>(
          xp, vp, mp, block, k);
    else
      block_topk_kernel<false><<<(unsigned)nb, threads_for(block), 0, st>>>(
          xp, vp, mp, block, k);
  } else {
    block_topk_wide_kernel<<<(unsigned)nb, WIDE_THREADS, 0, st>>>(
        xp, vp, mp, block, k);
  }
  return (int)cudaGetLastError();
}
