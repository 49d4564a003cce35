// block_topk: per-row magnitude Top-K of x [nb, block] by value bisection.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_topk.py
// (block_topk_pallas / _block_topk_kernel): the 40-step bisection of
// block_select.cuh, then vals = mask ? x : 0 and an int8 mask. The TPU
// kernel tiles 8 rows x block lanes and needs block % 128 == 0 and
// nb % 8 == 0; here one CTA owns one row, any block and any nb. A row of up
// to block_select::MAX_BLOCK (16384) is held in registers; a longer one
// goes to block_topk_wide_kernel, which re-reads it from device memory at
// every step (select_lo_wide: the same bisection, the same lo).
//
// Bound on the card: bytes. x is read once (4 B an element) and vals + mask
// written once (5 B): 9 B an element. The 40 counts run on the row held in
// registers; ~41 compares an element are far below the f32 rate. The wide
// path reads the row 41 times more, mostly from L2.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

using namespace block_select;

__global__ void __launch_bounds__(MAX_THREADS)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                  int8_t* __restrict__ mask, int block, int k) {
  __shared__ Scratch s;
  const size_t base = (size_t)blockIdx.x * block;
  float v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    v[i] = idx < block ? x[base + idx] : 0.0f;
  }
  const float lo = select_lo(v, block, k, s);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < block) {
      const bool m = flush(fabsf(v[i])) >= lo;
      vals[base + idx] = m ? v[i] : 0.0f;
      mask[base + idx] = m ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
block_topk_wide_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int8_t* __restrict__ mask, int block, int k) {
  __shared__ Scratch s;
  const float* row = x + (size_t)blockIdx.x * block;
  const float lo = select_lo_wide([row](int i) { return row[i]; }, block, k,
                                  s);
  const size_t base = (size_t)blockIdx.x * block;
  for (int idx = threadIdx.x; idx < block; idx += blockDim.x) {
    const float v = row[idx];
    const bool m = flush(fabsf(v)) >= lo;
    vals[base + idx] = m ? v : 0.0f;
    mask[base + idx] = m ? 1 : 0;
  }
}

}  // namespace

// x: [nb, block] f32 contiguous; vals: [nb, block] f32 out; mask:
// [nb, block] int8 out; block >= 1, 1 <= k <= block.
extern "C" int block_topk_launch(const void* x, void* vals, void* mask,
                                 long long nb, int block, int k,
                                 void* stream) {
  if (block < 1 || k < 1 || k > block || nb < 1 || nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (block > MAX_BLOCK) {
    block_topk_wide_kernel<<<(unsigned)nb, MAX_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(vals),
        static_cast<int8_t*>(mask), block, k);
    return (int)cudaGetLastError();
  }
  block_topk_kernel<<<(unsigned)nb, threads_for(block), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int8_t*>(mask), block, k);
  return (int)cudaGetLastError();
}
