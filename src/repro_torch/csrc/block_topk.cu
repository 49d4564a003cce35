// block_topk: per-row magnitude Top-K of x [nb, block] by value bisection.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_topk.py
// (block_topk_pallas / _block_topk_kernel): the 40-step bisection of
// block_select.cuh, then vals = mask ? x : 0 and an int8 mask. The TPU
// kernel tiles 8 rows x block lanes and needs block % 128 == 0 and
// nb % 8 == 0; here one CTA owns one row, any block from 1 to
// block_select::MAX_BLOCK (16384) and any nb.
//
// Bound on the card: bytes. x is read once (4 B an element) and vals + mask
// written once (5 B): 9 B an element. The 40 counts run on the row held in
// registers; ~41 compares an element are far below the f32 rate.
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

}  // namespace

// x: [nb, block] f32 contiguous; vals: [nb, block] f32 out; mask:
// [nb, block] int8 out; 1 <= block <= 16384, 1 <= k <= block.
extern "C" int block_topk_launch(const void* x, void* vals, void* mask,
                                 long long nb, int block, int k,
                                 void* stream) {
  if (block < 1 || block > MAX_BLOCK || k < 1 || k > block || nb < 1 ||
      nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  block_topk_kernel<<<(unsigned)nb, threads_for(block), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int8_t*>(mask), block, k);
  return (int)cudaGetLastError();
}
