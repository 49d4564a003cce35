// ef_update: the fused error-feedback step on g, e [nb, block]:
//
//   corrected = e + g
//   mask      = block Top-K of |corrected| (the bisection of block_select.cuh)
//   send      = mask ? corrected : 0
//   residual' = corrected - send
//
// Replaces the Pallas TPU kernel src/repro/kernels/ef_update.py
// (ef_update_pallas / _ef_update_kernel). The add reads denormal operands as
// zero and writes a denormal sum as zero, as the reference's platforms do
// (block_select.cuh); every add and subtract is an explicit round-to-nearest
// intrinsic. One CTA owns one row, any block, any nb: a row of up to 16384
// is held in registers, a longer one goes to ef_update_wide_kernel, which
// recomputes corrected from g and e at every step (select_lo_wide: the same
// bisection, the same lo).
//
// Bound on the card: bytes. g and e are read once (8 B an element), send and
// residual' written once (8 B): 16 B an element; the 40 counts run on the
// row held in registers.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

using namespace block_select;

__global__ void __launch_bounds__(MAX_THREADS)
ef_update_kernel(const float* __restrict__ g, const float* __restrict__ e,
                 float* __restrict__ send, float* __restrict__ res, int block,
                 int k) {
  __shared__ Scratch s;
  const size_t base = (size_t)blockIdx.x * block;
  float v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    v[i] = idx < block
               ? flush(__fadd_rn(flush(e[base + idx]), flush(g[base + idx])))
               : 0.0f;
  }
  const float lo = select_lo(v, block, k, s);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < block) {
      const float out = fabsf(v[i]) >= lo ? v[i] : 0.0f;
      send[base + idx] = out;
      res[base + idx] = __fsub_rn(v[i], out);
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
ef_update_wide_kernel(const float* __restrict__ g, const float* __restrict__ e,
                      float* __restrict__ send, float* __restrict__ res,
                      int block, int k) {
  __shared__ Scratch s;
  const size_t base = (size_t)blockIdx.x * block;
  const float* gr = g + base;
  const float* er = e + base;
  auto corrected = [gr, er](int i) {
    return flush(__fadd_rn(flush(er[i]), flush(gr[i])));
  };
  const float lo = select_lo_wide(corrected, block, k, s);
  for (int idx = threadIdx.x; idx < block; idx += blockDim.x) {
    const float v = corrected(idx);
    const float out = fabsf(v) >= lo ? v : 0.0f;
    send[base + idx] = out;
    res[base + idx] = __fsub_rn(v, out);
  }
}

}  // namespace

// g, e: [nb, block] f32 contiguous; send, res: [nb, block] f32 out;
// block >= 1, 1 <= k <= block.
extern "C" int ef_update_launch(const void* g, const void* e, void* send,
                                void* res, long long nb, int block, int k,
                                void* stream) {
  if (block < 1 || k < 1 || k > block || nb < 1 || nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (block > MAX_BLOCK) {
    ef_update_wide_kernel<<<(unsigned)nb, MAX_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const float*>(e),
        static_cast<float*>(send), static_cast<float*>(res), block, k);
    return (int)cudaGetLastError();
  }
  ef_update_kernel<<<(unsigned)nb, threads_for(block), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(e),
      static_cast<float*>(send), static_cast<float*>(res), block, k);
  return (int)cudaGetLastError();
}
