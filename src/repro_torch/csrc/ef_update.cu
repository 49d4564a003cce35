// ef_update: the fused error-feedback step on g, e [nb, block]:
//
//   corrected = e + g
//   mask      = block Top-K of |corrected| (the selection of block_select.cuh)
//   send      = mask ? corrected : 0
//   residual' = corrected - send
//
// Replaces the Pallas TPU kernel src/repro/kernels/ef_update.py
// (ef_update_pallas / _ef_update_kernel). The add reads denormal operands as
// zero and writes a denormal sum as zero, as the reference's platforms do
// (block_select.cuh); every add and subtract is an explicit round-to-nearest
// intrinsic. The selection is an exact radix select of the k-th magnitude
// (4 digit passes, 10 barriers) followed by the reference's 40 bisection
// steps as a scalar recurrence: the reference's lo, bit for bit. One CTA
// owns one row, any block, any nb: a row of up to 16384 is held in
// registers and read once, a longer one goes to ef_update_wide_kernel
// (select_kth_wide, the same lo), which re-reads g and e and recomputes
// corrected in each of the 4 passes and for the outputs (5 reads).
//
// Bound on the card: bytes. g and e are read once (8 B an element), send and
// residual' written once (8 B): 16 B an element; the digit passes run on the
// row held in registers.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

using namespace block_select;

// corrected = e + g, each operand and the sum flushed
__device__ __forceinline__ float correct(float e, float g) {
  return flush(__fadd_rn(flush(e), flush(g)));
}

template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
ef_update_kernel(const float* __restrict__ g, const float* __restrict__ e,
                 float* __restrict__ send, float* __restrict__ res, int block,
                 int k) {
  __shared__ Scratch s;
  const size_t base = (size_t)blockIdx.x * block;
  float v[ITEMS];
  if constexpr (VEC) {
    const float4* g4 = reinterpret_cast<const float4*>(g + base);
    const float4* e4 = reinterpret_cast<const float4*>(e + base);
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) {
      const int idx = item_index<true>(4 * j);
      const float4 z = make_float4(0, 0, 0, 0);
      const float4 a = idx < block ? e4[idx >> 2] : z;
      const float4 b = idx < block ? g4[idx >> 2] : z;
      v[4 * j] = correct(a.x, b.x), v[4 * j + 1] = correct(a.y, b.y);
      v[4 * j + 2] = correct(a.z, b.z), v[4 * j + 3] = correct(a.w, b.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = item_index<false>(i);
      v[i] = idx < block ? correct(e[base + idx], g[base + idx]) : 0.0f;
    }
  }
  const float lo = select_kth<VEC>(v, block, k, s);
  float out[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) out[i] = fabsf(v[i]) >= lo ? v[i] : 0.0f;
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) {
      const int idx = item_index<true>(4 * j);
      if (idx < block) {
        const float* o = out + 4 * j;
        const float* w = v + 4 * j;
        reinterpret_cast<float4*>(send + base)[idx >> 2] =
            make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(res + base)[idx >> 2] = make_float4(
            __fsub_rn(w[0], o[0]), __fsub_rn(w[1], o[1]),
            __fsub_rn(w[2], o[2]), __fsub_rn(w[3], o[3]));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = item_index<false>(i);
      if (idx < block) {
        send[base + idx] = out[i];
        res[base + idx] = __fsub_rn(v[i], out[i]);
      }
    }
  }
}

__global__ void __launch_bounds__(WIDE_THREADS)
ef_update_wide_kernel(const float* __restrict__ g, const float* __restrict__ e,
                      float* __restrict__ send, float* __restrict__ res,
                      int block, int k) {
  __shared__ Scratch s;
  const size_t base = (size_t)blockIdx.x * block;
  const float* gr = g + base;
  const float* er = e + base;
  auto corrected = [gr, er](int i) { return correct(er[i], gr[i]); };
  const float lo = select_kth_wide(corrected, block, k, s);
  for_each_wide(corrected, block, [&](int idx, float v) {
    const float out = fabsf(v) >= lo ? v : 0.0f;
    send[base + idx] = out;
    res[base + idx] = __fsub_rn(v, out);
  });
}

}  // namespace

// g, e: [nb, block] f32 contiguous; send, res: [nb, block] f32 out;
// block >= 1, 1 <= k <= block.
extern "C" int ef_update_launch(const void* g, const void* e, void* send,
                                void* res, long long nb, int block, int k,
                                void* stream) {
  if (block < 1 || k < 1 || k > block || nb < 1 || nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* ep = static_cast<const float*>(e);
  auto* sp = static_cast<float*>(send);
  auto* rp = static_cast<float*>(res);
  if (block <= MAX_BLOCK) {
    const bool vec = block % 4 == 0 && ((uintptr_t)g | (uintptr_t)e |
                                        (uintptr_t)send | (uintptr_t)res) %
                                               16 == 0;
    if (vec)
      ef_update_kernel<true><<<(unsigned)nb, threads_for(block), 0, st>>>(
          gp, ep, sp, rp, block, k);
    else
      ef_update_kernel<false><<<(unsigned)nb, threads_for(block), 0, st>>>(
          gp, ep, sp, rp, block, k);
  } else {
    ef_update_wide_kernel<<<(unsigned)nb, WIDE_THREADS, 0, st>>>(
        gp, ep, sp, rp, block, k);
  }
  return (int)cudaGetLastError();
}
