// overlap_combine: the OPWA merge of precomputed sparse client updates,
//
//   counts[j] = sum_c masks[c, j]                      (int8 read as int32)
//   acc[j]    = sum_c vals[c, j] * coeffs[c]           (clients 0..K-1)
//   out[j]    = (0 < counts[j] <= d ? gamma : 1) * acc[j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/overlap_combine.py
// (overlap_combine_pallas / _overlap_combine_kernel). One thread owns one
// column (four with float4 / char4 loads when n % 4 == 0) and walks the
// clients in order 0..K-1 from acc = +0.0f, with __fmul_rn / __fadd_rn so
// nvcc contracts nothing into an fma: the plain PyTorch twin
// (kernels/overlap_combine.py) runs the same sum in the same order and the
// two agree bit for bit. The TPU kernel works on 1024-wide tiles of a padded
// n; here the ragged edge is masked by the loop bound.
//
// Bound on the card: bytes. vals (4 B) and masks (1 B) are read once per
// client-element and out (4 B) written once per column; coeffs are K floats.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float finish(float acc, int cnt, float gamma,
                                        int d) {
  return __fmul_rn((cnt > 0 && cnt <= d) ? gamma : 1.0f, acc);
}

__global__ void __launch_bounds__(THREADS)
combine_scalar(const float* __restrict__ vals,
               const int8_t* __restrict__ masks,
               const float* __restrict__ coeffs, float* __restrict__ out,
               long long n, int K, float gamma, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float acc = 0.0f;
    int cnt = 0;
    for (int c = 0; c < K; ++c) {
      const size_t o = (size_t)c * n + j;
      acc = __fadd_rn(acc, __fmul_rn(vals[o], coeffs[c]));
      cnt += masks[o];
    }
    out[j] = finish(acc, cnt, gamma, d);
  }
}

__global__ void __launch_bounds__(THREADS)
combine_vec4(const float4* __restrict__ vals, const char4* __restrict__ masks,
             const float* __restrict__ coeffs, float4* __restrict__ out,
             long long n4, int K, float gamma, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n4;
       j += stride) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (int c = 0; c < K; ++c) {
      const size_t o = (size_t)c * n4 + j;
      const float4 v = vals[o];
      const char4 m = masks[o];
      const float w = coeffs[c];
      a0 = __fadd_rn(a0, __fmul_rn(v.x, w));
      a1 = __fadd_rn(a1, __fmul_rn(v.y, w));
      a2 = __fadd_rn(a2, __fmul_rn(v.z, w));
      a3 = __fadd_rn(a3, __fmul_rn(v.w, w));
      c0 += m.x; c1 += m.y; c2 += m.z; c3 += m.w;
    }
    out[j] = make_float4(finish(a0, c0, gamma, d), finish(a1, c1, gamma, d),
                         finish(a2, c2, gamma, d), finish(a3, c3, gamma, d));
  }
}

}  // namespace

// vals: [K, n] f32 contiguous; masks: [K, n] int8 contiguous; coeffs: [K]
// f32; out: [n] f32. K >= 1, n >= 1.
extern "C" int overlap_combine_launch(const void* vals, const void* masks,
                                      const void* coeffs, void* out,
                                      long long n, int K, float gamma, int d,
                                      void* stream) {
  if (n < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(masks) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long items = vec ? n / 4 : n;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;    // grid-stride beyond this
  if (vec)
    combine_vec4<<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const float4*>(vals), static_cast<const char4*>(masks),
        static_cast<const float*>(coeffs), static_cast<float4*>(out), items, K,
        gamma, d);
  else
    combine_scalar<<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int8_t*>(masks),
        static_cast<const float*>(coeffs), static_cast<float*>(out), n, K,
        gamma, d);
  return (int)cudaGetLastError();
}
