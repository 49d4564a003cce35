// threshold_find: exact per-client k-th-largest |x| (or |e + x|) at runtime k.
//
// Replaces the Pallas TPU kernel src/repro/kernels/threshold_find.py
// (threshold_find_pallas / _threshold_find_kernel). Same 16-ary search on the
// f32 bit pattern of the magnitude: 8 sweeps, 15 candidate boundaries
// lo + j*step per sweep, the new lo is the largest boundary whose count is
// still >= k. After 8 sweeps lo is the k-th-largest pattern (ties kept).
//
// What differs from the TPU: the Pallas kernel carries lo and the boundary
// counts in VMEM scratch across a sequential grid. Hopper blocks run in no
// order, so each sweep is one launch over (column chunk, client) blocks that
// add their integer counts into per-(sweep, client, boundary) int32 counters
// with atomicAdd; every block of the next sweep replays lo from the counters
// of the sweeps before it (a handful of reads), and a last one-thread-per-
// client launch writes the thresholds. Integer counts make the result
// independent of the order of the atomics. The optional row absmax rides on
// sweep 0: atomicMax on the non-negative f32 bit pattern is exact, so it is
// deterministic too. The ragged edge is masked in the loop, never padded.
//
// Bound on the card: bytes. The work is one read of x (and e) per sweep plus
// 15 integer compares per element; the least the card could do is one read
// (C*n*4 bytes, twice with EF). This simple version reads 8 times, so it is
// ~8x above its bound by design; fusing the sweeps (a radix select on data
// kept in shared memory, or one cooperative launch) is a later PR's work.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the last launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WAYS = 16;
constexpr int BOUNDS = WAYS - 1;
constexpr int SWEEPS = 8;
constexpr unsigned STEP0 = (1u << 31) / WAYS;   // 2^27: span 2^31 in 16 buckets
constexpr int THREADS = 256;

__device__ __forceinline__ unsigned sweep_step(int s) {
  // interval width 2^31 / 16^s -> boundary spacing, floored at 1 (sweep 7)
  unsigned st = STEP0 >> (4 * s);
  return st > 0u ? st : 1u;
}

// lo of client c at the start of sweep s, replayed from the finished counts
// of sweeps 0..s-1 (counts of boundary j are non-increasing in j, so the
// largest qualifying j is the last one that qualifies).
__device__ unsigned replay_lo(const int* __restrict__ counts, int c, int C,
                              int k, int s) {
  unsigned lo = 0u;
  for (int t = 0; t < s; ++t) {
    const int* cnt = counts + ((size_t)t * C + c) * BOUNDS;
    unsigned jsel = 0u;
    for (int j = 1; j < WAYS; ++j)
      if (cnt[j - 1] >= k) jsel = (unsigned)j;
    lo += jsel * sweep_step(t);
  }
  return lo;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) {
    unsigned u = __shfl_down_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

struct Tally {
  unsigned b[BOUNDS];
  int cnt[BOUNDS];
  unsigned amax;

  __device__ __forceinline__ void visit(float v, bool scale) {
    const unsigned bits = __float_as_uint(fabsf(v));
#pragma unroll
    for (int j = 0; j < BOUNDS; ++j) cnt[j] += bits >= b[j] ? 1 : 0;
    if (scale) amax = bits > amax ? bits : amax;
  }
};

// One sweep: grid (chunks, C). VEC reads float4 (n % 4 == 0, 16-byte aligned
// rows); otherwise one float per thread step with the edge masked by the
// loop bound.
template <bool EF, bool SCALE, bool VEC>
__global__ void __launch_bounds__(THREADS)
count_kernel(const float* __restrict__ x, const float* __restrict__ e,
             const int* __restrict__ ks, int* __restrict__ counts,
             unsigned* __restrict__ absmax_bits, long long n, int C, int s) {
  const int c = blockIdx.y;
  __shared__ unsigned s_lo;
  __shared__ int s_cnt[BOUNDS];
  __shared__ unsigned s_amax;
  if (threadIdx.x == 0) {
    s_lo = replay_lo(counts, c, C, ks[c], s);
    s_amax = 0u;
  }
  if (threadIdx.x < BOUNDS) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  Tally t;
  const unsigned lo = s_lo, step = sweep_step(s);
#pragma unroll
  for (int j = 0; j < BOUNDS; ++j) {
    t.b[j] = lo + (unsigned)(j + 1) * step;   // < 2^32: lo + 15 at sweep 7
    t.cnt[j] = 0;
  }
  t.amax = 0u;

  const float* xr = x + (size_t)c * n;
  const float* er = EF ? e + (size_t)c * n : nullptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* e4 = reinterpret_cast<const float4*>(er);
    for (; i < n / 4; i += stride) {
      float4 v = x4[i];
      if (EF) {
        const float4 r = e4[i];
        v.x = __fadd_rn(r.x, v.x); v.y = __fadd_rn(r.y, v.y);
        v.z = __fadd_rn(r.z, v.z); v.w = __fadd_rn(r.w, v.w);
      }
      t.visit(v.x, SCALE); t.visit(v.y, SCALE);
      t.visit(v.z, SCALE); t.visit(v.w, SCALE);
    }
  } else {
    for (; i < n; i += stride) {
      const float v = EF ? __fadd_rn(er[i], xr[i]) : xr[i];
      t.visit(v, SCALE);
    }
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < BOUNDS; ++j) {
    const int v = warp_sum(t.cnt[j]);
    if (lane == 0 && v) atomicAdd(&s_cnt[j], v);
  }
  if (SCALE) {
    const unsigned m = warp_max(t.amax);
    if (lane == 0) atomicMax(&s_amax, m);
  }
  __syncthreads();
  if (threadIdx.x < BOUNDS && s_cnt[threadIdx.x])
    atomicAdd(&counts[((size_t)s * C + c) * BOUNDS + threadIdx.x],
              s_cnt[threadIdx.x]);
  if (SCALE && threadIdx.x == 0) atomicMax(&absmax_bits[c], s_amax);
}

__global__ void finalize_kernel(const int* __restrict__ counts,
                                const int* __restrict__ ks,
                                int* __restrict__ th, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) th[c] = (int)replay_lo(counts, c, C, ks[c], SWEEPS);
}

template <bool EF, bool VEC>
cudaError_t run_sweep(dim3 grid, cudaStream_t st, const float* x,
                      const float* e, const int* ks, int* counts,
                      unsigned* absmax, long long n, int C, int s) {
  if (absmax != nullptr && s == 0)
    count_kernel<EF, true, VEC><<<grid, THREADS, 0, st>>>(
        x, e, ks, counts, absmax, n, C, s);
  else
    count_kernel<EF, false, VEC><<<grid, THREADS, 0, st>>>(
        x, e, ks, counts, absmax, n, C, s);
  return cudaGetLastError();
}

}  // namespace

// x, e: [C, n] f32 contiguous (e may be null: no EF); ks: [C] i32 with
// 1 <= k <= n; th: [C] i32 out (the threshold pattern, always < 2^31);
// absmax: [C] f32 out or null; counts: [8, C, 15] i32 scratch.
extern "C" int threshold_find_launch(const void* x, const void* e,
                                     const void* ks, void* th, void* absmax,
                                     void* counts, long long n, int C,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* ef = static_cast<const float*>(e);
  const int* k = static_cast<const int*>(ks);
  int* cnt = static_cast<int*>(counts);
  unsigned* am = static_cast<unsigned*>(absmax);

  cudaError_t err = cudaMemsetAsync(
      cnt, 0, sizeof(int) * (size_t)SWEEPS * C * BOUNDS, st);
  if (err != cudaSuccess) return err;
  if (am != nullptr) {
    err = cudaMemsetAsync(am, 0, sizeof(unsigned) * (size_t)C, st);
    if (err != cudaSuccess) return err;
  }
  const bool aligned =
      (reinterpret_cast<uintptr_t>(xf) % 16 == 0) &&
      (ef == nullptr || reinterpret_cast<uintptr_t>(ef) % 16 == 0);
  const bool vec = aligned && (n % 4 == 0);
  const long long items = vec ? n / 4 : n;
  long long want = (items + THREADS - 1) / THREADS;
  long long cap = 1056 / C;        // ~8 blocks per SM over the whole grid
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)C);

  for (int s = 0; s < SWEEPS; ++s) {
    if (ef != nullptr)
      err = vec ? run_sweep<true, true>(grid, st, xf, ef, k, cnt, am, n, C, s)
                : run_sweep<true, false>(grid, st, xf, ef, k, cnt, am, n, C, s);
    else
      err = vec ? run_sweep<false, true>(grid, st, xf, ef, k, cnt, am, n, C, s)
                : run_sweep<false, false>(grid, st, xf, ef, k, cnt, am, n, C, s);
    if (err != cudaSuccess) return err;
  }
  finalize_kernel<<<(C + 127) / 128, 128, 0, st>>>(cnt, k, static_cast<int*>(th),
                                                   C);
  return cudaGetLastError();
}
