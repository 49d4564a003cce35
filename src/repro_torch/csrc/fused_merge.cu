// fused_merge: EF + Top-K mask + codec + active gating + OPWA + weighted merge
// in one pass over the [C, n] client updates.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_merge.py
// (fused_merge_pallas / _fused_merge_kernel). Per column, in the order of
// fused_merge.py:86-109:
//
//   corrected = e + x                        (EF configs)
//   mask      = bits(|corrected|) >= th[c]   (ties kept)
//   v         = mask ? corrected : 0
//   v         = clip(rint(v / safe), -L, L) * scale[c]      (int8/int4 codec)
//   residual' = corrected - v, or e for inactive rows       (EF configs)
//   v         = v * active[c];  mask &= active[c] > 0.5     (padded cohorts)
//   acc      += w[c] * v;       count += mask
//   agg       = (0 < count <= D ? gamma : 1) * acc           (OPWA)
//
// Each thread owns one column (four with float4 loads) and walks the clients
// in the fixed order 0..C-1, so the sum has one order that the plain PyTorch
// twin (kernels/fused_merge.py) repeats with a Python loop over rows; the
// kernel matches it bit for bit. Every multiply and add is an explicit
// round-to-nearest intrinsic (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn):
// nvcc would otherwise contract w*v + acc into an fma, and the divide must be
// correctly rounded (never --use_fast_math). rintf rounds half to even, as
// torch.round and jnp.round do.
//
// Bound on the card: bytes. Each input element is read once and each output
// written once: x (+ e) in, agg (+ residual') out — C*n*4*(1 + 2*EF) + n*4
// bytes. No intermediate touches device memory. The per-client columns
// (th, w, scale, active) are a few bytes each and stay in L1.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Params {
  const float* x;
  const float* e;        // null: no EF
  const int* th;         // [C] threshold bit patterns
  const float* w;        // [C] merge weights
  const float* scales;   // [C] codec scales (levels > 0)
  const float* active;   // [C] 1.0 / 0.0 or null
  float* agg;            // [n]
  float* res;            // [C, n] (EF configs)
  long long n;
  int C;
  int opwa;
  float gamma;
  int d;
  float levels;                       // 0: no codec; 127 int8; 7 int4
};

// One client's contribution to one column; returns residual'.
template <bool EF>
__device__ __forceinline__ float step(const Params& p, int c, float xv,
                                      float ev, float& acc, int& cnt) {
  const float corrected = EF ? __fadd_rn(ev, xv) : xv;
  const unsigned bits = __float_as_uint(fabsf(corrected));
  bool mask = bits >= (unsigned)p.th[c];
  float v = mask ? corrected : 0.0f;
  if (p.levels > 0.0f) {
    const float sc = p.scales[c];
    const float safe = sc > 0.0f ? sc : 1.0f;
    float q = rintf(__fdiv_rn(v, safe));
    // clip written with comparisons so a NaN passes through, as torch.clamp
    q = q < -p.levels ? -p.levels : (q > p.levels ? p.levels : q);
    v = __fmul_rn(q, sc);
  }
  float r = 0.0f;
  if (EF) r = __fsub_rn(corrected, v);
  if (p.active != nullptr) {
    const float a = p.active[c];
    const bool on = a > 0.5f;
    if (EF && !on) r = ev;
    v = __fmul_rn(v, a);
    mask = mask && on;
  }
  acc = __fadd_rn(acc, __fmul_rn(p.w[c], v));
  cnt += mask ? 1 : 0;
  return r;
}

__device__ __forceinline__ float finish(const Params& p, float acc, int cnt) {
  if (!p.opwa) return acc;
  const float m = (cnt > 0 && cnt <= p.d) ? p.gamma : 1.0f;
  return __fmul_rn(m, acc);
}

template <bool EF>
__global__ void __launch_bounds__(THREADS) merge_scalar(Params p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < p.n; j += stride) {
    float acc = 0.0f;
    int cnt = 0;
    for (int c = 0; c < p.C; ++c) {
      const size_t o = (size_t)c * p.n + j;
      const float r = step<EF>(p, c, p.x[o], EF ? p.e[o] : 0.0f, acc, cnt);
      if (EF) p.res[o] = r;
    }
    p.agg[j] = finish(p, acc, cnt);
  }
}

template <bool EF>
__global__ void __launch_bounds__(THREADS) merge_vec4(Params p) {
  const long long n4 = p.n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n4; j += stride) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int cnt[4] = {0, 0, 0, 0};
    for (int c = 0; c < p.C; ++c) {
      const size_t o = (size_t)c * n4 + j;
      const float4 xv = reinterpret_cast<const float4*>(p.x)[o];
      float4 ev = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (EF) ev = reinterpret_cast<const float4*>(p.e)[o];
      float4 r;
      r.x = step<EF>(p, c, xv.x, ev.x, acc[0], cnt[0]);
      r.y = step<EF>(p, c, xv.y, ev.y, acc[1], cnt[1]);
      r.z = step<EF>(p, c, xv.z, ev.z, acc[2], cnt[2]);
      r.w = step<EF>(p, c, xv.w, ev.w, acc[3], cnt[3]);
      if (EF) reinterpret_cast<float4*>(p.res)[o] = r;
    }
    float4 out;
    out.x = finish(p, acc[0], cnt[0]);
    out.y = finish(p, acc[1], cnt[1]);
    out.z = finish(p, acc[2], cnt[2]);
    out.w = finish(p, acc[3], cnt[3]);
    reinterpret_cast<float4*>(p.agg)[j] = out;
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// x, e, res: [C, n] f32 contiguous (e and res null without EF); th: [C] i32;
// w, scales, active: [C] f32 (scales null without a codec, active may be
// null); agg: [n] f32 out. levels: 0 (no codec), 127 (int8) or 7 (int4).
extern "C" int fused_merge_launch(const void* x, const void* e,
                                  const void* th, const void* w,
                                  const void* scales, const void* active,
                                  void* agg, void* res, long long n, int C,
                                  int opwa, float gamma, int d, float levels,
                                  void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.e = static_cast<const float*>(e);
  p.th = static_cast<const int*>(th);
  p.w = static_cast<const float*>(w);
  p.scales = static_cast<const float*>(scales);
  p.active = static_cast<const float*>(active);
  p.agg = static_cast<float*>(agg);
  p.res = static_cast<float*>(res);
  p.n = n;
  p.C = C;
  p.opwa = opwa;
  p.gamma = gamma;
  p.d = d;
  p.levels = levels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const bool ef = e != nullptr;
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(e) &&
                   aligned16(agg) && aligned16(res);
  const long long items = vec ? n / 4 : n;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  const dim3 grid((unsigned)blocks);
  if (vec) {
    if (ef) merge_vec4<true><<<grid, THREADS, 0, st>>>(p);
    else merge_vec4<false><<<grid, THREADS, 0, st>>>(p);
  } else {
    if (ef) merge_scalar<true><<<grid, THREADS, 0, st>>>(p);
    else merge_scalar<false><<<grid, THREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}
