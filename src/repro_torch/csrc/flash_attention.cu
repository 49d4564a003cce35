// flash_attention: forward attention with online softmax over heads-
// flattened q [BH, Sq, D] and k, v [BH, Sk, D], causal (q_pos >= k_pos,
// positions aligned at the top left) or full.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel). The arithmetic is the reference's: q is read as f32 and
// multiplied by scale = 1/sqrt(D) before the dot product; masked scores are
// -1e30; per query row the running max m, denominator l and accumulator acc
// are f32, with p = expf(s - m_new), alpha = expf(m - m_new),
// l = l * alpha + sum p, acc = acc * alpha + p @ v; the output is
// acc / max(l, 1e-30) in q's dtype (f32 or bf16). expf, not __expf, and no
// fast-math: the plain PyTorch twin (kernels/flash_attention.py) is held to
// this kernel within the summation-order bound (D + Sk) * 2^-24 * max|v|.
//
// Design (simple first). One CTA of 256 threads per (bh, tile of 64 query
// rows), heavier (later) query tiles first. Keys stream through shared
// memory in tiles of 64: q (pre-scaled) and k are staged transposed
// ([D][64 + 4], f32), v as [64][D] f32. Each thread owns a 4 x 4 micro-tile
// of the 64 x 64 scores (rows 4*ty.., keys 4*tx..) and reduces the row max
// and row sum over the 16 threads of its row group with warp shuffles; the
// probabilities go through shared memory ([64][64 + 4]) to the PV product,
// where the same thread owns rows 4*ty.. and D/16 output dims. Everything
// is f32 on the CUDA cores: no tensor cores, no TMA. Key tiles that lie
// wholly above the diagonal are skipped: key 0 is valid for every row, so
// such a tile would add p = expf(-1e30 - m) = 0 with alpha = 1.
//
// Bound on the card, at the serve shape [B=4, S=2048, H=32, D=64] bf16:
// causal work is 4*B*H*Sq*Sk*D/2 = 68.7 GFLOP, 0.069 ms at 989 TFLOP/s
// (bf16 tensor cores) and 1.03 ms at 67 TFLOP/s (f32); q, k, v and o in
// bf16 are 134 MB, 0.040 ms at 3.35 TB/s. This design runs the bf16 case on
// the CUDA cores, so it sits far above the bf16 bound (and at best at the
// f32 one): moving both products onto wgmma is the next step.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int TS = BQ + 4;    // row stride of the transposed q / k tiles
constexpr int PS = BK + 4;    // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

// 16 bytes of global memory -> f32 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [r0, r0 + 64) of a [S, D] matrix into shared memory as f32, zero
// past S. Transposed (q, k): dst[d * TS + r], q times `scale`; two
// neighbouring threads read the two 16-byte halves of one 32-byte sector
// of a row, and the 16 thread pairs of a warp take 16 rows, so the
// transposed stores hit distinct banks but for pairs.
template <typename T, int D, bool SCALE>
__device__ __forceinline__ void stage_t(const T* __restrict__ src, int r0,
                                        int S, float* __restrict__ dst,
                                        float scale) {
  constexpr int VE = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int NC = D / VE;                  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BQ * NC; c += THREADS) {
    const int r = (c / 2) % BQ;
    const int d0 = (c % 2 + 2 * (c / (2 * BQ))) * VE;
    float vals[VE];
    if (r0 + r < S) {
      load16(src + (size_t)(r0 + r) * D + d0, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VE; ++e)
      dst[(d0 + e) * TS + r] = SCALE ? __fmul_rn(vals[e], scale) : vals[e];
  }
}

// Row-major (v): dst[r * D + d], consecutive threads on consecutive chunks
// of a row, float4 stores.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int r0,
                                           int S, float* __restrict__ dst) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int NC = D / VE;
  for (int c = threadIdx.x; c < BK * NC; c += THREADS) {
    const int r = c / NC;
    const int d0 = (c % NC) * VE;
    float vals[VE];
    if (r0 + r < S) {
      load16(src + (size_t)(r0 + r) * D + d0, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VE; e += 4)
      *reinterpret_cast<float4*>(dst + r * D + d0 + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// max / sum over the 16 threads of a row group (lanes sharing ty: one half
// of a warp)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr int smem_floats() {
  return 2 * D * TS + BK * D + BQ * PS;
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int bh_count, int Sq,
          int Sk, int n_qt, float scale) {
  constexpr int DT = D / 16;                 // output dims per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                          // [D][TS], pre-scaled
  float* Kt = Qt + D * TS;                   // [D][TS]
  float* Vs = Kt + D * TS;                   // [BK][D]
  float* Ps = Vs + BK * D;                   // [BQ][PS]

  const int bh = blockIdx.x % bh_count;
  const int qt = n_qt - 1 - blockIdx.x / bh_count;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  stage_t<T, D, true>(qb, q0, Sq, Qt, scale);

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) acc[i][dd] = 0.0f;
  }

  const int k_end = CAUSAL ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    stage_t<T, D, false>(kb, k0, Sk, Kt, 1.0f);
    stage_rows<T, D>(vb, k0, Sk, Vs);
    __syncthreads();

    // scores of rows 4*ty + i, keys 4*tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * TS + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * TS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, online softmax (row groups of 16 threads), probabilities out
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        if (kp >= Sk)
          s[i][j] = -INFINITY;               // no such key: p = 0
        else if (CAUSAL && qp < kp)
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) acc[i][dd] *= alpha;
      *reinterpret_cast<float4*>(Ps + (4 * ty + i) * PS + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc[rows 4*ty + i][dims DT*tx + dd] += P @ V
#pragma unroll 2
    for (int j0 = 0; j0 < BK; j0 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds<4>(Ps + (4 * ty + i) * PS + j0, p[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float vv[DT];
        lds<DT>(Vs + (j0 + j) * D + DT * tx, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int dd = 0; dd < DT; ++dd)
            acc[i][dd] = fmaf(p[i][j], vv[dd], acc[i][dd]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = o + ((size_t)bh * Sq + r) * D + DT * tx;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) store(dst + dd, acc[i][dd] / den);
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd<T, D, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq + BQ - 1) / BQ;
  const long long blocks = (long long)n_qt * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, sq, sk, n_qt, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL>
int by_dim(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int d, float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16, CAUSAL>(q, k, v, o, bh, sq, sk, scale, st);
    case 32: return launch<T, 32, CAUSAL>(q, k, v, o, bh, sq, sk, scale, st);
    case 64: return launch<T, 64, CAUSAL>(q, k, v, o, bh, sq, sk, scale, st);
    case 128:
      return launch<T, 128, CAUSAL>(q, k, v, o, bh, sq, sk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [bh, sq, d]; k, v: [bh, sk, d]; o: [bh, sq, d]; all contiguous, of
// one dtype (0: f32, 1: bf16), 16-byte aligned; d in {16, 32, 64, 128}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, long long bh,
                                      int sq, int sk, int d, int dtype,
                                      int causal, float scale, void* stream) {
  if (bh < 1 || bh > 0x7fffffffLL || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (int)bh;
  if (dtype == 0)
    return causal ? by_dim<float, true>(q, k, v, o, n, sq, sk, d, scale, st)
                  : by_dim<float, false>(q, k, v, o, n, sq, sk, d, scale, st);
  if (dtype == 1)
    return causal
               ? by_dim<__nv_bfloat16, true>(q, k, v, o, n, sq, sk, d, scale,
                                             st)
               : by_dim<__nv_bfloat16, false>(q, k, v, o, n, sq, sk, d, scale,
                                              st);
  return (int)cudaErrorInvalidValue;
}
