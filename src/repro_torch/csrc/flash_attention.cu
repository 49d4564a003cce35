// flash_attention: forward attention with online softmax over heads-
// flattened q [BH, Sq, D] and k, v [BH, Sk, D], causal (q_pos >= k_pos,
// positions aligned at the top left) or full; f32 or bf16, D in
// {16, 32, 64, 128}, any Sq and Sk.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel). The arithmetic is the reference's: q is read as f32 and
// multiplied by scale = 1/sqrt(D) (__fmul_rn) before the dot product;
// masked scores are -1e30, keys past Sk -inf; per query row the running max
// m, denominator l and accumulator acc are f32, with p = expf(s - m_new),
// alpha = expf(m - m_new), l = l * alpha + sum p, acc = acc * alpha +
// p @ v; the output is acc / max(l, 1e-30) in q's dtype. expf, not __expf,
// and no fast-math; every product and sum outside the two dot products is
// an explicit __fmul_rn / __fadd_rn / fmaf, so the f32 and bf16
// instantiations run the same operations and a bf16 output is the f32
// kernel's on the upcast inputs, rounded to bf16, bit for bit. The CUDA
// cores do all of it: TF32 would change the numerics the bound counts.
//
// Agreement (kernels/flash_attention.f32_twin_bound computes this, per
// element, in f64 from the inputs). Two f32 evaluations that sum keys in
// tiles, this kernel (tiles of 64, dot products and PV sums sequential
// FMAs) and the twin (tiles of blk_k, matmuls in any order), each lie
// within E of the exact function of the same f32 inputs (q already scaled
// and rounded, as both sides scale it), so within 2E of each other. Per
// row, u = 2^-24, w_j the exact softmax weights, o the exact output, and
// per output element d:
//  * scores: a D-term dot product in any order is off by at most
//    gamma_D A_j, gamma_D = D u / (1 - D u), A_j = sum_i |q_i k_ji|; the
//    weight of key j moves by the factor e^(+-gamma_D A_j);
//  * p = expf(s - m): the subtraction's rounding moves the argument by
//    u |s - m| <= u (M - s_j) (M the row's max), expf by 2 ulp (4u); the
//    alphas by 4u + u |m_old - m_new| each time the running max moves, a
//    factor common to every key before that tile (and to l and acc alike),
//    so summed over the row 4u C + u (M - m_first), C the 64-key tiles
//    whose max lies within 2 gamma_D max_j A_j of the running max (the
//    twin's changes are among them when blk_k is a multiple of 64);
//  * a convex combination whose weights move by rho_j moves by at most
//    sum_j w_j rho_j |v_jd - o_d| / (1 - max rho): with Y = sum w A |v| +
//    |o| sum w A, X = sum w (M - s) |v| + |o| sum w (M - s), S = sum w |v|,
//    (gamma_D Y + (4u + 4u C + u (M - m_first)) (S + |o|) + u X) a side;
//  * acc: the kernel adds a tile's 64 products by sequential FMAs onto
//    alpha * acc, each rounding at most u of a partial sum no larger than
//    alpha |acc| + the tile's sum p |v|: 65u of that a tile; the twin rounds
//    alpha * acc, + and its blk_k-term matmul: 2u alpha |acc| and
//    (blk_k + 1)u of the tile's sum. Carried by the later alphas: Z =
//    sum over 64-key tile starts of |sum_{j < start} e^(s_j - M) v_jd|,
//    (67 Z / l + (blk_k + 66) S) u for the two (blk_k a multiple of 64;
//    else the twin's alpha |acc| terms are bounded by (Sk / blk_k) S);
//  * l (positive terms): the kernel's path is 3 adds in a lane's tile
//    sum, 2 roundings a tile and the 16-lane tree at the end, the twin's
//    blk_k - 1 adds and 2 roundings a tile; the division one more each:
//    (9 + 2 Sk/64 + blk_k + 2 Sk/blk_k) u |o|;
//  * p below 2^-126 (no relative guarantee): Sk 2^-148 (max|v| + |o|)
//    a side;
//  * the terms above use the exact weights and partial sums for the
//    computed ones: all of it times (1 + delta) / (1 - delta), delta the
//    largest relative change a weight may take, and 1 + 2^-10 for the f64
//    arithmetic that computes it.
// bf16 outputs: each side rounds its own f32 result, one bf16 ULP of the
// larger on top. The bound is built from the exact weights and the
// inputs, so it grants nothing to a kernel that drops, repeats or
// misweights a key tile (chip_smoke.py plants that fault at 2048 and 32k).
//
// Design. One CTA of 384 threads per (bh, 128 query rows), heavier (later)
// query tiles first. (A persistent grid walking the same longest-first
// list, its producer running on into the next tile of queries, was no
// faster at 32k and slower at 2048: PERF.md.)
//  * Warp 8 is the producer: it streams K and V tiles of 64 keys through a
//    ring of STAGES (3; 2 at D 128) in shared memory, signalled by a full
//    and an empty mbarrier per stage. f32 rows go by cp.async.cg 16-byte
//    copies, zero-filled past Sk, completing on the full barrier
//    (cp.async.mbarrier.arrive.noinc, one arrival per lane); bf16 rows are
//    read 16 bytes at a time, widened to f32 and stored, then the lane
//    arrives. TMA was not taken: an f32 row of D 128 is 512 bytes, four
//    32-float boxes, bf16 must be widened on the way in anyway, and the
//    16-byte copies let the producer write the swizzle below.
//  * Warps 0-7 (two warpgroups) each own 16 whole query rows; warps 9-11
//    only complete the producer's warpgroup. A sub-partition holds one
//    warp of each warpgroup, so the launch bound leaves 168 registers a
//    thread; setmaxnreg gives the producer warpgroup 56 and the consumers
//    224 (at 168 the consumers could not keep the next chunk's operands in
//    flight, and ran slower).
//  * Layout, all f32, row-major [rows][D]: K's 16-byte chunks are
//    XOR-swizzled by row (logical chunk c of row r at c ^ (r % 8); at D
//    16, where a 128-byte line holds two rows, c ^ ((r / 2) % 4)), q's by
//    row parity, V and P not at all. Lane (rg, kg) = (lane / 16, lane %
//    16) computes the scores of rows 2i + rg (i < 8) and keys kg + 16 jj
//    (jj < 4): an 8 x 4 micro-tile, 4 K loads and 8 q loads (16 bytes
//    each) for 128 FMAs over four d-steps, 10.7 FMAs a load. The 16 rows
//    a warp reads at one chunk of K fall in distinct banks (two
//    wavefronts, the least for 256 bytes), q's two rows in distinct banks;
//    each operand needs one address a chunk (loop-invariant XORs), not
//    one a load. K is read row-major; nothing is staged transposed.
//  * The row max is a 4-step xor shuffle within the 16 lanes of a row
//    group; l stays a per-lane partial (rescaled by the same alpha as acc)
//    summed across the 16 lanes once, at the end. P goes to the warp's own
//    [16][PS] slice of shared memory and back after a __syncwarp; the PV
//    product gives lane (rg, dg) rows 2i + rg and D/16 output dims (chunks
//    dg + 16 cc): 8 P loads and 4 V loads for 128 FMAs at D 64, 8 and 8
//    for 256 at D 128. A warp stages its own q rows (pre-scaled) once per
//    tile of queries and releases a stage with one arrival after a
//    __syncwarp: the ring's barriers are the only waits between warps, no
//    __syncthreads after the barriers' initialisation.
//  * Masking only where it matters: a tile wholly at or below a warp's
//    first row and within Sk takes the body without the mask; a tile that
//    crosses the diagonal or Sk takes the masked body; a tile wholly above
//    the warp's last row is skipped (the warp still waits for it and
//    releases it, to keep the ring's phases). Key 0 is valid for every
//    row, so a skipped tile would have added p = expf(-1e30 - m) = 0 at
//    alpha = 1: skipping is exact. alpha == 1 skips the rescale (exact).
//
// Registers and spills (nvcc -Xptxas -v for sm_90a; chip_smoke.py prints
// them from the build log): each of the 16 instantiations (f32 and bf16,
// D 16 / 32 / 64 / 128, causal and full) reports the launch bound's 168
// registers (the consumers then run at 224) and no spills; the bf16
// producer widens 4 loads at a time within its 56 registers. The launcher
// refuses (cudaErrorInvalidConfiguration) a build that reports other than
// 168, as the register split would then wait forever.
//
// Bound on the card: operations. At [B=4, S=2048, H=32, D=64] causal the
// two products are 4 B H D S (S + 1) / 2 = 68.75 GFLOP, 1.026 ms at 67
// TFLOP/s (f32 CUDA cores); q, k, v, o in f32 are 268 MB, 0.080 ms at
// 3.35 TB/s. At D 64 a warp's tile issues 4096 FMAs against 384 16-byte
// shared loads, 32 P stores, ~40 expf (about 9 instructions each), 32
// shuffles and the rescale: FMAs are ~80% of its instructions. It runs at
// about half the FMA peak (PERF.md row 6): what limits it now is issue
// and latency with two consumer warps a sub-partition (the smem rings
// and the register split leave no more room for a third) and the
// softmax's non-FMA work, not memory.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;                        // keys a tile
constexpr int WROWS = 16;                     // query rows a consumer warp
constexpr int TM = 8;                         // rows a lane: 2 i + rg
constexpr int TN = BK / 16;                   // keys a lane: kg + 16 jj
constexpr float NEG_INF = -1e30f;

// Two consumer warpgroups (8 warps of 16 query rows), then a warpgroup
// whose first warp is the producer (the other three leave at once). A
// sub-partition holds one warp of each warpgroup, so the launch bound
// gives every warp R0 = 168 registers; setmaxnreg then moves the producer
// warpgroup's down to PREGS and the consumers' up to CREGS. setmaxnreg
// only moves registers within the CTA: 8 CREGS + 4 PREGS must fit in
// 12 R0, or the consumers' increase waits forever.
constexpr int CONSUMERS = 8;
constexpr int BQ = WROWS * CONSUMERS;         // query rows a CTA
constexpr int THREADS = (CONSUMERS + 4) * 32;
constexpr int R0 = 65536 / THREADS / 8 * 8;
constexpr int CREGS = 224;
constexpr int PREGS = ((THREADS / 32) * R0 - CONSUMERS * CREGS) / 4 / 8 * 8;
static_assert(R0 == 168 && PREGS == 56, "the register split");

template <int D>
struct Cfg {
  static constexpr int CH = D / 4;                     // 16-byte chunks a row
  static constexpr int G = CH < 8 ? CH : 8;            // chunks a swizzle group
  static constexpr int DT = D / 16;                    // output dims a lane
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int PS = D == 128 ? BK + 4 : BK + 16;   // P row stride
  static constexpr int Q_FLOATS = BQ * D;
  static constexpr int KV_FLOATS = BK * D;             // one K or V tile
  static constexpr int P_FLOATS = CONSUMERS * WROWS * PS;
  static constexpr int RING_OFF = Q_FLOATS;            // floats
  static constexpr int P_OFF = RING_OFF + STAGES * 2 * KV_FLOATS;
  static constexpr int BAR_OFF = (P_OFF + P_FLOATS) * 4;   // bytes
  static constexpr int BYTES = BAR_OFF + 16 * STAGES;  // full[], empty[]
};

// The swizzle key of row r of a K tile: its logical chunk c sits at
// physical chunk c ^ key (within an aligned group of G chunks), so that
// 8 neighbouring rows read at one logical chunk hit 8 distinct banks. A q
// row's key is r & 1 (the two rows a warp reads at once).
template <int D>
__device__ __forceinline__ int swz_key(int r) {
  return D == 16 ? (r >> 1) & 3 : r & 7;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The barrier's arrival, once every earlier cp.async of this lane landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ float4 bf16x4_to_f32(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// 4 consecutive elements of a row as f32 (exact for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return bf16x4_to_f32(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Float offset of chunk c of row r in a K (SWZ) or V tile.
template <int D, bool SWZ>
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * D + 4 * (SWZ ? c ^ swz_key<D>(r) : c);
}

// Rows [0, valid) of a [BK, D] slab of K (SWZ) or V into a stage's f32
// tile, rows past `valid` zero.
template <int D, bool SWZ>
__device__ __forceinline__ void fill(const float* __restrict__ src,
                                     float* dst, int valid, int lane) {
  constexpr int CH = D / 4;
#pragma unroll 8
  for (int idx = lane; idx < BK * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    const bool in = r < valid;
    cp_async16(dst + tile_off<D, SWZ>(r, c),
               src + (size_t)(in ? r : 0) * D + 4 * c, in ? 16 : 0);
  }
}

template <int D, bool SWZ>
__device__ __forceinline__ void fill(const __nv_bfloat16* __restrict__ src,
                                     float* dst, int valid, int lane) {
  constexpr int C8 = D / 8;                    // 16-byte loads a row
#pragma unroll 4
  for (int idx = lane; idx < BK * C8; idx += 32) {
    const int r = idx / C8, c = idx % C8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < valid)
      raw = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * D +
                                                   8 * c));
    *reinterpret_cast<float4*>(dst + tile_off<D, SWZ>(r, 2 * c)) =
        bf16x4_to_f32(make_uint2(raw.x, raw.y));
    *reinterpret_cast<float4*>(dst + tile_off<D, SWZ>(r, 2 * c + 1)) =
        bf16x4_to_f32(make_uint2(raw.z, raw.w));
  }
}

__device__ __forceinline__ void arrive_full(const float*, uint64_t* full) {
  cp_async_arrive(full);
}
__device__ __forceinline__ void arrive_full(const __nv_bfloat16*,
                                            uint64_t* full) {
  mbar_arrive(full);                         // release: the stores above
}

__device__ __forceinline__ float row_max(float v) {   // over 16 lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {   // over 16 lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Output dim of a lane's idx-th accumulator column (dg = lane % 16).
template <int D>
__device__ __forceinline__ int out_dim(int dg, int idx) {
  constexpr int DT = D / 16;
  if constexpr (DT >= 4)
    return 4 * (dg + 16 * (idx / 4)) + idx % 4;
  else
    return dg * DT + idx;
}

// One key tile for one warp: scores, online softmax, P through the warp's
// slice, acc += P V. MASK: the tile crosses the diagonal or Sk.
template <int D, bool CAUSAL, bool MASK>
__device__ __forceinline__ void tile(const float* __restrict__ Qw,
                                     const float* __restrict__ Ks,
                                     const float* __restrict__ Vs,
                                     float* __restrict__ Pw, int k0, int Sk,
                                     int qrow0, int rg, int kg, float (&m)[TM],
                                     float (&l)[TM],
                                     float (&acc)[TM][D / 16]) {
  using C = Cfg<D>;
  constexpr int DT = C::DT, G = C::G;

  // s[i][jj] = q[2i + rg] . k[kg + 16 jj], d in order. Logical chunk
  // p0 + u of the lane's K rows sits at physical chunk p0 + (u ^ kkey), of
  // its q rows at p0 + (u ^ rg): one offset a chunk for each.
  float s[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) s[i][jj] = 0.0f;
  const int kkey = swz_key<D>(kg);
  const float* qr = Qw + rg * D;               // rows 2i + rg: + 2 i D
  const float* kr = Ks + kg * D;               // rows kg + 16 jj: + 16 jj D
#pragma unroll 1
  for (int p0 = 0; p0 < C::CH; p0 += G) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float* kc = kr + 4 * (p0 + (u ^ kkey));
      const float* qc = qr + 4 * (p0 + (u ^ rg));
      float4 kk[TN];
#pragma unroll
      for (int jj = 0; jj < TN; ++jj)
        kk[jj] = *reinterpret_cast<const float4*>(kc + 16 * jj * D);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qc + 2 * i * D);
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          s[i][jj] = fmaf(qq.x, kk[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qq.y, kk[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qq.z, kk[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qq.w, kk[jj].w, s[i][jj]);
        }
      }
    }
  }

  // mask, online softmax, P to the slice
  float* pr = Pw + rg * C::PS + kg;            // P[2i + rg][kg + 16 jj]
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      if (MASK) {
        const int kp = k0 + kg + 16 * jj;
        if (kp >= Sk)
          s[i][jj] = -INFINITY;                 // no such key: p = 0
        else if (CAUSAL && qrow0 + 2 * i + rg < kp)
          s[i][jj] = NEG_INF;
      }
      mx = fmaxf(mx, s[i][jj]);
    }
    const float m_new = fmaxf(m[i], row_max(mx));
    float rs = 0.0f;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const float p = expf(__fsub_rn(s[i][jj], m_new));
      rs = jj == 0 ? p : __fadd_rn(rs, p);
      pr[2 * i * C::PS + 16 * jj] = p;
    }
    const float alpha = expf(__fsub_rn(m[i], m_new));
    l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rs);
    m[i] = m_new;
    if (alpha != 1.0f) {                        // a product by 1 is exact
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) acc[i][dd] = __fmul_rn(acc[i][dd], alpha);
    }
  }
  __syncwarp();

  // acc[2i + rg][dims of dg] += sum_j P[2i + rg][j] V[j], keys in order
  const float* pl = Pw + rg * C::PS;
  const int dg = kg;
  const float* vl = Vs + (DT >= 4 ? 4 * dg : DT * dg);
#pragma unroll 2
  for (int j0 = 0; j0 < BK; j0 += 4) {
    float4 pp[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      pp[i] = *reinterpret_cast<const float4*>(pl + 2 * i * C::PS + j0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* vrow = vl + (j0 + e) * D;
      float vv[DT];
      if constexpr (DT >= 4) {
#pragma unroll
        for (int cc = 0; cc < DT / 4; ++cc) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + 64 * cc);
          vv[4 * cc] = t.x; vv[4 * cc + 1] = t.y;
          vv[4 * cc + 2] = t.z; vv[4 * cc + 3] = t.w;
        }
      } else if constexpr (DT == 2) {
        const float2 t = *reinterpret_cast<const float2*>(vrow);
        vv[0] = t.x; vv[1] = t.y;
      } else {
        vv[0] = vrow[0];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float pe = e == 0 ? pp[i].x : e == 1 ? pp[i].y
                       : e == 2 ? pp[i].z : pp[i].w;
#pragma unroll
        for (int dd = 0; dd < DT; ++dd)
          acc[i][dd] = fmaf(pe, vv[dd], acc[i][dd]);
      }
    }
  }
  __syncwarp();                 // the slice and the stage are read
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int bh_count, int Sq,
          int Sk, int n_qt, float scale) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;
  float* ring = smem + C::RING_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(smem) + C::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_qt - 1 - blockIdx.x / bh_count) * BQ;
  const int k_end = CAUSAL ? min(Sk, q0 + BQ) : Sk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 32);                 // one arrival per producer lane
      mbar_init(empty + s, CONSUMERS);         // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PREGS));
    if (warp > CONSUMERS) return;
    const T* kb = k + (size_t)bh * Sk * D;
    const T* vb = v + (size_t)bh * Sk * D;
    for (int k0 = 0, it = 0; k0 < k_end; k0 += BK, ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(empty + s, ((it / STAGES) - 1) & 1);
      float* Kd = ring + s * 2 * C::KV_FLOATS;
      const int valid = min(BK, Sk - k0);
      fill<D, true>(kb + (size_t)k0 * D, Kd, valid, lane);
      fill<D, false>(vb + (size_t)k0 * D, Kd + C::KV_FLOATS, valid, lane);
      arrive_full(kb, full + s);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
  const int rg = lane / 16, kg = lane % 16;
  float* Qw = Qs + warp * WROWS * D;           // this warp's 16 rows
  float* Pw = smem + C::P_OFF + warp * WROWS * C::PS;
  const int r0 = q0 + warp * WROWS;            // the warp's first row

  // the warp's q rows, scaled, zero past Sq
  const T* qb = q + (size_t)bh * Sq * D;
  for (int idx = lane; idx < WROWS * C::CH; idx += 32) {
    const int lr = idx / C::CH, c = idx % C::CH;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + lr < Sq) {
      x = load4(qb + (size_t)(r0 + lr) * D + 4 * c);
      x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                      __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }
    *reinterpret_cast<float4*>(Qw + lr * D + 4 * (c ^ (lr & 1))) = x;
  }
  __syncwarp();

  float m[TM], l[TM], acc[TM][C::DT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < C::DT; ++dd) acc[i][dd] = 0.0f;
  }

  for (int k0 = 0, it = 0; k0 < k_end; k0 += BK, ++it) {
    const int s = it % STAGES;
    mbar_wait(full + s, (it / STAGES) & 1);
    const float* Ks = ring + s * 2 * C::KV_FLOATS;
    const float* Vs = Ks + C::KV_FLOATS;
    if (!CAUSAL || k0 <= r0 + WROWS - 1) {     // else wholly above: skip
      if (k0 + BK <= Sk && (!CAUSAL || k0 + BK - 1 <= r0))
        tile<D, CAUSAL, false>(Qw, Ks, Vs, Pw, k0, Sk, r0, rg, kg, m, l, acc);
      else
        tile<D, CAUSAL, true>(Qw, Ks, Vs, Pw, k0, Sk, r0, rg, kg, m, l, acc);
    }
    if (lane == 0) mbar_arrive(empty + s);
  }

  // o = acc / max(l, 1e-30): l summed over the row group's 16 lanes
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float den = fmaxf(row_sum(l[i]), 1e-30f);
    const int r = r0 + 2 * i + rg;
    if (r >= Sq) continue;
    T* dst = o + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int dd = 0; dd < C::DT; ++dd)
      store(dst + out_dim<D>(kg, dd), acc[i][dd] / den);
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, float scale, cudaStream_t st) {
  constexpr int bytes = Cfg<D>::BYTES;
  auto kern = flash_fwd<T, D, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // the register split assumes the compiler gave every warp R0: refuse to
  // launch rather than wait forever in setmaxnreg
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess)
    return (int)err;
  if (attr.numRegs != R0) return (int)cudaErrorInvalidConfiguration;
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
