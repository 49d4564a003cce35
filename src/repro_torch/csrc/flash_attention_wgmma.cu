// flash_attention_wgmma: bf16 forward attention with online softmax on the
// tensor cores (wgmma) with TMA loads, over heads-flattened q [BH, Sq, D]
// and k, v [BH, Sk, D], causal (q_pos >= k_pos, positions aligned at the
// top left) or full; D in {64, 128}, Sq % 128 == 0, Sk % 64 == 0 (the
// wrapper pads to 128, as the reference's entry point).
//
// Replaces, for bf16 inputs, the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel); csrc/flash_attention.cu keeps the f32 inputs and the
// other head dims. The arithmetic is the reference's online softmax with
// the rounding the tensor cores force, and the plain PyTorch twin
// (kernels/flash_attention.flash_attention_wgmma_plain) rounds at the same
// places:
//
//   s     = (q . k) * scale            bf16 products summed in f32 by wgmma,
//                                      then one f32 multiply (1/sqrt(D))
//   s     = -1e30 where q_pos < k_pos  (causal)
//   m_new = max(m, rowmax(s));  p = expf(s - m_new);  alpha = expf(m - m_new)
//   p^    = bf16(p)                    the A operand of the PV wgmma
//   l     = l * alpha + rowsum(p^);   acc = acc * alpha + p^ . v   (f32)
//   o     = bf16(acc / max(l, 1e-30))
//
// per key tile of 64, m starting at -1e30 as in the reference. expf, not
// __expf, and no fast-math. Key tiles wholly above the diagonal are
// skipped (they would add p = 0 at alpha = 1), heavier query tiles launch
// first.
//
// Agreement. The twin differs from the kernel only in the order of its
// f32 sums, which the tensor cores do not specify. Taken at its worst, a
// wgmma k-step of 16 adds 17 terms and each may lose one ulp (2^-23,
// truncation) of the largest of them; a round-to-nearest GEMM loses half
// an ulp an add. Per row, with the twin's own weights w_j (p^_j times the
// later alphas, over l), S = sum_j w_j |v_j| and o the twin's f32 output:
//
//  * scores: the two sides' s differ by at most
//    ds = (17 D / 16 + D / 2 + 4) * 2^-23 * scale * |q_row| * max_j |k_j|
//    (Cauchy-Schwarz bounds sum_i |q_i k_i|), so the running maxima differ
//    by at most ds, and p before its rounding by a factor within e^(+-r),
//    r = 2 ds + 2^-21 (expf, 2 ulp a side) + 2^-23 (m - s) (the subtract);
//  * P: bf16(p) is the same on both sides unless a bf16 rounding boundary
//    lies in p * e^(+-r); the twin finds the keys where one does ("flips";
//    about r / 2^-7.5 of them) and there the two p^ differ by at most one
//    bf16 ULP, 2^-7 (1 + 2^-7) of p^. Keys with p < 2^-100 (no relative
//    guarantee) add at most Sk * 2^-99 * (max|v| + |o|);
//  * every key's weight also moves by eta = ds (the running max the alphas
//    carry) + 2^-20 for each tile that may move the max on either side
//    (its max within 2 ds of the running one; expf and two products a
//    side) + 2^-23 * (m_final - m_first) (the alphas' subtractions), up
//    to a factor common to all keys, which the normalisation cancels;
//  * a convex combination whose weights move by delta_j moves by at most
//    sum_j w_j delta_j |v_j - o| / (1 - max delta): here
//    (eta (S + |o|) + 2^-7 (1 + 2^-7) (F + F1 |o|)) / (1 - delta), with F
//    and F1 the sums of w_j |v_j| and w_j over the flips;
//  * the f32 sums: a tile's 4 k-steps lose at most 68 ulps of the largest
//    magnitude they meet, at most |acc| at the tile's start plus the
//    tile's sum p^ |v|; summed over the tiles a row takes (Z), both sides:
//    2 * 68 * 2^-23 * Z / l; l's sums and the division add
//    (2 Sk / 64 + 140) * 2^-23 * |o|.
//
// Each side rounds its own output to bf16: one bf16 ULP of the larger of
// the two on top. The twin is held to the reference (P kept in f32, q
// scaled before the dot product) by the same terms with 2^-8 (1 + 2^-7)
// (S + |o|) in place of the flip term (only the twin rounds, every key)
// and eta + 2^-21 + 70 * 2^-23 (p's expf and subtraction, p >= 2^-100).
// kernels/flash_attention.wgmma_twin_and_bound computes the twin and this
// bound together, from the twin's own weights; the bound takes the twin's
// arithmetic, so it adds no tolerance for a kernel that drops, repeats or
// misweights a key tile.
//
// Design (right first; warp specialisation with setmaxnreg, ping-pong
// between warpgroups and persistence are later work). One CTA of 288
// threads per (bh, 128 query rows): warpgroups 0 and 1 own 64 query rows
// each, warp 8 is the producer. The producer's lane 0 loads q once and
// streams K and V tiles of 64 keys through a 2-stage ring by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, completion on mbarriers with
// expected bytes); consumers release a stage through an "empty" mbarrier
// (one arrival per consumer warp) once their wgmma reads of it are done.
// Shared memory holds every tile as boxes of [rows][64] bf16 (128-byte
// rows, swizzled in 1024-byte atoms), which is the canonical 128B-swizzle
// layout of a K-major wgmma operand: q and K feed S = q k^T as A and B
// (m64n64k16, both K-major, D/16 steps advancing 32 bytes within the row);
// V feeds acc += P V as an MN-major B operand (trans-b, 16 keys = 2048
// bytes a step), P coming from registers: the S accumulator's fragment is
// the A fragment of the next product, rounded to bf16 in place. D = 128
// runs two n64 products per step, one per 64-wide box, so no descriptor
// needs a leading-byte offset. At D = 64 two CTAs share an SM (at most 112
// registers a thread), so one CTA's softmax can overlap the other's
// products; only tiles that reach past a warpgroup's first row are masked,
// and a rescale by alpha = 1 is skipped (it is exact).
//
// Bound on the card, at the serve shape [B=4, S=2048, H=32, D=64]: causal
// work is 4*B*H*Sq*Sk*D/2 = 68.7 GFLOP, 0.069 ms at 989 TFLOP/s (bf16
// tensor cores); q, k, v and o are 134 MB, 0.040 ms at 3.35 TB/s:
// operations bound it.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch (or 1000 + the CUresult of a failed tensor-map
// encode).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                 // query rows a CTA
constexpr int BK = 64;                  // keys a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;            // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int BOXES = D / 64;                   // 64-wide d boxes
  static constexpr int Q_BOX = BQ * 128;                 // bytes a box
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;        // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
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

// One box of a 2D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a 128B-swizzled operand at `addr`: 8-row groups
// 1024 bytes apart (SBO), layout type 1 (128B swizzle), base offset 0 (every
// start lies in a 1024-aligned atom's first 128-byte row).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                       // LBO: unused here
  d |= (uint64_t)(1024 >> 4) << 32;             // SBO
  d |= (uint64_t)1 << 62;                       // 128B swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float& lo_r, float& hi_r) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  lo_r = __low2float(h);
  hi_r = __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator fragment of an m64n64 f32 wgmma, thread `lane` of warp `w`
// of the warpgroup: d[4j + 2h + e] is row 16w + lane/4 + 8h, column
// 8j + 2(lane%4) + e.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_wgmma(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            __nv_bfloat16* __restrict__ o, int bh_count, int Sq, int Sk,
            int n_qt, float scale) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled TMA boxes need 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.x % bh_count;
  const int qt = n_qt - 1 - blockIdx.x / bh_count;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // key tiles the CTA needs (the second warpgroup's rows reach furthest)
  const int n_kt = (CAUSAL ? min(Sk, q0 + BQ) : Sk) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS * 4);    // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      mbar_expect_tx(q_full, S::Q_BYTES);
      for (int b = 0; b < S::BOXES; ++b)
        tma_load(smem + b * S::Q_BOX, &tm_q, q_full, 64 * b, bh * Sq + q0);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + s, ((it / STAGES) - 1) & 1);
        const int row = bh * Sk + it * BK;
        mbar_expect_tx(k_full + s, S::KV_BYTES);
        for (int b = 0; b < S::BOXES; ++b)
          tma_load(smem + S::K_OFF + s * S::KV_BYTES + b * S::KV_BOX, &tm_k,
                   k_full + s, 64 * b, row);
        mbar_expect_tx(v_full + s, S::KV_BYTES);
        for (int b = 0; b < S::BOXES; ++b)
          tma_load(smem + S::V_OFF + s * S::KV_BYTES + b * S::KV_BOX, &tm_v,
                   v_full + s, 64 * b, row);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;                  // 0 or 1: rows 64 wg ..
  const int wq = warp % 4;                  // warp in the warpgroup
  const int r0 = 16 * wq + lane / 4;        // fragment rows r0, r0 + 8
  const int tq = lane % 4;
  const int row0 = q0 + 64 * wg;            // first query row of the group
  const int my_kt = (CAUSAL ? min(Sk, row0 + 64) : Sk) / BK;

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float acc[S::BOXES][32];
#pragma unroll
  for (int b = 0; b < S::BOXES; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.0f;

  const uint32_t q_base = smem_u32(smem) + wg * 64 * 128;
  mbar_wait(q_full, 0);

  for (int it = 0; it < my_kt; ++it) {
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int k0 = it * BK;
    const uint32_t k_base = smem_u32(smem + S::K_OFF + s * S::KV_BYTES);
    const uint32_t v_base = smem_u32(smem + S::V_OFF + s * S::KV_BYTES);

    // S = q k^T over D in steps of 16 (32 bytes of a 128-byte row)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    mbar_wait(k_full + s, par);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(sc, desc_sw128(q_base + (kk / 4) * S::Q_BOX + off),
               desc_sw128(k_base + (kk / 4) * S::KV_BOX + off));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // scale, mask (only a tile that reaches past the group's first row
    // holds masked keys), online softmax; P rounded to bf16 as the A
    // fragment
    const bool diag = CAUSAL && k0 + BK - 1 > row0;
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = row0 + r0 + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = __fmul_rn(sc[4 * j + 2 * h + e], scale);
          if (diag && qp < k0 + 8 * j + 2 * tq + e) v = NEG_INF;
          sc[4 * j + 2 * h + e] = v;
          mx = fmaxf(mx, v);
        }
      const float m_new = fmaxf(m[h], quad_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float lo, hi;
        const uint32_t pk = pack_bf16(expf(sc[4 * j + 2 * h] - m_new),
                                      expf(sc[4 * j + 2 * h + 1] - m_new),
                                      lo, hi);
        // keys 8j..8j+7 of row half h: k-step j / 2, A register
        // 2 (j % 2) + h (rows g / g + 8, keys 2t / 2t + 8 of the step)
        pa[j / 2][2 * (j % 2) + h] = pk;
        rs = __fadd_rn(rs, __fadd_rn(lo, hi));
      }
      const float alpha = expf(m[h] - m_new);
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha), quad_sum(rs));
      m[h] = m_new;
      if (alpha != 1.0f) {                  // a product by 1 is exact
#pragma unroll
        for (int b = 0; b < S::BOXES; ++b)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[b][4 * j + 2 * h + e] =
                  __fmul_rn(acc[b][4 * j + 2 * h + e], alpha);
      }
    }

    // acc += P V over the 64 keys in steps of 16 (2048 bytes of V a step)
    mbar_wait(v_full + s, par);
#pragma unroll
    for (int b = 0; b < S::BOXES; ++b) fence_regs(acc[b]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int b = 0; b < S::BOXES; ++b)
        wgmma_rs(acc[b], pa[kk],
                 desc_sw128(v_base + b * S::KV_BOX + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int b = 0; b < S::BOXES; ++b) fence_regs(acc[b]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  // o = acc / max(l, 1e-30), bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst =
        o + ((size_t)bh * Sq + row0 + r0 + 8 * h) * D + 2 * tq;
#pragma unroll
    for (int b = 0; b < S::BOXES; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            acc[b][4 * j + 2 * h] / den, acc[b][4 * j + 2 * h + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * b + 8 * j) = pr;
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is driver API: reach it through the runtime, so
// the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// A [rows, d] bf16 matrix read in boxes of [box_rows, 64] with 128B swizzle.
int make_map(CUtensorMap* map, const void* ptr, long long rows, int d,
             int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, (long long)bh * sq, D, BQ);
  if (err == 0) err = make_map(&tk, k, (long long)bh * sk, D, BK);
  if (err == 0) err = make_map(&tv, v, (long long)bh * sk, D, BK);
  if (err != 0) return err;
  constexpr int bytes = Smem<D>::BYTES + 1024;   // + alignment slack
  auto kern = flash_wgmma<D, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = sq / BQ;
  const long long blocks = (long long)n_qt * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, THREADS, bytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), bh, sq, sk, n_qt, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [bh, sq, d]; k, v: [bh, sk, d]; o: [bh, sq, d]; bf16, contiguous,
// 16-byte aligned; d in {64, 128}; sq % 128 == 0; sk % 64 == 0; the
// rows of the [bh * s, d] views (TMA's int32 coordinates) below 2^31.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o,
                                            long long bh, int sq, int sk,
                                            int d, int causal, float scale,
                                            void* stream) {
  if (bh < 1 || bh > 0x7fffffffLL || sq < BQ || sq % BQ || sk < BK ||
      sk % BK || (long long)bh * (sq > sk ? sq : sk) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (int)bh;
  if (d == 64)
    return causal ? launch<64, true>(q, k, v, o, n, sq, sk, scale, st)
                  : launch<64, false>(q, k, v, o, n, sq, sk, scale, st);
  if (d == 128)
    return causal ? launch<128, true>(q, k, v, o, n, sq, sk, scale, st)
                  : launch<128, false>(q, k, v, o, n, sq, sk, scale, st);
  return (int)cudaErrorInvalidValue;
}
