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
// the rounding the tensor cores force, in log2 units, and the plain
// PyTorch twin (kernels/flash_attention.flash_attention_wgmma_plain)
// rounds at the same places:
//
//   s     = q . k                   bf16 products summed in f32 by wgmma
//   s     = -1e30 where q_pos < k_pos (causal) or k_pos >= Sk
//   m_new = max(m, rowmax(s) c)     c = log2(e) / sqrt(D) rounded to f32;
//                                   the rounded product is monotone, so
//                                   this is the max of the products
//   p     = exp2(fma(s, c, -m_new)) one rounding, then ex2.approx (2 ulp)
//   alpha = exp2(m - m_new)
//   p^    = bf16(p)                 the A operand of the PV wgmma
//   l     = l * alpha + rowsum(p^)  the row sums on the tensor cores too
//   acc   = acc * alpha + p^ . v    (f32)
//   o     = bf16(acc / max(l, 1e-30))
//
// per key tile of BK keys (128 at D 64, 64 at D 128; the twin's
// flash_attention.wgmma_bk), m starting at -1e30 as in the reference. The
// twin rounds s c, then s c - m_new, and takes torch.exp2. Key tiles
// wholly above the diagonal are skipped (they would add p = 0 at alpha =
// 1), heavier query tiles launch first.
//
// Agreement. The twin differs from the kernel in the order of its f32
// sums, which the tensor cores do not specify, and in p's argument, which
// the kernel rounds once where the twin rounds the product and the
// difference. Taken at its worst, a wgmma k-step of 16 adds 17 terms and
// each may lose one ulp (2^-23, truncation) of the largest of them; a
// round-to-nearest GEMM loses half an ulp an add. Per row, with the twin's
// own weights w_j (p^_j times the later alphas, over l), S = sum_j w_j
// |v_j| and o the twin's f32 output, in natural units (a log2-unit error
// e moves p by the factor 2^e = e^(e ln 2)):
//
//  * scores: the two sides' s c differ by at most
//    ds = (17 D / 16 + D / 2 + 4) * 2^-23 * scale * |q_row| * max_j |k_j|
//    (Cauchy-Schwarz bounds sum_i |q_i k_i|; scale = 1/sqrt(D)), so the
//    running maxima differ by at most ds, and p before its rounding by a
//    factor within e^(+-r), r = 2 ds + 2^-21 (exp2, 2 ulp a side) +
//    ln 2 (2^-23 (m - s) + 2^-24 |s|) (the subtractions and the twin's
//    product, s and m in log2 units);
//  * P: bf16(p) is the same on both sides unless a bf16 rounding boundary
//    lies in p * e^(+-r); the twin finds the keys where one does ("flips";
//    about r / 2^-7.5 of them) and there the two p^ differ by at most one
//    bf16 ULP, 2^-7 (1 + 2^-7) of p^. Keys with p < 2^-100 (no relative
//    guarantee; the kernel's exp2 flushes below 2^-126) add at most
//    Sk * 2^-99 * (max|v| + |o|);
//  * every key's weight also moves by eta = ds (the running max the alphas
//    carry) + 2^-20 for each tile that may move the max on either side
//    (its max within 2 ds of the running one; exp2 and two products a
//    side) + 2^-23 * (m_final - m_first) (the alphas' subtractions), up
//    to a factor common to all keys, which the normalisation cancels;
//  * a convex combination whose weights move by delta_j moves by at most
//    sum_j w_j delta_j |v_j - o| / (1 - max delta): here
//    (eta (S + |o|) + 2^-7 (1 + 2^-7) (F + F1 |o|)) / (1 - delta), with F
//    and F1 the sums of w_j |v_j| and w_j over the flips;
//  * the f32 sums: a tile's BK/16 k-steps lose at most 17 BK/16 ulps of
//    the largest magnitude they meet, at most |acc| at the tile's start
//    plus the tile's sum p^ |v|; summed over the tiles a row takes (Z),
//    both sides: 2 * 17 (BK/16) * 2^-23 * Z / l; l's sums (the tile's row
//    sums on the tensor cores, the same 17 BK/16 ulps, and the twin's in
//    any order), its two roundings a tile and the division add
//    (2 Sk / BK + 2 * 17 (BK/16) + 4) * 2^-23 * |o|.
//
// Each side rounds its own output to bf16: one bf16 ULP of the larger of
// the two on top. The twin is held to the reference (P kept in f32, q
// scaled before the dot product, exp) by the same terms with 2^-8
// (1 + 2^-7) (S + |o|) in place of the flip term (only the twin rounds,
// every key) and eta + 2^-21 + 70 * 2^-23 + 2^-24 (|m| + 70) (p's exp2
// and subtraction, p >= 2^-100 so m - s <= 70; the twin's product, |s| <=
// |m| + 70). kernels/flash_attention.wgmma_twin_and_bound computes the
// twin and this bound together, from the twin's own weights; the bound
// takes the twin's arithmetic, so it adds no tolerance for a kernel that
// drops, repeats or misweights a key tile.
//
// Design. One CTA of 384 threads per (bh, 128 query rows), heavier query
// tiles first: consumer warpgroups 0 and 1 own 64 query rows each, and the
// producer warpgroup (warps 8-11) follows them.
//  * Producer. setmaxnreg.dec to PREGS; lane 0 of warp 8 streams K and V
//    tiles of BK keys by TMA (cp.async.bulk.tensor, 128-byte swizzle)
//    through a ring of STAGES in shared memory; warps 9-11 leave. K and V
//    each have a full mbarrier (expected bytes) and an empty one (one
//    arrival per consumer warp) a stage, so K of tile j + 1 is consumed
//    while V of tile j is still being read.
//  * Operands. Shared memory holds every tile as boxes of [BK keys][64]
//    bf16 (128-byte rows, swizzled in 1024-byte atoms), the canonical
//    128B-swizzle layout of a K-major wgmma operand. A consumer warpgroup
//    reads its 64 query rows once from device memory into registers, as
//    the A fragments of S = q k^T (m64n128k16 at D 64, m64n64k16 at D 128,
//    D/16 steps; K is the K-major B operand), so the score product reads
//    only K from shared memory. P comes from registers too: the S
//    accumulator's fragment, exponentiated and rounded to bf16 in place,
//    is the A fragment of acc += P V (V the MN-major B operand, 16 keys =
//    2048 bytes a step; D 128 runs two n64 products a step, one per
//    64-wide box of V) and of the row sums P ones (m64n8k16, the ones a
//    1 KB shared region), issued with it.
//  * Overlap within a warpgroup. Turn t issues S_t = q K_t^T, then
//    P_{t-1} V_{t-1} and its row sums, waits for S_t alone
//    (wgmma.wait_group 1) and runs tile t's mask and online softmax while
//    the PV product runs; then waits for that (wait_group 0), adds the row
//    sums to l and rescales acc by tile t's alpha before turn t + 1 adds
//    P_t V_t. A row's operations (m, l, alpha, acc) are the twin's, in
//    the twin's order; only when they are issued moves. Every product of
//    a turn is issued on one path (ptxas serializes a wgmma under a
//    branch, C7520), and P's registers are written only once the products
//    that read them have completed.
//  * The two warpgroups run on their own, each on the ring's stages in
//    turn. Under the causal mask at D 128, warpgroup 0 needs one key tile
//    fewer than warpgroup 1 (its rows end 64 earlier): the empty barriers
//    of that tile get only warpgroup 1's four arrivals; it is the CTA's
//    last tile, whose stage the producer never waits for again. At D 64
//    (BK = BQ) both take the same tiles.
//  * Registers. A sub-partition holds one warp of each of the three
//    warpgroups, so the launch bound gives every thread R0 = 168;
//    setmaxnreg moves the producer warpgroup to PREGS = 24 and the
//    consumers to CREGS = 240, which holds acc (32 D/64 floats), S (BK/2),
//    two P fragments (BK/8 each) and q's fragments (D/4) with room for
//    the softmax. setmaxnreg only moves registers within the CTA: a build
//    whose count at launch is not R0 would wait forever in the consumers'
//    increase, so the launcher refuses it. Both setmaxnreg sit in one
//    if / else that never merges again (else ptxas ignores them, C7508).
//  * Only tiles that reach past a warpgroup's first row or past Sk are
//    masked, and a rescale by alpha = 1 is skipped (it is exact).
//  * A hang becomes an error: mbar_wait gives up after WAIT_LIMIT clocks
//    and traps, so a ring whose phases slipped ends the launch with an
//    error (the next synchronize raises "unspecified launch failure")
//    instead of spinning until the caller's time limit. A legal wait
//    lasts at most one tile's load or one tile of the other warpgroup,
//    microseconds; a whole call at 32k keys takes about 11 ms; 2^34 clocks
//    are about 9 s at the card's 1.98 GHz, far above either.
//
// Bound on the card, at the serve shape [B=4, S=2048, H=32, D=64]: causal
// work is 4*B*H*Sq*Sk*D/2 = 68.7 GFLOP, 0.069 ms at 989 TFLOP/s (bf16
// tensor cores); q, k, v and o are 134 MB, 0.040 ms at 3.35 TB/s:
// operations bound it. Per warpgroup and 128-key tile at D 64 the two
// products take 512 clocks of the SM's tensor cores and the 64 exp2 a
// thread take 512 clocks of its sub-partition's SFU (16 a clock an SM),
// so the two warpgroups' softmax, their sync points and the tensor cores
// share the time; the kernel reaches ~25-40% of the bound (PERF.md row 6b
// has the measured shares and what each design step bought).
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
constexpr int CONSUMERS = 2;            // warpgroups, 64 rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int R0 = 65536 / THREADS / 8 * 8;
constexpr int CREGS = 240;
constexpr int PREGS = 24;
static_assert(R0 == 168 &&
                  4 * CONSUMERS * CREGS + 4 * PREGS <= 4 * (CONSUMERS + 1) * R0,
              "the register split");
constexpr float NEG_INF = -1e30f;
constexpr int STAGES = 4;
constexpr int ONES_BYTES = 1024;        // the row sums' B operand
constexpr long long WAIT_LIMIT = 1LL << 34;   // clocks

template <int D>
struct Cfg {
  static constexpr int BK = D == 64 ? 128 : 64;          // keys a tile
  static constexpr int SC = BK / 2;                      // scores a thread
  static constexpr int BOXES = D / 64;                   // 64-wide d boxes
  static constexpr int KV_BOX = BK * 128;                // bytes a box
  static constexpr int KV_BYTES = BOXES * KV_BOX;        // one K or V tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = STAGES * KV_BYTES;
  static constexpr int ONES_OFF = 2 * STAGES * KV_BYTES;   // bf16 1.0s
  static constexpr int BAR_OFF = ONES_OFF + ONES_BYTES;
  // k_full, v_full, k_empty, v_empty: STAGES each
  static constexpr int BYTES = BAR_OFF + 8 * 4 * STAGES;
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

__device__ __forceinline__ uint32_t mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// The end of a wait that lasted WAIT_LIMIT clocks (the design note). Out
// of line: a trap inlined into the consumers' code makes ptxas compile them
// at the launch bound's R0 registers instead of CREGS.
__device__ __noinline__ void wait_timed_out() { __trap(); }

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - start > WAIT_LIMIT) wait_timed_out();
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

// The row sums' all-ones B operand: no swizzle, every core matrix inside
// the ONES_BYTES region (with ones everywhere, the layout does not matter).
__device__ __forceinline__ uint64_t desc_ones(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(128 >> 4) << 16;              // LBO
  d |= (uint64_t)(256 >> 4) << 32;              // SBO
  return d;                                     // layout type 0: none
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a wgmma's registers
// (accumulator or A fragment) across the asynchronous wgmma, and from
// reusing an A fragment's registers while a product may still read them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
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
#define WG_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B in
// shared memory, K-major (TRANS_B 0) or MN-major (1); ACC 0 writes d
// without reading it (a score tile's registers carry nothing from one tile
// to the next).
template <int TRANS_B, int ACC>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ACC),
        "n"(TRANS_B));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], B K-major: the scores of a
// 128-key tile.
template <int ACC>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ACC));
}

// Row sums of P on the tensor cores: d[64 x 8] (+)= A[64 x 16] ones[16 x 8],
// A the P fragment; every column of d holds its row's sum.
template <int ACC>
__device__ __forceinline__ void wgmma_rowsum(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ACC));
}

// 2^x on the SFU (MUFU.EX2: at most 2 ulp; results below 2^-126 flush to
// zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S = q K^T for one key tile: D/16 steps over 32 bytes of a 128-byte row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<D>::SC],
                                         const uint32_t (&qa)[D / 16][4],
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db =
        desc_sw128(k_base + (kk / 4) * Cfg<D>::KV_BOX + (kk % 4) * 32);
    if constexpr (Cfg<D>::BK == 128) {
      if (kk == 0) wgmma_n128<0>(sc, qa[kk], db);
      else wgmma_n128<1>(sc, qa[kk], db);
    } else {
      if (kk == 0) wgmma_n64<0, 0>(sc, qa[kk], db);
      else wgmma_n64<0, 1>(sc, qa[kk], db);
    }
  }
  wgmma_commit();
}

// acc += P V over the tile's keys in steps of 16 (2048 bytes of V a
// step), and the tile's row sums of P into rsum, one group.
template <int D, int BK = Cfg<D>::BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 64][32],
                                         float (&rsum)[4],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_base, uint32_t ones) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      wgmma_n64<1, 1>(acc[b], pa[kk],
                      desc_sw128(v_base + b * Cfg<D>::KV_BOX + kk * 16 * 128));
    if (kk == 0) wgmma_rowsum<0>(rsum, pa[kk], desc_ones(ones));
    else wgmma_rowsum<1>(rsum, pa[kk], desc_ones(ones));
  }
  wgmma_commit();
}

// Mask (MASK: the tile reaches past the warpgroup's first row, or past
// Sk) and the online softmax of one tile's raw scores sc: m updated (log2
// units), the tile's alpha out, and P = exp2(sc c - m) rounded to bf16 as
// the A fragment of acc += P V (keys 8j..8j+7 of row half h are k-step
// j / 2, register 2 (j % 2) + h: rows g / g + 8, keys 2t / 2t + 8 of the
// step). l takes the tile's row sums from the tensor cores with its PV
// product. Accumulator fragment of an m64nN f32 wgmma, thread `lane` of
// warp `w` of the warpgroup: d[4j + 2h + e] is row 16w + lane/4 + 8h,
// column 8j + 2(lane%4) + e.
template <int BK, bool MASK, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             uint32_t (&pn)[BK / 16][4],
                                             float (&m)[2], float (&alpha)[2],
                                             int k0, int row, int tq, int Sk,
                                             float c) {
  constexpr int J = BK / 8;                 // 8-key column groups
  if (MASK) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {      // i = 4j + 2h + e: row + 8h,
      const int key = k0 + 8 * (i / 4) + 2 * tq + i % 2;  // key k0 + 8j +
      if ((CAUSAL && row + 8 * ((i / 2) % 2) < key) || key >= Sk)  // 2tq + e
        sc[i] = NEG_INF;
    }
  }
  // both halves' row maxima as trees, the halves interleaved
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      t[j] = fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
#pragma unroll
    for (int lv = 1; lv < J; lv *= 2)       // pairs lv apart, in place
#pragma unroll
      for (int j = 0; j + lv < J; j += 2 * lv) t[j] = fmaxf(t[j], t[j + lv]);
    mx[h] = t[0];
  }
#pragma unroll
  for (int x = 1; x <= 2; x *= 2)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], x));
  // the rounded product is monotone: max_j (s_j c) = (max_j s_j) c
  float m_new[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], __fmul_rn(mx[h], c));
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pn[j / 2][2 * (j % 2) + h] =
          pack_bf16(ex2(__fmaf_rn(sc[4 * j + 2 * h], c, -m_new[h])),
                    ex2(__fmaf_rn(sc[4 * j + 2 * h + 1], c, -m_new[h])));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    alpha[h] = ex2(__fsub_rn(m[h], m_new[h]));
    m[h] = m_new[h];
  }
}

// The masked body only where a tile reaches past the warpgroup's first
// row or past Sk (the unmasked one has no per-element compare and select).
template <int BK, bool CAUSAL>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2],
                                        uint32_t (&pn)[BK / 16][4],
                                        float (&m)[2], float (&alpha)[2],
                                        int k0, int row0, int row, int tq,
                                        int Sk, float c) {
  if ((CAUSAL && k0 + BK - 1 > row0) || k0 + BK > Sk)
    softmax_tile<BK, true, CAUSAL>(sc, pn, m, alpha, k0, row, tq, Sk, c);
  else
    softmax_tile<BK, false, CAUSAL>(sc, pn, m, alpha, k0, row, tq, Sk, c);
}

// l = l alpha + the tile's row sums (rsum[2h] is row half h's)
__device__ __forceinline__ void add_rows(float (&l)[2], const float (&alpha)[2],
                                         const float (&rsum)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), rsum[2 * h]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 64][32],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (alpha[h] == 1.0f) continue;       // a product by 1 is exact
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[b][4 * j + 2 * h + e] =
              __fmul_rn(acc[b][4 * j + 2 * h + e], alpha[h]);
  }
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __nv_bfloat16* __restrict__ q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            __nv_bfloat16* __restrict__ o, int bh_count, int Sq, int Sk,
            int n_qt, float c) {
  using S = Cfg<D>;
  constexpr int BK = S::BK;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled TMA boxes need 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* k_full = bars;
  uint64_t* v_full = bars + STAGES;
  uint64_t* k_empty = bars + 2 * STAGES;
  uint64_t* v_empty = bars + 3 * STAGES;

  const int bh = blockIdx.x % bh_count;
  const int qt = n_qt - 1 - blockIdx.x / bh_count;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // key tiles the CTA needs (the second warpgroup's rows reach furthest)
  const int n_kt = ((CAUSAL ? min(Sk, q0 + BQ) : Sk) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMERS * 4);  // one arrival per warp
      mbar_init(v_empty + s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < ONES_BYTES / 4; i += THREADS)
    reinterpret_cast<uint32_t*>(smem + S::ONES_OFF)[i] = 0x3F803F80u;
  // the generic-proxy writes, before the tensor cores read them
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PREGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % STAGES;
        const uint32_t par = ((it / STAGES) - 1) & 1;
        const int row = bh * Sk + it * BK;
        if (it >= STAGES) mbar_wait(k_empty + s, par);
        mbar_expect_tx(k_full + s, S::KV_BYTES);
        for (int b = 0; b < S::BOXES; ++b)
          tma_load(smem + S::K_OFF + s * S::KV_BYTES + b * S::KV_BOX, &tm_k,
                   k_full + s, 64 * b, row);
        if (it >= STAGES) mbar_wait(v_empty + s, par);
        mbar_expect_tx(v_full + s, S::KV_BYTES);
        for (int b = 0; b < S::BOXES; ++b)
          tma_load(smem + S::V_OFF + s * S::KV_BYTES + b * S::KV_BOX, &tm_v,
                   v_full + s, 64 * b, row);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
  const int wg = warp / 4;                  // 0 or 1: rows 64 wg ..
  const int wq = warp % 4;                  // warp in the warpgroup
  const int tq = lane % 4;
  const int row0 = q0 + 64 * wg;            // first query row of the group
  const int row = row0 + 16 * wq + lane / 4;   // fragment rows row, row + 8
  const int my_kt = ((CAUSAL ? min(Sk, row0 + 64) : Sk) + BK - 1) / BK;

  // q's rows as the A fragments of S = q k^T: register r of k-step kk holds
  // row + 8 (r % 2), columns 16 kk + 8 (r / 2) + 2 tq and the next
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qr = q + ((size_t)bh * Sq + row) * D + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[kk][r] = __ldg(reinterpret_cast<const unsigned int*>(
            qr + (r % 2) * 8 * D + 16 * kk + 8 * (r / 2)));
  }

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float acc[S::BOXES][32];
  float rsum[4];                            // row sums of the last P
  uint32_t pa[BK / 16][4];                  // P of the tile PV takes next
  float alpha_pa[2];                        // and its alpha
#pragma unroll
  for (int b = 0; b < S::BOXES; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.0f;
  const uint32_t k_ring = smem_u32(smem + S::K_OFF);
  const uint32_t v_ring = smem_u32(smem + S::V_OFF);
  const uint32_t ones = smem_u32(smem + S::ONES_OFF);

  // turn 0: S_0 alone
  {
    mbar_wait(k_full, 0);
    float sc[S::SC];
    wgmma_fence();
    issue_qk<D>(sc, qa, k_ring);
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty, lane);
    softmax<BK, CAUSAL>(sc, pa, m, alpha_pa, 0, row0, row, tq, Sk, c);
  }
  // turns 1 .. my_kt - 1: S_t, then P_{t-1} V_{t-1} with its row sums,
  // both in flight; tile t's softmax runs while the PV product does. Every
  // product of a turn is issued on one path (ptxas serializes a wgmma under
  // a branch), and P's registers are written only once their products have
  // completed.
  for (int t = 1; t < my_kt; ++t) {
    const int sk = t % STAGES;
    const int sv = (t - 1) % STAGES;
    mbar_wait(k_full + sk, (t / STAGES) & 1);
    mbar_wait(v_full + sv, ((t - 1) / STAGES) & 1);
    float sc[S::SC];
#pragma unroll
    for (int b = 0; b < S::BOXES; ++b) fence_regs(acc[b]);
    fence_frags(pa);
    wgmma_fence();
    issue_qk<D>(sc, qa, k_ring + sk * S::KV_BYTES);
    issue_pv<D>(acc, rsum, pa, v_ring + sv * S::KV_BYTES, ones);
    wgmma_wait<1>();                        // S_t; the PV product runs on
    fence_regs(sc);
    release(k_empty + sk, lane);
    float alpha[2];
    uint32_t pn[BK / 16][4];
    softmax<BK, CAUSAL>(sc, pn, m, alpha, t * BK, row0, row, tq, Sk, c);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < S::BOXES; ++b) fence_regs(acc[b]);
    fence_frags(pa);
    fence_regs(rsum);
    release(v_empty + sv, lane);
    add_rows(l, alpha_pa, rsum);
    rescale<D>(acc, alpha);
#pragma unroll
    for (int i = 0; i < BK / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[i][j] = pn[i][j];
    alpha_pa[0] = alpha[0];
    alpha_pa[1] = alpha[1];
  }
  // turn my_kt: P V of the last tile
  {
    const int sv = (my_kt - 1) % STAGES;
    mbar_wait(v_full + sv, ((my_kt - 1) / STAGES) & 1);
#pragma unroll
    for (int b = 0; b < S::BOXES; ++b) fence_regs(acc[b]);
    fence_frags(pa);
    wgmma_fence();
    issue_pv<D>(acc, rsum, pa, v_ring + sv * S::KV_BYTES, ones);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < S::BOXES; ++b) fence_regs(acc[b]);
    fence_frags(pa);
    fence_regs(rsum);
    release(v_empty + sv, lane);
    add_rows(l, alpha_pa, rsum);
  }

  // o = acc / max(l, 1e-30), bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst = o + ((size_t)bh * Sq + row + 8 * h) * D + 2 * tq;
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
           int sq, int sk, float c, cudaStream_t st) {
  CUtensorMap tk, tv;
  int err = make_map(&tk, k, (long long)bh * sk, D, Cfg<D>::BK);
  if (err == 0) err = make_map(&tv, v, (long long)bh * sk, D, Cfg<D>::BK);
  if (err != 0) return err;
  constexpr int bytes = Cfg<D>::BYTES + 1024;    // + alignment slack
  auto kern = flash_wgmma<D, CAUSAL>;
  // once a device: the shared-memory size, and the register split's
  // premise (the compiler gave every thread R0; refuse to launch rather
  // than wait forever in setmaxnreg)
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) return (int)e;
    if (attr.numRegs != R0) return (int)cudaErrorInvalidConfiguration;
    ready[dev] = true;
  }
  const int n_qt = sq / BQ;
  const long long blocks = (long long)n_qt * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), tk, tv,
      static_cast<__nv_bfloat16*>(o), bh, sq, sk, n_qt, c);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [bh, sq, d]; k, v: [bh, sk, d]; o: [bh, sq, d]; bf16, contiguous,
// 16-byte aligned; d in {64, 128}; sq % 128 == 0; sk % 64 == 0; the
// rows of the [bh * s, d] views (TMA's int32 coordinates) below 2^31;
// scale_log2 = log2(e) / sqrt(d) rounded to f32
// (kernels/flash_attention.wgmma_scale_log2).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o,
                                            long long bh, int sq, int sk,
                                            int d, int causal,
                                            float scale_log2, void* stream) {
  if (bh < 1 || bh > 0x7fffffffLL || sq < BQ || sq % BQ || sk < 64 ||
      sk % 64 || (long long)bh * (sq > sk ? sq : sk) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (int)bh;
  if (d == 64)
    return causal ? launch<64, true>(q, k, v, o, n, sq, sk, scale_log2, st)
                  : launch<64, false>(q, k, v, o, n, sq, sk, scale_log2, st);
  if (d == 128)
    return causal ? launch<128, true>(q, k, v, o, n, sq, sk, scale_log2, st)
                  : launch<128, false>(q, k, v, o, n, sq, sk, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}
