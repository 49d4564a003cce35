// block_select.cuh: the per-row selection shared by block_topk.cu and
// ef_update.cu. It reproduces the value bisection of the Pallas kernels
// src/repro/kernels/block_topk.py (_block_topk_kernel) and
// src/repro/kernels/ef_update.py (_ef_update_kernel):
//
//   mag = |v|;  hi = max(mag) (NaN propagates);  lo = 0
//   40 times:   mid = 0.5 * (lo + hi)
//               pred = count(mag >= mid) >= k
//               lo = pred ? mid : lo;  hi = pred ? hi : mid
//   mask = mag >= lo
//
// This is a VALUE bisection, not exact Top-K: a NaN makes hi NaN and keeps
// every non-NaN element, an inf keeps everything unless k = 1, and a k-th
// magnitude below rowmax * 2^-40 keeps the whole row, zeros included. Those
// are the reference kernel's results and this reproduces them bit for bit.
//
// Denormals: the reference's platforms (XLA on the CPU, the TPU) read
// denormal operands as zero and write denormal results as zero. PyTorch and
// nvcc (without --use_fast_math) keep them, so the selection flushes by hand:
// the magnitudes and every mid go through flush(), and the plain PyTorch
// twins (kernels/block_topk.py) do the same.
//
// Why one count is enough. Let m_k be the k-th largest flushed magnitude of
// a row without NaN. For any mid that is not NaN, count(mag >= mid) >= k
// holds exactly when m_k >= mid: if m_k >= mid, the k largest all reach
// mid; if m_k < mid, only the k - 1 above it can. So every step's pred is
// m_k >= mid, and lo depends only on hi and m_k. A NaN in the row makes hi
// a NaN pattern (NaN patterns order above inf, as jnp.max propagates), so
// every mid is NaN and both forms of pred are false at every step: lo = 0
// either way. With an inf, hi = inf and mid = inf until it halves, which
// is no NaN (lo + hi adds non-negatives); flushed mids and denormal
// magnitudes compare as the zeros they became. So the kernels find m_k
// exactly, then run the same 40 steps as a scalar recurrence in registers
// (lo_from_kth), with the reference's op sequence and no barrier inside:
// the same lo, bit for bit, as the 40 counts.
//
// Finding m_k: an exact radix select on the 31-bit pattern of the flushed
// magnitude (bit 31 is 0; non-negative floats order like their patterns),
// most significant digit first, in 4 passes of 8, 8, 8 and 7 bits
// (bits 30..23, 22..15, 14..7, 6..0). A pass histograms the elements whose
// higher digits equal the prefix chosen so far, then picks the bin where
// the suffix count from the top first reaches the rank left (k at first)
// and carries the rank left inside that bin into the next pass. Pass 1 also
// takes hi, the largest pattern. Each warp counts into its own copy of the
// 256-bin histogram in shared memory (shared atomics), so the few hot
// first-digit bins of a row of model deltas (a handful of exponents) only
// meet within a warp, not across the CTA; __match_any_sync aggregation
// measured slower here, as in threshold_find.cu. After a barrier the copies
// are folded into one count a bin (and zeroed for the next pass), with
// in-warp suffix sums by shuffles; after a second barrier every warp scans
// the 8 group sums and one bin a lane by shuffles and picks the bin with a
// ballot. Thread 0 then runs the recurrence and hands lo over through
// shared memory (measured faster than every thread running it: the other
// rows on the SM take the instruction slots). Barriers a row: 1 (zeroing)
// + 2 a pass + 1 (lo) = 10, from 41.
//
// The register path: one CTA holds one row in registers, ITEMS elements a
// thread, so the row is read from device memory once. Thread t holds
// elements t, t + T, t + 2T, ..., or, where the row allows it (block % 4 ==
// 0, 16-byte aligned pointers), the float4s t, t + T, ...: 16-byte loads
// and stores, which the byte bound needs. (32 elements a thread, for four
// rows an SM, spilled at 64 registers and measured slower.)
// Rows longer than MAX_BLOCK take the wide path (select_kth_wide,
// WIDE_THREADS threads, element idx by thread idx % WIDE_THREADS, BATCH
// reads in flight a thread), which re-reads the row from device memory in
// each pass, so the wide kernels read it 5 times (4 passes and the
// outputs), from 42.
// Histograms count integers and the max is order-free, so every path gives
// the same m_k and hi on any row.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace block_select {

constexpr int ITEMS = 16;                         // elements a thread holds
constexpr int MAX_THREADS = 1024;                 // the register path
constexpr int MAX_BLOCK = ITEMS * MAX_THREADS;    // 16384 elements a row
constexpr int WIDE_THREADS = 1024;                // the wide path
constexpr int MAX_WARPS = WIDE_THREADS / 32;
constexpr int BATCH = 8;                          // wide loads in flight
constexpr int N_ITERS = 40;
constexpr int BINS = 256;                         // the widest digit: 8 bits
constexpr unsigned NO_KEY = 0xffffffffu;          // a slot past the row
constexpr unsigned FULL = 0xffffffffu;

// Denormal -> zero of the same sign (what DAZ/FTZ do to it).
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

// The bit pattern of flush(|v|): sign cleared, a denormal to 0; a NaN stays
// a pattern above inf's (0x7f800000).
__device__ __forceinline__ unsigned mag_key(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b < 0x00800000u ? 0u : b;
}

// Threads a CTA of the register path needs for a row of `block` elements:
// a multiple of 32.
inline int threads_for(int block) {
  const int t = (block + ITEMS - 1) / ITEMS;
  return ((t + 31) / 32) * 32;
}

struct Scratch {
  int hist[MAX_WARPS][BINS];   // one copy a warp
  int suf[BINS];               // count from the bin to the top of its group
  int group[BINS / 32];        // count of each group of 32 bins
  unsigned umax[MAX_WARPS];    // each warp's largest pattern (pass 1)
  float lo;                    // the threshold, from thread 0
};

// Digit `pass` (0..3) is bits [SHIFT, SHIFT + BITS) of the pattern.
template <int PASS>
struct Digit {
  static constexpr int BITS = PASS == 3 ? 7 : 8;
  static constexpr int SHIFT = PASS == 3 ? 0 : 23 - 8 * PASS;
  static constexpr int NB = 1 << BITS;
};

// Between the two barriers of a pass: fold the warps' copies into one count
// a bin (zeroing them for the next pass) and take each group of 32 bins'
// suffix sums.
template <int NB>
__device__ __forceinline__ void fold(Scratch& s) {
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < NB / 32; g += warps) {
    const int b = g * 32 + lane;
    int c = 0;
    for (int w = 0; w < warps; ++w) {
      c += s.hist[w][b];
      s.hist[w][b] = 0;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(FULL, c, off);
      if (lane + off < 32) c += y;
    }
    s.suf[b] = c;
    if (lane == 0) s.group[g] = c;
  }
}

// After the second barrier, in every warp: the bin where the suffix count
// from the top first reaches `rank`, and the rank left inside it. Some bin
// always does: the candidates of a pass number at least the rank.
template <int NB>
__device__ __forceinline__ unsigned pick(const Scratch& s, int& rank) {
  constexpr int G = NB / 32;
  const int lane = threadIdx.x & 31;
  // groups from the top: lane l sums groups G-1 .. G-1-l
  int cg = lane < G ? s.group[G - 1 - lane] : 0;
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const int y = __shfl_up_sync(FULL, cg, off);
    if (lane >= off) cg += y;
  }
  const int first = __ffs(__ballot_sync(FULL, lane < G && cg >= rank)) - 1;
  const int g = G - 1 - first;
  const int above = first > 0 ? __shfl_sync(FULL, cg, first - 1) : 0;
  // from bin g*32 + lane to the top: non-increasing in lane, >= rank at 0
  const int incl = s.suf[g * 32 + lane] + above;
  const int top = 31 - __clz(__ballot_sync(FULL, incl >= rank));
  const int next = __shfl_sync(FULL, incl, (top + 1) & 31);
  rank -= top == 31 ? above : next;
  return (unsigned)(g * 32 + top);
}

// One digit pass over this thread's keys (`keys(f)` calls f(key) on each;
// NO_KEY for a slot past the row); every thread of the CTA must call it.
// Returns the prefix extended by the chosen digit.
template <int PASS, typename Keys>
__device__ __forceinline__ unsigned radix_pass(const Keys& keys,
                                               unsigned prefix, int& rank,
                                               unsigned& hi, Scratch& s) {
  using D = Digit<PASS>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* h = s.hist[warp];
  unsigned mx = 0u;
  keys([&](unsigned key) {
    // bit 31 is 0 on every pattern of the row, and 1 on NO_KEY
    if ((key >> (D::SHIFT + D::BITS)) == prefix) {
      atomicAdd(h + ((key >> D::SHIFT) & (D::NB - 1)), 1);
      if constexpr (PASS == 0) mx = key > mx ? key : mx;
    }
  });
  if constexpr (PASS == 0) {
    mx = __reduce_max_sync(FULL, mx);
    if (lane == 0) s.umax[warp] = mx;
  }
  __syncthreads();
  fold<D::NB>(s);
  __syncthreads();
  if constexpr (PASS == 0) {
    const unsigned m = lane < (int)(blockDim.x >> 5) ? s.umax[lane] : 0u;
    hi = __reduce_max_sync(FULL, m);
  }
  return (prefix << D::BITS) | pick<D::NB>(s, rank);
}

// The reference's 40 bisection steps with pred = (m_k >= mid): lo, bit for
// bit (see the header). Scalar, in registers, no barrier.
__device__ __forceinline__ float lo_from_kth(float hi, float mk) {
  float lo = 0.0f;
  for (int it = 0; it < N_ITERS; ++it) {
    const float mid = flush(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
    const bool pred = mk >= mid;
    lo = pred ? mid : lo;
    hi = pred ? hi : mid;
  }
  return lo;
}

// The selection over this thread's keys: m_k and hi by 4 digit passes
// (9 barriers), then lo from thread 0's recurrence (1 barrier). Every
// thread of the CTA must call it; all get the same lo.
template <typename Keys>
__device__ __forceinline__ float select_lo(const Keys& keys, int k,
                                           Scratch& s) {
  const int n = (blockDim.x >> 5) * BINS;
  for (int j = threadIdx.x; j < n; j += blockDim.x) (&s.hist[0][0])[j] = 0;
  __syncthreads();
  int rank = k;
  unsigned hi;
  unsigned p = radix_pass<0>(keys, 0u, rank, hi, s);
  p = radix_pass<1>(keys, p, rank, hi, s);
  p = radix_pass<2>(keys, p, rank, hi, s);
  p = radix_pass<3>(keys, p, rank, hi, s);
  if (threadIdx.x == 0) s.lo = lo_from_kth(__uint_as_float(hi),
                                           __uint_as_float(p));
  __syncthreads();
  return s.lo;
}

// Where element i of this thread's ITEMS lies in a row on the register
// path: element t + i * T (T = blockDim.x), or with VEC (block % 4 == 0,
// 16-byte rows) element i % 4 of the float4 t + (i / 4) * T. Both read the
// row coalesced; VEC in 16 bytes a load.
template <bool VEC>
__device__ __forceinline__ int item_index(int i) {
  return VEC ? 4 * ((int)threadIdx.x + (i >> 2) * (int)blockDim.x) + (i & 3)
             : (int)threadIdx.x + i * (int)blockDim.x;
}

// The register path: this thread's values v[0..ITEMS) of a row of `block`
// elements (v[i] at item_index<VEC>(i)); returns lo (the row's mask is
// flush(|v|) >= lo).
template <bool VEC>
__device__ __forceinline__ float select_kth(const float (&v)[ITEMS],
                                            int block, int k, Scratch& s) {
  return select_lo(
      [&](auto&& f) {
#pragma unroll
        for (int i = 0; i < ITEMS; ++i)
          f(item_index<VEC>(i) < block ? mag_key(v[i]) : NO_KEY);
      },
      k, s);
}

// Calls f(idx, value(idx)) on elements idx = threadIdx.x, + blockDim.x, ...
// of a row of `block`, BATCH reads in flight.
template <typename Value, typename F>
__device__ __forceinline__ void for_each_wide(const Value& value, int block,
                                              F&& f) {
  for (int base = threadIdx.x; base < block; base += BATCH * blockDim.x) {
    float t[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = base + j * blockDim.x;
      t[j] = idx < block ? value(idx) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = base + j * blockDim.x;
      if (idx < block) f(idx, t[j]);
    }
  }
}

// The wide path: a row of any length, each value read through `value(idx)`
// (0 <= idx < block) once a pass; returns lo as select_kth.
template <typename Value>
__device__ __forceinline__ float select_kth_wide(const Value& value,
                                                 int block, int k,
                                                 Scratch& s) {
  return select_lo(
      [&](auto&& f) {
        for_each_wide(value, block,
                      [&](int, float v) { f(mag_key(v)); });
      },
      k, s);
}

}  // namespace block_select
