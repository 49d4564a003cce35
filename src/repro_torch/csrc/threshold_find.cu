// threshold_find: exact per-client k-th-largest |x| (or |e + x|) at runtime k.
//
// Replaces the Pallas TPU kernel src/repro/kernels/threshold_find.py
// (threshold_find_pallas / _threshold_find_kernel). The result is the one
// that kernel's 16-ary bit-pattern search gives: the k-th-largest f32 bit
// pattern of the magnitude (ties kept), a single well-defined value, so a
// different exact search finds the same bits. The plain PyTorch twin
// (kernels/threshold_find.py) repeats the reference's 8 sweeps and this
// kernel is held to it bit for bit.
//
// Design: an exact radix select on the 31-bit pattern, most significant
// digits first, in three passes of 11, 11 and 9 bits:
//
//   pass 1  histogram of bits >> 20 (2048 bins) over the whole row, and the
//           row absmax (atomicMax on the non-negative pattern);
//   pass 2  histogram of (bits >> 9) & 2047 over the elements whose top 11
//           bits are the bin pass 1 chose; when that bin holds no more
//           than n/8 of the row (pass 1's count says so) those elements'
//           patterns are also compacted into a candidate buffer of n/8 a
//           client, exactly: a warp stages them in shared memory and
//           writes each full stage with one global atomic on the client's
//           cursor;
//   pass 3  histogram of bits & 511 over the elements whose top 22 bits are
//           the prefix passes 1 and 2 chose, read from the candidates when
//           pass 2 compacted them, else from x again.
//
// Each pass is one launch over (column chunk, client) blocks. A block
// counts into a histogram in shared memory and adds its nonzero bins into
// the client's global histogram with integer atomics, so the totals do not
// depend on the order of the atomics (nor on the order in which warps
// append candidates). The last block of a client to finish (a ticket:
// __threadfence, then an atomic counter) picks the bin where the suffix
// count from the top first reaches k, and hands the prefix, the rank left
// inside that bin and the bin's count to the next pass; the last block of
// pass 3 writes the threshold (and, when asked, the reads of x the client
// took), and that of pass 1 the absmax. A row with fewer than k elements
// (k > n) picks bin 0 in every pass, threshold 0, as the twin gives.
// Patterns compare as unsigned values, as before, so NaN and inf patterns
// (0x7f800000 and above) order exactly as in the twin.
//
// A call is 4 launches (one memset of the scratch, three passes) and reads
// x (and e) 2 times for a client whose chosen top-11-bit bin holds at most
// n/8 of its elements, 3 times otherwise (a bin that large: ties, zeros,
// all-equal rows); the previous design (8 sweeps) took 11 launches and 8
// reads. With magnitudes spread over many binades (an update, Top-K at a
// cr of 0.1) the bin holds a few percent of the row. The ragged edge is
// masked in the loop, never padded; float4 reads where every row is
// 16-byte aligned (n % 4 == 0 and aligned bases).
//
// Bound on the card: bytes. The least the card could do is one read of x
// (C*n*4 bytes, twice with EF); this design reads 2 times, 3 for a client
// whose bin is too large. Each thread keeps 4 float4 loads in flight
// before it counts them. A few exponents hold most of the magnitudes, so
// pass 1's shared-memory atomics meet on a handful of hot bins;
// aggregating equal bins of a warp first (__match_any_sync) measured
// slower on the card.
//
// Plain C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the last launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BINS = 2048;                 // the widest digit: 11 bits
constexpr int UNROLL = 4;                  // float4 loads in flight a thread
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = 128;                 // candidates a warp stages

// Scratch, int32, zeroed by one memset: the three global histograms, the
// three ticket counters, the absmax pattern, the candidate cursors and the
// hand-overs (prefix, rank, count of the chosen bin) from pass 1 to 2 and
// from pass 2 to 3.
struct Layout {
  int C;
  __host__ __device__ int* hist(int* s, int pass, int c) const {
    // pass 1, 2: [C][2048]; pass 3: [C][512]
    return s + (pass - 1) * C * BINS + c * (pass == 3 ? 512 : BINS);
  }
  __host__ __device__ int* tickets(int* s, int pass) const {
    return s + 2 * C * BINS + C * 512 + (pass - 1) * C;
  }
  __host__ __device__ unsigned* amax(int* s) const {
    return reinterpret_cast<unsigned*>(s + 2 * C * BINS + C * 512 + 3 * C);
  }
  __host__ __device__ int* cursor(int* s) const {
    return s + 2 * C * BINS + C * 512 + 4 * C;
  }
  // the hand-over written by the last block of `pass`: [C][4]
  __host__ __device__ int* sel(int* s, int pass, int c) const {
    return s + 2 * C * BINS + C * 512 + 5 * C + (pass - 1) * 4 * C + 4 * c;
  }
  __host__ __device__ size_t ints() const {
    return (size_t)2 * C * BINS + (size_t)C * 512 + 13 * (size_t)C;
  }
};

// Candidates a client's buffer holds: n / 8, at least 1.
__host__ __device__ inline long long cand_cap(long long n) {
  return n / 8 > 0 ? n / 8 : 1;
}

template <int PASS>
struct Digit {
  static constexpr int BITS = PASS == 3 ? 9 : 11;
  static constexpr int NB = 1 << BITS;
  static constexpr int LOW = PASS == 1 ? 20 : PASS == 2 ? 9 : 0;
};

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  return __reduce_max_sync(0xffffffffu, v);
}

// The last block of client c picks the bin of `h` (NB bins, read from
// global memory after the other blocks' atomics) where the suffix count
// from the top first reaches `rank`: the largest b with
// sum_{j >= b} h[j] >= rank (b = 0 if none), and the count above it.
template <int NB>
__device__ void pick_bin(const int* h, int rank, int* s_sum, int& bin,
                         int& above) {
  constexpr int P = NB / THREADS;          // bins per thread, >= 2
  const int t = threadIdx.x;
  int v[P];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    v[j] = __ldcg(h + t * P + j);          // L2: written by other blocks
    sum += v[j];
  }
  // suffix sums over threads, from the top: above_t = sum of threads > t
  s_sum[t] = sum;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const int add = t + off < THREADS ? s_sum[t + off] : 0;
    __syncthreads();
    s_sum[t] += add;
    __syncthreads();
  }
  const int total = s_sum[0];
  const int above_t = s_sum[t] - sum;
  __shared__ int s_bin, s_above;
  if (t == 0) {
    s_bin = 0;
    s_above = total - __ldcg(h);           // no bin reaches rank: bin 0
  }
  __syncthreads();
  if (above_t < rank && above_t + sum >= rank) {
    int run = above_t;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      if (run + v[j] >= rank) {
        s_bin = t * P + j;
        s_above = run;
        break;
      }
      run += v[j];
    }
  }
  __syncthreads();
  bin = s_bin;
  above = s_above;
}

// One pass: grid (chunks, C).
template <int PASS, bool EF, bool VEC>
__global__ void __launch_bounds__(THREADS)
radix_pass(const float* __restrict__ x, const float* __restrict__ e,
           const int* __restrict__ ks, int* __restrict__ scratch,
           unsigned* __restrict__ cand, int* __restrict__ th,
           float* __restrict__ absmax_out, int* __restrict__ reads,
           long long n, int C) {
  using D = Digit<PASS>;
  const Layout L{C};
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  __shared__ int s_hist[D::NB];
  __shared__ int s_sum[THREADS];
  __shared__ unsigned s_amax;
  __shared__ bool s_last;
  for (int j = threadIdx.x; j < D::NB; j += THREADS) s_hist[j] = 0;
  if (threadIdx.x == 0) s_amax = 0u;
  const int* in = PASS == 1 ? nullptr : L.sel(scratch, PASS - 1, c);
  const unsigned prefix = PASS == 1 ? 0u : (unsigned)in[0];
  // pass 1's bin fits the candidate buffer: pass 2 fills it with exactly
  // the bin's elements, pass 3 reads them instead of x
  const long long cap = cand_cap(n);
  const int* first = PASS == 1 ? nullptr : L.sel(scratch, 1, c);
  const long long count = PASS == 1 ? 0 : first[2];
  const bool compact = PASS != 1 && count <= cap;
  unsigned* my_cand = cand + (size_t)c * cap;
  int* cursor = L.cursor(scratch) + c;
  __shared__ unsigned s_stage[PASS == 2 ? WARPS * STAGE : 1];
  unsigned* stage = s_stage + (PASS == 2 ? (threadIdx.x >> 5) * STAGE : 0);
  __syncthreads();

  unsigned amax = 0u;
  // count one pattern; returns whether it carries the earlier digits
  auto visit = [&](unsigned bits) -> bool {
    if constexpr (PASS == 1) {
      amax = bits > amax ? bits : amax;
      atomicAdd(&s_hist[bits >> D::LOW], 1);
      return true;
    } else if ((bits >> (D::LOW + D::BITS)) == prefix) {
      atomicAdd(&s_hist[(bits >> D::LOW) & (D::NB - 1)], 1);
      return true;
    }
    return false;
  };
  // pass 2, warp-collective: the warp's staged candidates go to the
  // client's buffer at a cursor it advances by their number (one global
  // atomic a stage), so the buffer ends holding each of them once
  int w_used = 0;                              // the same in every lane
  auto flush = [&]() {
    int base = 0;
    if (lane == 0) base = atomicAdd(cursor, w_used);
    base = __shfl_sync(0xffffffffu, base, 0);
    for (int j = lane; j < w_used; j += 32) my_cand[base + j] = stage[j];
    __syncwarp();
    w_used = 0;
  };
  auto append = [&](unsigned bits, bool take) {
    const unsigned m = __ballot_sync(0xffffffffu, take);
    if (m == 0u) return;
    const int cnt = __popc(m);
    if (w_used + cnt > STAGE) flush();
    if (take) stage[w_used + __popc(m & ((1u << lane) - 1u))] = bits;
    __syncwarp();
    w_used += cnt;
  };
  auto pattern = [](float v) { return __float_as_uint(fabsf(v)); };

  const long long stride = (long long)gridDim.x * blockDim.x;
  // the warp's first item: loop conditions are the same for all lanes
  const long long w_start =
      (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
  if (PASS == 3 && compact) {
    for (long long w0 = w_start; w0 < count; w0 += stride)
      if (w0 + lane < count) visit(my_cand[w0 + lane]);
  } else if (VEC) {
    // UNROLL float4 loads in flight a thread before any is counted
    const float4* x4 =
        reinterpret_cast<const float4*>(x + (size_t)c * n);
    const float4* e4 =
        reinterpret_cast<const float4*>(EF ? e + (size_t)c * n : nullptr);
    const long long n4 = n / 4;
    long long w0 = w_start;
    for (; w0 + (UNROLL - 1) * stride + 31 < n4; w0 += UNROLL * stride) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = x4[w0 + lane + u * stride];
      if (EF) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float4 r = e4[w0 + lane + u * stride];
          v[u].x = __fadd_rn(r.x, v[u].x); v[u].y = __fadd_rn(r.y, v[u].y);
          v[u].z = __fadd_rn(r.z, v[u].z); v[u].w = __fadd_rn(r.w, v[u].w);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned b[4] = {pattern(v[u].x), pattern(v[u].y),
                               pattern(v[u].z), pattern(v[u].w)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool hit = visit(b[q]);
          if (PASS == 2 && compact) append(b[q], hit);
        }
      }
    }
    for (; w0 < n4; w0 += stride) {
      const long long i = w0 + lane;
      const bool ok = i < n4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        v = x4[i];
        if (EF) {
          const float4 r = e4[i];
          v.x = __fadd_rn(r.x, v.x); v.y = __fadd_rn(r.y, v.y);
          v.z = __fadd_rn(r.z, v.z); v.w = __fadd_rn(r.w, v.w);
        }
      }
      const unsigned b[4] = {pattern(v.x), pattern(v.y), pattern(v.z),
                             pattern(v.w)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool hit = ok && visit(b[q]);
        if (PASS == 2 && compact) append(b[q], hit);
      }
    }
  } else {
    const float* xr = x + (size_t)c * n;
    const float* er = EF ? e + (size_t)c * n : nullptr;
    for (long long w0 = w_start; w0 < n; w0 += stride) {
      const long long i = w0 + lane;
      const bool ok = i < n;
      const unsigned b =
          ok ? pattern(EF ? __fadd_rn(er[i], xr[i]) : xr[i]) : 0u;
      const bool hit = ok && visit(b);
      if (PASS == 2 && compact) append(b, hit);
    }
  }
  if constexpr (PASS == 1) {
    const unsigned m = warp_max(amax);
    if (lane == 0) atomicMax(&s_amax, m);
  }
  if (PASS == 2 && compact && w_used > 0) flush();
  __syncthreads();

  int* gh = L.hist(scratch, PASS, c);
  for (int j = threadIdx.x; j < D::NB; j += THREADS)
    if (s_hist[j]) atomicAdd(gh + j, s_hist[j]);
  if (PASS == 1 && threadIdx.x == 0) atomicMax(L.amax(scratch) + c, s_amax);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(L.tickets(scratch, PASS) + c, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const int rank = PASS == 1 ? ks[c] : in[1];
  int bin, above;
  pick_bin<D::NB>(gh, rank, s_sum, bin, above);
  if (threadIdx.x == 0) {
    const unsigned p = (prefix << D::BITS) | (unsigned)bin;
    if (PASS == 3) {
      th[c] = (int)p;
      if (reads != nullptr) reads[c] = compact ? 2 : 3;
    } else {
      int* out = L.sel(scratch, PASS, c);
      out[0] = (int)p;
      out[1] = rank - above;
      out[2] = __ldcg(gh + bin);            // elements in the chosen bin
    }
    if (PASS == 1 && absmax_out != nullptr)
      absmax_out[c] = __uint_as_float(__ldcg(L.amax(scratch) + c));
  }
}

template <bool EF, bool VEC>
cudaError_t run_passes(dim3 grid, cudaStream_t st, const float* x,
                       const float* e, const int* ks, int* scratch,
                       unsigned* cand, int* th, float* absmax, int* reads,
                       long long n, int C) {
  radix_pass<1, EF, VEC><<<grid, THREADS, 0, st>>>(x, e, ks, scratch, cand,
                                                   th, absmax, reads, n, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  radix_pass<2, EF, VEC><<<grid, THREADS, 0, st>>>(x, e, ks, scratch, cand,
                                                   th, absmax, reads, n, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  radix_pass<3, EF, VEC><<<grid, THREADS, 0, st>>>(x, e, ks, scratch, cand,
                                                   th, absmax, reads, n, C);
  return cudaGetLastError();
}

}  // namespace

// Ints of scratch (zeroed by the call) a call needs for C clients.
extern "C" long long threshold_find_scratch_ints(int C) {
  return (long long)Layout{C}.ints();
}

// Ints of candidate buffer (not zeroed) a call needs for C clients of n.
extern "C" long long threshold_find_cand_ints(int C, long long n) {
  return (long long)C * cand_cap(n);
}

// x, e: [C, n] f32 contiguous (e may be null: no EF); ks: [C] i32 with
// 1 <= k <= n; th: [C] i32 out (the threshold pattern, always < 2^31);
// absmax: [C] f32 out or null; reads: [C] i32 out or null (the reads of x
// each client took, 2 or 3); scratch: threshold_find_scratch_ints(C) i32;
// cand: threshold_find_cand_ints(C, n) i32.
extern "C" int threshold_find_launch(const void* x, const void* e,
                                     const void* ks, void* th, void* absmax,
                                     void* reads, void* scratch, void* cand,
                                     long long n, int C, void* stream) {
  if (n < 1 || C < 1 || C > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* ef = static_cast<const float*>(e);
  const int* k = static_cast<const int*>(ks);
  int* s = static_cast<int*>(scratch);
  unsigned* cd = static_cast<unsigned*>(cand);
  float* am = static_cast<float*>(absmax);
  int* rd = static_cast<int*>(reads);
  int* t = static_cast<int*>(th);

  cudaError_t err =
      cudaMemsetAsync(s, 0, sizeof(int) * Layout{C}.ints(), st);
  if (err != cudaSuccess) return err;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(xf) % 16 == 0) &&
      (ef == nullptr || reinterpret_cast<uintptr_t>(ef) % 16 == 0);
  const bool vec = aligned && (n % 4 == 0);
  const long long items = vec ? n / 4 : n;
  long long want = (items + THREADS - 1) / THREADS;
  long long cap = 1056 / C;        // ~8 blocks per SM over the whole grid
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)C);
  if (ef != nullptr)
    return vec ? run_passes<true, true>(grid, st, xf, ef, k, s, cd, t, am,
                                        rd, n, C)
               : run_passes<true, false>(grid, st, xf, ef, k, s, cd, t, am,
                                         rd, n, C);
  return vec ? run_passes<false, true>(grid, st, xf, ef, k, s, cd, t, am, rd,
                                       n, C)
             : run_passes<false, false>(grid, st, xf, ef, k, s, cd, t, am,
                                        rd, n, C);
}
