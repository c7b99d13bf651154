// The group-rank coder's reverse-rANS emission, for Hopper (sm_90a).
// tpulc leaves this stage to XLA (tpulc/codecs/bsclike/grc.py:
// _reverse_rans_t, a fori_loop over event steps); it reads K5's output.
// Wrapper and plain PyTorch version: tpulc_torch/codecs/bsclike/
// grc_kernels.py (grc_reverse_rans).
//
// gmb int32[W, L] event grid and probs int32[W, L] (K5's), time-major
// -> words int32[L, W+2] (uint16 values, then zeros: every entry is
// written here), counts int64[L], states int64[L] (uint32 values).  Lane
// l starts at x = 2^16 and walks t = nsteps-1 down to 0; a slot with gmb
// > 0 codes its bit at probability probs (f = p or 4096 - p): first,
// when x >= f << 20, it emits x's low 16 bits and shifts x right by 16;
// then x = (x / f) << 12 + x % f + c.  Row l holds the lane's words last
// emitted first, then zeros.  uint32 arithmetic wraps mod 2^32, as the
// plain version's int64 masked to 32 bits; f is formed in 64 bits and
// the divisor is max(f, 1).
//
// Bound on the H100: each lane is a serial chain of nsteps dependent
// state updates (6 dependent operations a step); its byte bound is the
// two grids' rows < nsteps read once and the words (zeros included)
// written once.  On the card neither binds: a step costs ~90-120 ns
// where its chain needs ~12, and probes with the arithmetic taken out
// ran as long: streaming the grids' rows, 4 KB (1,024 lanes) to 100 KB
// (25,600 lanes) apart, sets the pace, the more so the more warps an SM
// streams.  Both designs run one step (rans_step): x' = q (4096 - f) +
// y + c and the remainder y - q f are two multiply-adds of the quotient
// q, side by side; a slot with no event takes 4096 - f = 0 and c = 0,
// which leaves x as it is.  The design is picked by L in the C entry:
// - the ring (ring_kernel), while its blocks fit one wave (up to
//   16,384 lanes, a 16 MiB bucket, at the H100's 132 SMs; the bsc -e2
//   block of pg1661 x 6: 1,024 lanes): a block a warp, which stages both grids through shared
//   memory in a ring of kStages stages of kB steps x its 32 columns
//   (16-byte cp.async pieces, 4-byte ones for a ragged last warp or an
//   unaligned grid), kStages - 1 stages ahead of the walk; a stage with
//   no event in the warp is skipped.  A lane's words wait in a ring of
//   kRing in shared memory (its oldest go to the end of its row when the
//   next stage could overflow it, which no real block does); each stage
//   zeroes the next 16-byte pieces of [kRing, W + 2) of the lane's own
//   row, and after the walk the warp writes each row, the newest word
//   first: each entry written once, coalesced.
// - registers (regs_kernel, the first design) past that (a 25 MiB
//   block: 25,600 lanes): a thread a lane, a block a warp, no shared
//   memory, the grids prefetched a register batch of kB steps ahead, the
//   words stored in emission order and reversed in place, after a
//   memset of the words on the same stream.  At 25,600 lanes every ring
//   build (1 or 4 warps a block, 128 or 512 ring words, 4 or 8 stages,
//   with or without a reciprocal table, zeros in the walk or after it,
//   two lanes a thread) took 1.13-1.78 ms against its 1.02.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kProbBits = 12;
constexpr int kScale = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kB = 16;        // steps a stage, and a register batch
constexpr int kStages = 4;    // stages of a warp's ring
constexpr int kRing = 512;    // words a lane's ring holds (a power of 2)

// a warp's stage: its 32 columns of both grids, kB steps
struct Stage {
  int32_t e[kB][32];
  int32_t p[kB][32];
};

// the ring kernel's shared memory: its stages, then a lane's ring of
// kRing + 2 uint16 (an odd number of 4-byte words, so that the lanes'
// rings start in different banks)
constexpr size_t kRingSmem =
    sizeof(Stage) * kStages + sizeof(uint16_t) * (kRing + 2) * 32;

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the first entry at or after a of row r that is 16-byte aligned (at
// most b)
__device__ __forceinline__ int aligned_from(const int32_t* r, int a, int b) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(r + a) >> 2) &
                                   3);
  return min(a + ((4 - mis) & 3), b);
}

// r[a, b) = 0 by the warp: 16-byte stores between 4-byte edges
__device__ __forceinline__ void zero_range(int32_t* r, int a, int b,
                                           int lane) {
  if (a >= b) return;
  const int a4 = aligned_from(r, a, b);
  const int b4 = a4 + (b - a4) / 4 * 4;
  for (int i = a + lane; i < a4; i += 32) r[i] = 0;
  for (int i = a4 + 4 * lane; i < b4; i += 128)
    *reinterpret_cast<int4*>(r + i) = make_int4(0, 0, 0, 0);
  for (int i = b4 + lane; i < b; i += 32) r[i] = 0;
}

// stage q of the warp's lanes l0 + i (i < 32): steps t = nsteps-1 -
// q*kB - j, zeros below row 0 and past the last lane.  vec (the warp's
// columns whole, L a multiple of 4, both grids 16-byte aligned): each
// row of each grid goes as 16-byte pieces, 8 lanes a row, which the
// others read after a __syncwarp; else lane i copies column l0 + i, 4
// bytes a step.
__device__ __forceinline__ void fill_stage(Stage& st, const int32_t* gmb,
                                           const int32_t* probs, int l0,
                                           int L, int top, bool vec,
                                           int lane) {
  if (vec) {
    const int piece = lane % 8;
#pragma unroll
    for (int j0 = 0; j0 < kB; j0 += 4) {
      const int j = j0 + lane / 8;
      const int t = top - j;
      if (t < 0) {
        *reinterpret_cast<int4*>(&st.e[j][4 * piece]) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(&st.p[j][4 * piece]) = make_int4(0, 0, 0, 0);
        continue;
      }
      const size_t at = static_cast<size_t>(t) * L + l0 + 4 * piece;
      cp_async16(&st.e[j][4 * piece], gmb + at);
      cp_async16(&st.p[j][4 * piece], probs + at);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int t = top - j;
    const int l = l0 + lane;
    const bool ok = l < L && t >= 0;
    const size_t at = ok ? static_cast<size_t>(t) * L + l : 0;
    cp_async4(&st.e[j][lane], gmb + at, ok);
    cp_async4(&st.p[j][lane], probs + at, ok);
  }
}

// One step of a lane: the state's chain; true where it emits x's low 16
// bits from before the step.  x / fx as a multiply-high by rcp =
// floor((2^32 - 1) / fx): rcp * fx > 2^32 - 1 - fx, so the estimate is
// floor(x / fx) or one less: one correction, which adds 4096 - fx to x'
// = q (4096 - fx) + y + c.  rcp depends on the probability alone, off
// the chain.
__device__ __forceinline__ bool rans_step(int e, int p, uint32_t& x) {
  const bool vq = e > 0;
  const bool bit = e & 1;
  const long long f = bit ? static_cast<long long>(p)
                          : kScale - static_cast<long long>(p);
  const uint32_t fx = static_cast<uint32_t>(f > 1 ? f : 1);
  const uint32_t rcp = 0xFFFFFFFFu / fx;
  const uint32_t k = vq ? static_cast<uint32_t>(kScale) - fx : 0u;
  const uint32_t c =
      vq && bit ? static_cast<uint32_t>(kScale - static_cast<long long>(p))
                : 0u;
  const bool emit =
      vq && x >= (static_cast<uint32_t>(f) << (32 - kProbBits));
  const uint32_t y = emit ? x >> 16 : x;
  const uint32_t q = __umulhi(y, rcp);
  const uint32_t r = q * (0u - fx) + y;
  const uint32_t t = q * k + (y + c);
  x = r >= fx ? t + k : t;
  return emit;
}

__global__ void __launch_bounds__(32)
    ring_kernel(const int32_t* __restrict__ gmb,
                const int32_t* __restrict__ probs,
                int32_t* __restrict__ words, long long* __restrict__ counts,
                long long* __restrict__ states, int W, int L, int nsteps) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* stages = reinterpret_cast<Stage*>(smem);
  auto* rings = reinterpret_cast<uint16_t*>(smem + sizeof(Stage) * kStages);
  const int lane = threadIdx.x;
  uint16_t* ring = rings + lane * (kRing + 2);
  const int l0 = blockIdx.x * 32, l = l0 + lane;
  const bool live = l < L;
  const int nl = min(32, L - l0);
  const size_t rw = static_cast<size_t>(W) + 2;
  int32_t* rows = words + static_cast<size_t>(l0) * rw;
  int32_t* row = rows + static_cast<size_t>(lane) * rw;
  const int kz = min(kRing, W + 2);
  const int nq = (nsteps + kB - 1) / kB;
  const bool vec = L % 4 == 0 && l0 + 32 <= L &&
                   (reinterpret_cast<uintptr_t>(gmb) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(probs) & 15) == 0;
  // the zeros of [kz, W + 2) leave as 16-byte stores from the first
  // aligned entry, nz a stage, below the lane's spilled words
  int zpos = aligned_from(row, kz, W + 2);
  const int zend = zpos + (W + 2 - zpos) / 4 * 4;
  const int nz = ((W + 2 - kz) / 4 + max(nq, 1) - 1) / max(nq, 1);
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nq)
      fill_stage(stages[q], gmb, probs, l0, L, nsteps - 1 - q * kB, vec,
                 lane);
    cp_async_commit();
  }
  uint32_t x = kRansL;
  int count = 0, spilled = 0;
  for (int q = 0; q < nq; ++q) {
    // the slot of stage q - 1, whose reads by every lane ended in the
    // last iteration
    const int qn = q + kStages - 1;
    __syncwarp();
    if (qn < nq)
      fill_stage(stages[qn % kStages], gmb, probs, l0, L,
                 nsteps - 1 - qn * kB, vec, lane);
    cp_async_commit();
    if (live) {
      const int lim = min(zend, W + 2 - spilled);
      for (int k = 0; k < nz && zpos + 4 <= lim; ++k, zpos += 4)
        *reinterpret_cast<int4*>(row + zpos) = make_int4(0, 0, 0, 0);
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();  // the other lanes' pieces
    const Stage& st = stages[q % kStages];
    int e[kB], p[kB];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      e[j] = st.e[j][lane];
      any |= e[j] > 0;
    }
    if (!__any_sync(kFullMask, any)) continue;
#pragma unroll
    for (int j = 0; j < kB; ++j) p[j] = st.p[j][lane];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const uint32_t before = x;
      const bool emit = rans_step(e[j], p[j], x);
      if (emit) ring[count & (kRing - 1)] = static_cast<uint16_t>(before);
      count += emit;
    }
    // a ring that the next stage could fill: its oldest words go to the
    // row's end, word k at W + 1 - k
    if (__any_sync(kFullMask, count - spilled > kRing - kB))
      for (; count - spilled > kRing - kB; ++spilled)
        row[W + 1 - spilled] = ring[spilled & (kRing - 1)];
  }
  cp_async_wait<0>();
  if (live) {
    counts[l] = count;
    states[l] = x;
  }
  __syncwarp();  // every lane's ring, spilled words and zeros
  for (int j = 0; j < nl; ++j) {
    const int n = __shfl_sync(kFullMask, count, j);
    const int sp = __shfl_sync(kFullMask, spilled, j);
    const int zp = __shfl_sync(kFullMask, zpos, j);
    int32_t* r = rows + j * rw;
    const uint16_t* g = rings + j * (kRing + 2);
    // the newest n - sp words from the ring, last emitted first; then
    // the spilled ones, word k from W + 1 - k to n - 1 - k
    for (int i = lane; i < n - sp; i += 32)
      r[i] = g[(n - 1 - i) & (kRing - 1)];
    if (sp > 0) {
      const int shift = W + 2 - n;
      for (int i0 = n - sp; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const int32_t v = i < n ? r[i + shift] : 0;
        __syncwarp();
        if (i < n) r[i] = v;
        __syncwarp();
      }
      zero_range(r, n, W + 2, lane);
    } else {
      // the zeros the stages left: before their first aligned entry,
      // and from where they stopped
      zero_range(r, n, max(aligned_from(r, kz, W + 2), n), lane);
      zero_range(r, max(zp, n), W + 2, lane);
    }
  }
}

// Rows t0, t0-1, ..., t0-kB+1 of this lane's columns; 0 below row 0.
__device__ __forceinline__ void load_batch(int (&e)[kB], int (&p)[kB],
                                           const int32_t* g,
                                           const int32_t* pr, size_t stride,
                                           int t0) {
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const bool ok = t0 - j >= 0;
    e[j] = ok ? __ldg(g + (t0 - j) * stride) : 0;
    p[j] = ok ? __ldg(pr + (t0 - j) * stride) : 0;
  }
}

// Code rows t0, t0-1, ..., t0-kB+1, storing each word in emission
// order; skipped when no lane of the warp has an event here
// (warp-uniform).
__device__ __forceinline__ void emit_batch(const int (&e)[kB],
                                           const int (&p)[kB], uint32_t& x,
                                           int& count, int32_t* row) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < kB; ++j) any |= e[j] > 0;
  if (!__any_sync(__activemask(), any)) return;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const uint32_t before = x;
    const bool emit = rans_step(e[j], p[j], x);
    if (emit) row[count] = static_cast<int32_t>(before & 0xFFFFu);
    count += emit;
  }
}

// the words must be zero on entry (the C entry's memset)
__global__ void __launch_bounds__(32)
    regs_kernel(const int32_t* __restrict__ gmb,
                const int32_t* __restrict__ probs,
                int32_t* __restrict__ words, long long* __restrict__ counts,
                long long* __restrict__ states, int W, int L, int nsteps) {
  const int l = blockIdx.x * 32 + threadIdx.x;
  if (l >= L) return;
  const size_t stride = static_cast<size_t>(L);
  const int32_t* g = gmb + l;
  const int32_t* pr = probs + l;
  int32_t* row = words + static_cast<size_t>(l) * (W + 2);
  uint32_t x = kRansL;
  int count = 0;
  int ea[kB], pa[kB], eb[kB], pb[kB];
  load_batch(ea, pa, g, pr, stride, nsteps - 1);
  for (int t0 = nsteps - 1; t0 >= 0; t0 -= 2 * kB) {
    load_batch(eb, pb, g, pr, stride, t0 - kB);
    emit_batch(ea, pa, x, count, row);
    if (t0 - kB < 0) break;
    load_batch(ea, pa, g, pr, stride, t0 - 2 * kB);
    emit_batch(eb, pb, x, count, row);
  }
  for (int i = 0, j = count - 1; i < j; ++i, --j) {
    const int32_t v = row[i];
    row[i] = row[j];
    row[j] = v;
  }
  counts[l] = count;
  states[l] = x;
}

// route 0: the ring; 1: registers after a memset of the words
cudaError_t launch(int route, const void* gmb, const void* probs,
                   void* words, void* counts, void* states, int W, int L,
                   int nsteps, cudaStream_t s) {
  const int blocks = (L + 31) / 32;
  nsteps = nsteps < W ? nsteps : W;
  const auto* g = static_cast<const int32_t*>(gmb);
  const auto* p = static_cast<const int32_t*>(probs);
  auto* w = static_cast<int32_t*>(words);
  auto* c = static_cast<long long*>(counts);
  auto* x = static_cast<long long*>(states);
  cudaError_t e;
  if (route == 0) {
    e = cudaFuncSetAttribute(ring_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kRingSmem));
    if (e != cudaSuccess) return e;
    ring_kernel<<<blocks, 32, kRingSmem, s>>>(g, p, w, c, x, W, L, nsteps);
  } else {
    e = cudaMemsetAsync(words, 0,
                        sizeof(int32_t) * static_cast<size_t>(L) * (W + 2),
                        s);
    if (e != cudaSuccess) return e;
    regs_kernel<<<blocks, 32, 0, s>>>(g, p, w, c, x, W, L, nsteps);
  }
  return cudaGetLastError();
}

}  // namespace

// The design the C entry runs for L lanes on the current card: 0, the
// ring, while its one-warp blocks all fit one wave (128 lanes an SM:
// each block's ~49 KB of shared memory leaves room for 4 an SM), else
// 1, registers (a negative cudaError if the card does not answer).  On
// an H100 (132 SMs; bsc -e2 blocks, whose transform bucket gives
// L = bucket / 1,024), device ms ring against registers (PERF.md
// section 6): 1,024 lanes 0.417-0.423 against 0.713; 4,096 0.431-0.435
// against 0.783-0.788; 8,192 0.434-0.439 against 0.775-0.780; 16,384
// 0.816-0.817 against 0.870-0.871; 25,600 (two waves of the ring)
// 1.075-1.080 against 1.015-1.020.
extern "C" int tplc_grc_reverse_rans_route(int L) {
  const int sms = sm_count();
  if (sms < 0) return -static_cast<int>(cudaGetLastError());
  return static_cast<long long>(L) <= 32LL * 4 * sms ? 0 : 1;
}

// words int32[L, W+2] need not be initialised: every entry is written.
extern "C" int tplc_grc_reverse_rans(const void* gmb, const void* probs,
                                     void* words, void* counts,
                                     void* states, int W, int L, int nsteps,
                                     void* stream) {
  if (L <= 0 || W < 0) return static_cast<int>(cudaGetLastError());
  const int route = tplc_grc_reverse_rans_route(L);
  if (route < 0) return -route;
  return static_cast<int>(launch(route, gmb, probs, words, counts, states,
                                 W, L, nsteps < 0 ? 0 : nsteps,
                                 static_cast<cudaStream_t>(stream)));
}
