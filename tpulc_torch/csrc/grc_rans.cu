// The group-rank coder's reverse-rANS emission, for Hopper (sm_90a).
// tpulc leaves this stage to XLA (tpulc/codecs/bsclike/grc.py:
// _reverse_rans_t, a fori_loop over event steps); it reads K5's output.
// Wrapper and plain PyTorch version: tpulc_torch/codecs/bsclike/
// grc_kernels.py (grc_reverse_rans).
//
// gmb int32[W, L] event grid and probs int32[W, L] (K5's), time-major
// -> words int32[L, W+2] (uint16 values, zeroed by the caller), counts
// int64[L], states int64[L] (uint32 values).  Lane l starts at x =
// 2^16 and walks t = nsteps-1 down to 0; a slot with gmb > 0 codes its
// bit at probability probs (f = p or 4096 - p): first, when x >= f <<
// 20, it emits x's low 16 bits and shifts x right by 16; then x = (x /
// f) << 12 + x % f + c.  Words land in the lane's row in emission
// order, and the row's first `count` entries are reversed at the end.
// uint32 arithmetic wraps mod 2^32, as the plain version's int64 masked
// to 32 bits; f is formed in 64 bits and the divisor is max(f, 1).
//
// Bound on the H100: each lane is a serial chain of nsteps dependent
// state updates (a compare, a shift and a 32-bit divide by a divisor
// known ahead); its byte bound is the two grids' rows < nsteps read
// once and the words written once.  Design: one thread a lane, one warp
// a block, so few lanes still spread over many SMs; the divide is a
// multiply-high by a reciprocal formed off the chain; the steps have no
// branches, so a batch is one basic block the scheduler can overlap;
// the grids are prefetched kBatch steps ahead into registers (two
// register batches in turn), and a warp's reads of one step are one
// coalesced row; a batch with no event in the warp is skipped; a word
// store (about one per 18 events) is never waited on.  No shared memory, and 800 one-warp
// blocks need ~6 of an SM's 32 block slots, so the 25,600 lanes of a
// 25 MiB block are resident at once: one wave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 16;
constexpr int kThreads = 32;
constexpr int kProbBits = 12;
constexpr int kScale = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;

// Rows t0, t0-1, ..., t0-kBatch+1 of this lane's columns; 0 below row 0.
__device__ __forceinline__ void load_batch(int (&e)[kBatch],
                                           int (&p)[kBatch],
                                           const int32_t* g,
                                           const int32_t* pr, size_t stride,
                                           int t0) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const bool ok = t0 - j >= 0;
    e[j] = ok ? __ldg(g + (t0 - j) * stride) : 0;
    p[j] = ok ? __ldg(pr + (t0 - j) * stride) : 0;
  }
}

// Code rows t0, t0-1, ..., t0-kBatch+1: branch-free steps (selects and
// a predicated word store); skipped when no lane of the warp has an
// event here (warp-uniform).
__device__ __forceinline__ void emit_batch(const int (&e)[kBatch],
                                           const int (&p)[kBatch],
                                           uint32_t& x, int& count,
                                           int32_t* row) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) any |= e[j] > 0;
  if (!__any_sync(__activemask(), any)) return;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const bool vq = e[j] > 0;
    const bool bit = e[j] & 1;
    const long long f = bit ? static_cast<long long>(p[j])
                            : kScale - static_cast<long long>(p[j]);
    const uint32_t c =
        bit ? static_cast<uint32_t>(kScale - static_cast<long long>(p[j]))
            : 0u;
    const uint32_t x_max = static_cast<uint32_t>(f) << (32 - kProbBits);
    const uint32_t fx = static_cast<uint32_t>(f > 1 ? f : 1);
    // x / fx as a multiply-high by rcp = floor((2^32 - 1) / fx):
    // rcp * fx > 2^32 - 1 - fx, so x * rcp / 2^32 > x / fx - 1 and the
    // estimate is floor(x / fx) or one less: one correction.  rcp
    // depends on the prefetched probability only, off the chain.
    const uint32_t rcp = 0xFFFFFFFFu / fx;
    const bool emit = vq && x >= x_max;
    if (emit) row[count] = static_cast<int32_t>(x & 0xFFFFu);
    count += emit;
    const uint32_t y = emit ? x >> 16 : x;
    uint32_t q = __umulhi(y, rcp);
    uint32_t r = y - q * fx;
    const bool over = r >= fx;
    q += over;
    r -= over ? fx : 0u;
    x = vq ? (q << kProbBits) + r + c : x;
  }
}

__global__ void __launch_bounds__(kThreads)
grc_rans_kernel(const int32_t* __restrict__ gmb,
                const int32_t* __restrict__ probs,
                int32_t* __restrict__ words, long long* __restrict__ counts,
                long long* __restrict__ states, int W, int L, int nsteps) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const size_t stride = static_cast<size_t>(L);
  const int32_t* g = gmb + l;
  const int32_t* pr = probs + l;
  int32_t* row = words + static_cast<size_t>(l) * (W + 2);
  uint32_t x = kRansL;
  int count = 0;
  int ea[kBatch], pa[kBatch], eb[kBatch], pb[kBatch];
  load_batch(ea, pa, g, pr, stride, nsteps - 1);
  for (int t0 = nsteps - 1; t0 >= 0; t0 -= 2 * kBatch) {
    load_batch(eb, pb, g, pr, stride, t0 - kBatch);
    emit_batch(ea, pa, x, count, row);
    if (t0 - kBatch < 0) break;
    load_batch(ea, pa, g, pr, stride, t0 - 2 * kBatch);
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

}  // namespace

extern "C" int tplc_grc_reverse_rans(const void* gmb, const void* probs,
                                     void* words, void* counts,
                                     void* states, int W, int L, int nsteps,
                                     void* stream) {
  if (L > 0) {
    grc_rans_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(gmb), static_cast<const int32_t*>(probs),
        static_cast<int32_t*>(words), static_cast<long long*>(counts),
        static_cast<long long*>(states), W, L, nsteps < W ? nsteps : W);
  }
  return static_cast<int>(cudaGetLastError());
}
