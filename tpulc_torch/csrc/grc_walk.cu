// K5 — the group-rank coder's encode-side forward model walk, for
// Hopper (sm_90a).  Replaces tpulc/codecs/bsclike/grc_pallas.py:
// grc_walk_probs_pallas (_walk_kernel).  Wrapper and plain PyTorch
// version: tpulc_torch/codecs/bsclike/grc_kernels.py (grc_walk_probs).
//
// gmb int32[W, L] time-major event grid (record (model+1)*2 + bit, 0 =
// empty), init int32[NM], cinit int32[NFAM] -> probs int32[W, L]: row
// t < nsteps holds the mixed probability before event t (an empty slot
// holds model 0's mix and updates nothing); rows at or past nsteps 0.
//
// Bound on the H100: each lane is a serial chain of dependent
// shared-memory read-modify-writes (the counter an event updates may be
// the next event's); its byte bound is the grid read once and probs
// written once.  At one warp an SM, what a step costs is how much of
// its dependent work the scheduler can overlap.  Design:
// - the grid is prefetched kBatch steps ahead into registers (two
//   register batches in turn: one is walked while the other loads), so
//   a step never waits on device memory, and `probs` stores are never
//   waited on;
// - a step has no branch (an empty slot reads model 0 and writes back
//   what it read), so a batch is one basic block and the scheduler
//   overlaps each step's independent work (model, family, addresses)
//   with the previous step's counter updates; with a branch a step, a
//   step took twice as long on an H100 (chip_smoke.py phase 7);
// - a batch in which no lane of the warp has an event (the soup's
//   lanes end long before the grid does) stores model 0's mix only;
// - the lane's 1,221 counters are a uint16 column of shared memory
//   (grc_model.cuh), 94 lanes a block by default, so the SM's 227 KB
//   are used and 25,600 lanes take 3 waves, not 4;
// - the coarse counter is a select tree in registers.
// A warp's reads of `gmb` and writes of `probs` per step are one
// coalesced row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grc_model.cuh"

namespace {

using namespace grc;

constexpr int kBatch = 32;

// One lane's walk state.
struct Lane {
  uint16_t* fine;
  const uint16_t* sinit;
  Coarse coarse;
  int nl;
  int si0;

  // Walk one slot; -> the mix before it.  Branch-free: an empty slot
  // (e <= 0) reads model 0 and writes back what it read.
  __device__ __forceinline__ int step(int e) {
    const int m = max(min((e >> 1) - 1, kNM - 1), 0);
    const int f = family(m);
    const bool upd = e > 0;
    const int bit = e & 1;
    const int pf = fine[m * nl];
    const int pc = coarse.get(f);
    const int pe = mix(pf, pc, sinit[m]);
    fine[m * nl] = static_cast<uint16_t>(upd ? adapt(pf, bit, kRateF) : pf);
    coarse.set(f, upd ? adapt(pc, bit, kRateC) : pc);
    return pe;
  }
};

// Load rows [t0, t0 + kBatch) of this lane's grid column; 0 past nsteps.
__device__ __forceinline__ void load_batch(int (&buf)[kBatch],
                                           const int32_t* g, size_t stride,
                                           int t0, int nsteps) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    buf[j] = t0 + j < nsteps ? __ldg(g + (t0 + j) * stride) : 0;
}

// Walk rows [t0, t0 + kBatch): branch-free steps, or model 0's mix
// only when no lane of the warp has an event here (warp-uniform).
__device__ __forceinline__ void walk_batch(const int (&buf)[kBatch], Lane& s,
                                           int32_t* p, size_t stride,
                                           int t0, int nsteps) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) any |= buf[j] > 0;
  const bool full = t0 + kBatch <= nsteps;
  if (__any_sync(__activemask(), any)) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int pe = s.step(buf[j]);
      if (full || t0 + j < nsteps) p[(t0 + j) * stride] = pe;
    }
  } else {
    const int pe = mix(s.fine[0], s.coarse.c0, s.si0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (full || t0 + j < nsteps) p[(t0 + j) * stride] = pe;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
grc_walk_kernel(const int32_t* __restrict__ gmb,
                const int32_t* __restrict__ init,
                const int32_t* __restrict__ cinit,
                int32_t* __restrict__ probs, int W, int L, int nsteps,
                int nl) {
  extern __shared__ uint16_t smem[];
  Lane s;
  s.fine = load_models(smem, init, nl);
  s.sinit = smem + kNM * nl;
  s.nl = nl;
  const int l = blockIdx.x * nl + threadIdx.x;
  if (s.fine == nullptr || l >= L) return;
  s.coarse.load(cinit);
  s.si0 = s.sinit[0];
  const size_t stride = static_cast<size_t>(L);
  const int32_t* g = gmb + l;
  int32_t* p = probs + l;
  int a[kBatch], b[kBatch];
  load_batch(a, g, stride, 0, nsteps);
  for (int t0 = 0; t0 < nsteps; t0 += 2 * kBatch) {
    load_batch(b, g, stride, t0 + kBatch, nsteps);
    walk_batch(a, s, p, stride, t0, nsteps);
    if (t0 + kBatch >= nsteps) break;
    load_batch(a, g, stride, t0 + 2 * kBatch, nsteps);
    walk_batch(b, s, p, stride, t0 + kBatch, nsteps);
  }
  for (int t = nsteps; t < W; ++t) p[t * stride] = 0;
}

}  // namespace

extern "C" int tplc_grc_walk_probs(const void* gmb, const void* init,
                                   const void* cinit, void* probs, int W,
                                   int L, int nsteps, int nl,
                                   void* stream) {
  cudaError_t err = allow_smem(grc_walk_kernel, nl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L > 0) {
    const int threads = (nl + 31) / 32 * 32;
    grc_walk_kernel<<<(L + nl - 1) / nl, threads, smem_bytes(nl),
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(gmb), static_cast<const int32_t*>(init),
        static_cast<const int32_t*>(cinit), static_cast<int32_t*>(probs), W,
        L, nsteps < W ? nsteps : W, nl);
  }
  return static_cast<int>(cudaGetLastError());
}
