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
// Bound on the H100: each lane is a serial chain of nsteps dependent
// shared-memory read-modify-writes (the counter an event updates may be
// the next event's), so the kernel is bound by that chain's latency,
// not by its 8 bytes of grid traffic per event.  Design: one thread per
// lane, 32 lanes per block; each lane's 1,221 counters in a column of
// shared memory (grc_model.cuh), indexed directly where the TPU kernel
// swept masked reductions over a [1224, 128] tile with counters and
// inits packed in one int32 (grc_pallas.py:104-152); a warp's 32
// reads and writes of `gmb` and `probs` per step are one coalesced row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grc_model.cuh"

namespace {

using namespace grc;

__global__ void __launch_bounds__(kLanes)
grc_walk_kernel(const int32_t* __restrict__ gmb,
                const int32_t* __restrict__ init,
                const int32_t* __restrict__ cinit,
                int32_t* __restrict__ probs, int W, int L, int nsteps) {
  extern __shared__ uint16_t smem[];
  uint16_t* fine = load_models(smem, init);
  const uint16_t* sinit = smem + kNM * kLanes;
  const int l = blockIdx.x * kLanes + threadIdx.x;
  if (l >= L) return;
  Coarse coarse;
  coarse.load(cinit);
  const size_t stride = static_cast<size_t>(L);
  for (int t = 0; t < nsteps; ++t) {
    const int e = gmb[t * stride + l];
    const int mdl = clampi((e >> 1) - 1, 0, kNM - 1);
    const int bit = e & 1;
    const int f = family(mdl);
    const int pf = fine[mdl * kLanes];
    const int pc = coarse.get(f);
    probs[t * stride + l] = mix(pf, pc, sinit[mdl]);
    if (e > 0) {
      fine[mdl * kLanes] = static_cast<uint16_t>(adapt(pf, bit, kRateF));
      coarse.set(f, adapt(pc, bit, kRateC));
    }
  }
  for (int t = nsteps; t < W; ++t) probs[t * stride + l] = 0;
}

}  // namespace

extern "C" int tplc_grc_walk_probs(const void* gmb, const void* init,
                                   const void* cinit, void* probs, int W,
                                   int L, int nsteps, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grc_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L > 0) {
    grc_walk_kernel<<<(L + kLanes - 1) / kLanes, kLanes, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(gmb), static_cast<const int32_t*>(init),
        static_cast<const int32_t*>(cinit), static_cast<int32_t*>(probs), W,
        L, nsteps < W ? nsteps : W);
  }
  return static_cast<int>(cudaGetLastError());
}
