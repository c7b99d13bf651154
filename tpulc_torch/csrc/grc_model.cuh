// The group-rank coder's model arithmetic, shared by K5 (grc_walk.cu)
// and K6 (grc_decode.cu).  The constants and integer formulas are
// tpulc/codecs/bsclike/grc.py's (`_mix`, `_adapt`, `_ctx_regs`,
// `_rq_of`, the model bases); the plain PyTorch versions live in
// tpulc_torch/codecs/bsclike/grc_kernels.py.
//
// Model state layout, per block of kLanes lanes (one thread per lane),
// in dynamic shared memory:
//   fine[kNM][kLanes]  uint16  each lane's adaptive fine counters; a
//                              warp's 32 data-dependent reads of one
//                              step cost at most a two-way bank
//                              conflict (uint32 would remove it at
//                              twice the memory, one block per SM);
//   init[kNM]          uint16  the block-static wired inits, once.
// Counters and inits lie in [8, 4088], so uint16 holds them; the block
// needs 80,586 bytes, two blocks fit one SM.  The 7 coarse counters sit
// in registers, reached by a select chain (no local-memory array).

#pragma once

#include <stdint.h>

namespace grc {

constexpr int kLanes = 32;
constexpr int kProbBits = 12;
constexpr int kScale = 1 << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kRateF = 4;
constexpr int kRateC = 5;
constexpr int kMaxEk = 10;
constexpr int kBRT = 1;
constexpr int kBRE = kBRT + 256;
constexpr int kBRM = kBRE + 28;
constexpr int kBUT = kBRM + 7 * 64;
constexpr int kBUE = kBUT + 128;
constexpr int kBUM = kBUE + 40;
constexpr int kNM = kBUM + kMaxEk * 32;  // 1221
constexpr int kNFam = 7;
constexpr size_t kSmemBytes = (size_t)(kNM * kLanes + kNM) * sizeof(uint16_t);

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int family(int mdl) {
  return (mdl >= kBRT) + (mdl >= kBRE) + (mdl >= kBRM) + (mdl >= kBUT) +
         (mdl >= kBUE) + (mdl >= kBUM);
}

__device__ __forceinline__ int mix(int pf, int pc, int pi) {
  return clampi((19 * pf + 7 * pc + 6 * pi) >> 5, 8, kScale - 8);
}

__device__ __forceinline__ int adapt(int p, int bit, int rate) {
  return clampi(p + (((bit << kProbBits) - p) >> rate), 8, kScale - 8);
}

// The 7 coarse counters in registers.
struct Coarse {
  int c0, c1, c2, c3, c4, c5, c6;

  __device__ __forceinline__ void load(const int32_t* cinit) {
    c0 = cinit[0]; c1 = cinit[1]; c2 = cinit[2]; c3 = cinit[3];
    c4 = cinit[4]; c5 = cinit[5]; c6 = cinit[6];
  }
  __device__ __forceinline__ int get(int f) const {
    int v = c0;
    v = f == 1 ? c1 : v;
    v = f == 2 ? c2 : v;
    v = f == 3 ? c3 : v;
    v = f == 4 ? c4 : v;
    v = f == 5 ? c5 : v;
    v = f == 6 ? c6 : v;
    return v;
  }
  __device__ __forceinline__ void set(int f, int v) {
    c0 = f == 0 ? v : c0;
    c1 = f == 1 ? v : c1;
    c2 = f == 2 ? v : c2;
    c3 = f == 3 ? v : c3;
    c4 = f == 4 ? v : c4;
    c5 = f == 5 ? v : c5;
    c6 = f == 6 ? v : c6;
  }
};

// Fill the block's init table and every lane's fine counters from it.
// Returns the fine-counter column of this thread's lane.
__device__ __forceinline__ uint16_t* load_models(uint16_t* smem,
                                                 const int32_t* init) {
  uint16_t* sinit = smem + kNM * kLanes;
  for (int i = threadIdx.x; i < kNM; i += blockDim.x)
    sinit[i] = static_cast<uint16_t>(init[i]);
  __syncthreads();
  uint16_t* fine = smem + threadIdx.x;
  for (int i = 0; i < kNM; ++i) fine[i * kLanes] = sinit[i];
  return fine;
}

}  // namespace grc
