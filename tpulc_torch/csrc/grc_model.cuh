// The group-rank coder's model arithmetic, shared by K5 (grc_walk.cu)
// and K6 (grc_decode.cu).  The constants and integer formulas are
// tpulc/codecs/bsclike/grc.py's (`_mix`, `_adapt`, `_ctx_regs`,
// `_rq_of`, the model bases); the plain PyTorch versions live in
// tpulc_torch/codecs/bsclike/grc_kernels.py.
//
// Model state layout, per block of `nl` lanes (one thread per lane), in
// dynamic shared memory:
//   fine[kNM][nl]  uint16  each lane's adaptive fine counters; a warp's
//                          32 reads of one model row are consecutive
//                          halfwords (no bank conflict), reads of
//                          different rows conflict as the data decides;
//   init[kNM]      uint16  the block-static wired inits, once.
// Counters and inits lie in [8, 4088], so uint16 holds them.  A lane
// costs 2,442 bytes, so the SM's 227 KB opt-in shared memory holds one
// block of up to 94 lanes (smem_bytes(94) = 231,990 B), the wrappers'
// default (grc_kernels.MAX_LANES): at the soup's 25,600 lanes that is 3
// waves where 32-lane blocks (two an SM) take 4.  The 7 coarse counters
// sit in registers, reached by a three-level select tree.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grc {

constexpr int kMaxLanes = 94;      // lanes a block can hold (227 KB)
constexpr int kMaxThreads = 96;    // kMaxLanes rounded up to warps
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

inline size_t smem_bytes(int nl) {
  return static_cast<size_t>(kNM) * (nl + 1) * sizeof(uint16_t);
}

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

// The 7 coarse counters in registers.  get() is a select tree on the
// bits of f (three selects deep, not a chain of six); set() writes one.
struct Coarse {
  int c0, c1, c2, c3, c4, c5, c6;

  __device__ __forceinline__ void load(const int32_t* cinit) {
    c0 = cinit[0]; c1 = cinit[1]; c2 = cinit[2]; c3 = cinit[3];
    c4 = cinit[4]; c5 = cinit[5]; c6 = cinit[6];
  }
  __device__ __forceinline__ int get(int f) const {
    const bool b0 = f & 1, b1 = f & 2;
    const int lo = b1 ? (b0 ? c3 : c2) : (b0 ? c1 : c0);
    const int hi = b1 ? c6 : (b0 ? c5 : c4);
    return (f & 4) ? hi : lo;
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
// Returns the fine-counter column of this thread's lane (stride nl);
// threads past nl get a null column and must not use it.
__device__ __forceinline__ uint16_t* load_models(uint16_t* smem,
                                                 const int32_t* init,
                                                 int nl) {
  uint16_t* sinit = smem + kNM * nl;
  for (int i = threadIdx.x; i < kNM; i += blockDim.x)
    sinit[i] = static_cast<uint16_t>(init[i]);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= nl) return nullptr;
  uint16_t* fine = smem + threadIdx.x;
  for (int i = 0; i < kNM; ++i) fine[i * nl] = sinit[i];
  return fine;
}

// Opt the kernel into `nl` lanes' shared memory; 0 or a CUDA error.
template <typename K>
inline cudaError_t allow_smem(K kernel, int nl) {
  if (nl < 1 || nl > kMaxLanes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(nl)));
}

}  // namespace grc
