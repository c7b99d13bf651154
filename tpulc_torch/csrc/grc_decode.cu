// K6 — the group-rank coder's decode FSM, for Hopper (sm_90a).
// Replaces tpulc/codecs/bsclike/grc_pallas.py:grc_decode_pallas
// (_decode_kernel).  Wrapper and plain PyTorch version:
// tpulc_torch/codecs/bsclike/grc_kernels.py (grc_decode_walk).
//
// words uint16[L, Wc] (each lane's stream), states uint32[L], init
// int32[NM], cinit int32[NFAM] -> out int32[L, chunk], zeroed by the
// caller: lane l decodes nsym = clip(m - l*chunk, 0, chunk) MTF ranks,
// one binary event a step, rebuilding (rank, run) groups; a group's
// rank is written at its first position when it is not 0.
//
// Bound on the H100: the latency of each lane's serial chain of
// events (model pick -> shared-memory counter read -> rANS step ->
// counter write -> FSM transition), not bytes: a lane reads 2 bytes of
// stream per 16 decoded bits and writes 4 per symbol.  Design: one
// thread per lane, the FSM registers of grc.py:491-496 in registers,
// the model state in shared memory as in K5 (grc_model.cuh).  The rANS
// state is uint32 arithmetic; the TPU kernel's int32 wrap and
// `x_new >= 0` test (grc_pallas.py:297-298) are Mosaic workarounds.  A
// lane stops at t >= nsteps or once its symbols are out, which equals
// the TPU tile's early-exit while_loop (an inactive lane never changes
// state).  The family of a model is its FSM phase, so the coarse
// counter is picked by the phase.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grc_model.cuh"

namespace {

using namespace grc;

__global__ void __launch_bounds__(kLanes)
grc_decode_kernel(const uint16_t* __restrict__ words,
                  const uint32_t* __restrict__ states,
                  const int32_t* __restrict__ init,
                  const int32_t* __restrict__ cinit,
                  int32_t* __restrict__ out, int L, int Wc, int m,
                  int nsteps, int chunk) {
  extern __shared__ uint16_t smem[];
  uint16_t* fine = load_models(smem, init);
  const uint16_t* sinit = smem + kNM * kLanes;
  const int l = blockIdx.x * kLanes + threadIdx.x;
  if (l >= L) return;
  Coarse coarse;
  coarse.load(cinit);
  const uint16_t* wrow = words + static_cast<size_t>(l) * Wc;
  int32_t* orow = out + static_cast<size_t>(l) * chunk;
  const int nsym = clampi(m - l * chunk, 0, chunk);

  uint32_t x = states[l];
  int rpos = 0, opos = 0, phase = 0, lvl = 0, val = 0, mleft = 0, ek = 0;
  int kval = 0, kleft = 0, r = 0, prev_r = 0, prev2_r = 0, prev_k = 1;
  int prev2_k = 1, prev_e = 0;
  for (int t = 0; t < nsteps && opos < nsym; ++t) {
    // contexts (grc._ctx_regs, grc._rq_of)
    const int q1 = min(prev_r, 3);
    const int cR4 = q1 * 4 + min(prev2_r, 3);
    const int cRun = (prev_k < 3) * 2 + (prev2_k < 3);
    const int hE = min(prev_e, 3);
    const int cR4c = min(q1 * 2 + (prev2_r > 0), 3);
    const int cR0 = (prev_r == 1) * 4 + (prev2_r == 1) * 2 + (prev_r > 4);
    const int rq = min(max(r - 1, 0), 2) + (r == 0);
    int mdl;
    switch (phase) {
      case 0: mdl = 0; break;
      case 1: mdl = kBRT + cR4 * 16 + cRun * 4 + hE; break;
      case 2: mdl = kBRE + (clampi(lvl, 1, 6) - 1) * 4 + cR4c; break;
      case 3: mdl = kBRM + (clampi(ek, 1, 7) - 1) * 64 + min(val, 63); break;
      case 4: mdl = kBUT + rq * 32 + cRun * 8 + cR0; break;
      case 5: mdl = kBUE + (clampi(lvl, 1, kMaxEk - 1) - 1) * 4 + rq; break;
      default:
        mdl = kBUM + (clampi(ek, 1, kMaxEk) - 1) * 32 + min(kval, 31);
    }
    mdl = clampi(mdl, 0, kNM - 1);
    const int f = family(mdl);
    const int pf = fine[mdl * kLanes];
    const int pc = coarse.get(f);
    const int pe = mix(pf, pc, sinit[mdl]);

    // rANS step
    const uint32_t f0 = kScale - pe;
    const uint32_t slot = x & (kScale - 1);
    const int bit = slot >= f0;
    const uint32_t fq = bit ? static_cast<uint32_t>(pe) : f0;
    const uint32_t cq = bit ? f0 : 0u;
    x = fq * (x >> kProbBits) + slot - cq;
    if (x < kRansL) x = (x << 16) | wrow[min(rpos++, Wc - 1)];
    fine[mdl * kLanes] = static_cast<uint16_t>(adapt(pf, bit, kRateF));
    coarse.set(f, adapt(pc, bit, kRateC));

    // FSM: 0 L0, 1 RT, 2 RE, 3 RM, 4 UT, 5 UE, 6 UM (grc.py:554-623)
    const bool b1 = bit;
    const bool is0 = phase == 0, is1 = phase == 1, is2 = phase == 2;
    const bool is3 = phase == 3, is4 = phase == 4, is5 = phase == 5;
    const bool is6 = phase == 6;
    int r_n = (is0 && b1) ? 0 : ((is1 && b1) ? 1 : r);
    bool to_ut = (is0 || is1) && b1;
    const bool to_rt = is0 && !b1;
    const bool to_re = is1 && !b1;
    int lvl_n = to_re ? 1 : lvl;
    const bool re_cont = is2 && b1;
    if (re_cont) lvl_n = lvl + 1;
    const bool re_to_rm_hi = re_cont && lvl_n == 7;
    const bool enter_rm = re_to_rm_hi || (is2 && !b1);
    const int ek_rank = re_to_rm_hi ? 7 : lvl;
    int ek_n = enter_rm ? ek_rank : ek;
    int val_n = is3 ? val * 2 + bit : (enter_rm ? 1 : val);
    int mleft_n = is3 ? mleft - 1 : (enter_rm ? ek_rank : mleft);
    const bool rm_done = is3 && mleft_n == 0;
    if (rm_done) r_n = val_n;
    to_ut = to_ut || rm_done;
    const bool ut_one = is4 && b1;
    const bool to_ue = is4 && !b1;
    if (to_ue) lvl_n = 1;
    const bool ue_cont = is5 && b1;
    if (ue_cont) lvl_n = lvl + 1;
    const bool ue_to_um_hi = ue_cont && lvl_n == kMaxEk;
    const bool enter_um = ue_to_um_hi || (is5 && !b1);
    const int ek_run = ue_to_um_hi ? kMaxEk : lvl;
    if (enter_um) ek_n = ek_run;
    const int kval_n = is6 ? kval * 2 + bit : (enter_um ? 1 : kval);
    const int kleft_n = is6 ? kleft - 1 : (enter_um ? ek_run : kleft);
    const bool um_done = is6 && kleft_n == 0;
    const bool complete = ut_one || um_done;
    const int k_done = clampi(ut_one ? 1 : (um_done ? kval_n : 0), 0,
                              max(nsym - opos, 1));
    if (complete && r_n > 0) orow[opos] = r_n;
    if (complete) {
      prev2_r = prev_r;
      prev2_k = prev_k;
      prev_r = r_n;
      prev_k = k_done;
      prev_e = r_n > 0 ? 31 - __clz(r_n) : 0;
      opos += k_done;
      phase = 1;
    } else if (to_rt) {
      phase = 1;
    } else if (to_re) {
      phase = 2;
    } else if (enter_rm) {
      phase = 3;
    } else if (to_ut) {
      phase = 4;
    } else if (to_ue) {
      phase = 5;
    } else if (enter_um) {
      phase = 6;
    }
    lvl = lvl_n;
    val = val_n;
    mleft = mleft_n;
    ek = ek_n;
    kval = kval_n;
    kleft = kleft_n;
    r = complete ? 0 : r_n;
  }
}

}  // namespace

extern "C" int tplc_grc_decode(const void* words, const void* states,
                               const void* init, const void* cinit,
                               void* out, int L, int Wc, int m, int nsteps,
                               int chunk, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grc_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L > 0) {
    grc_decode_kernel<<<(L + kLanes - 1) / kLanes, kLanes, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(words),
        static_cast<const uint32_t*>(states),
        static_cast<const int32_t*>(init), static_cast<const int32_t*>(cinit),
        static_cast<int32_t*>(out), L, Wc, m, nsteps, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
