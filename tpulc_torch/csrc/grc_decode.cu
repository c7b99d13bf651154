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
// Bound on the H100: the latency of each lane's serial chain of events
// (shared-memory counter read -> mix -> rANS step -> FSM transition ->
// the next model), not bytes: a lane reads 2 bytes of stream per 16
// decoded bits and writes 4 per symbol.  Design:
// - the next step's model index is carried in a register and updated by
//   the transition with selects: contexts (cR4, cRun, hE, cR4c, cR0) and
//   the per-phase model bases are recomputed only when a group
//   completes, rq only when the rank is known;
// - each lane's stream is read 16 bytes at a time into a register
//   buffer, one 16-byte chunk ahead of need, so a refill (about one
//   event in 18) never waits on device memory.  The first chunk may
//   start before the row when l*Wc is not a multiple of 8; a chunk is
//   read only if it holds a word of the row, so no read leaves the
//   tensor; a read past column Wc-1 returns word Wc-1;
// - the refill and the group completion are selects and a predicated
//   store; only the stream's chunk advance branches (the steps are
//   serial, so unlike K5 this buys no overlap: the next model needs this
//   step's bit);
// - the model state is in shared memory as in K5 (grc_model.cuh), 94
//   lanes a block by default.
// The rANS state is uint32 arithmetic; the TPU kernel's int32 wrap and
// `x_new >= 0` test (grc_pallas.py:297-298) are Mosaic workarounds.  A
// lane stops at t >= nsteps or once its symbols are out, which equals
// the TPU tile's early-exit while_loop (an inactive lane never changes
// state).  The family of a model is its FSM phase (every model an FSM
// state can pick lies in its phase's range), so the coarse counter is
// picked by the phase.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grc_model.cuh"

namespace {

using namespace grc;

// A lane's word stream: 16-byte chunks in registers, one ahead.
struct Stream {
  const uint4* base;   // first 16-byte chunk holding a word of the row
  int nchunks;         // chunks holding a word of the row
  int j;               // index of `cur`
  int s;               // next word's slot in `cur`, 0..7
  int rpos;            // next word's column
  int wc;
  uint32_t last;       // word Wc-1, what a read past the row returns
  uint4 cur, nxt;

  __device__ __forceinline__ void open(const uint16_t* row, int Wc) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row);
    const uintptr_t end = a + 2 * static_cast<uintptr_t>(Wc);
    base = reinterpret_cast<const uint4*>(a & ~static_cast<uintptr_t>(15));
    nchunks = static_cast<int>(((end + 15) >> 4) - (a >> 4));
    s = static_cast<int>((a & 15) >> 1);
    j = 0;
    rpos = 0;
    wc = Wc;
    last = row[Wc - 1];
    cur = __ldg(base);
    nxt = nchunks > 1 ? __ldg(base + 1) : cur;
  }

  // The word a refill would read now, without taking it.
  __device__ __forceinline__ uint32_t peek() const {
    const uint32_t v = s < 4 ? (s < 2 ? cur.x : cur.y)
                             : (s < 6 ? cur.z : cur.w);
    const uint32_t w = (s & 1) ? v >> 16 : v & 0xFFFFu;
    return rpos >= wc - 1 ? last : w;
  }

  // Take the word when `take`; only the 16-byte chunk advance (one
  // refill in 8) branches.
  __device__ __forceinline__ void advance(bool take) {
    s += take && rpos < wc - 1;
    rpos += take;
    if (s == 8) {
      s = 0;
      cur = nxt;
      if (++j + 1 < nchunks) nxt = __ldg(base + j + 1);
    }
  }
};

__global__ void __launch_bounds__(kMaxThreads)
grc_decode_kernel(const uint16_t* __restrict__ words,
                  const uint32_t* __restrict__ states,
                  const int32_t* __restrict__ init,
                  const int32_t* __restrict__ cinit,
                  int32_t* __restrict__ out, int L, int Wc, int m,
                  int nsteps, int chunk, int nl) {
  extern __shared__ uint16_t smem[];
  uint16_t* fine = load_models(smem, init, nl);
  const uint16_t* sinit = smem + kNM * nl;
  const int l = blockIdx.x * nl + threadIdx.x;
  if (fine == nullptr || l >= L) return;
  const int nsym = clampi(m - l * chunk, 0, chunk);
  if (nsym == 0 || nsteps <= 0) return;
  Coarse coarse;
  coarse.load(cinit);
  Stream in;
  in.open(words + static_cast<size_t>(l) * Wc, Wc);
  int32_t* orow = out + static_cast<size_t>(l) * chunk;

  uint32_t x = states[l];
  // FSM phases: 0 L0, 1 RT, 2 RE, 3 RM, 4 UT, 5 UE, 6 UM (grc.py:554-623)
  int phase = 0, mdl = 0, opos = 0;
  int lvl = 0, acc = 0, left = 0, mbase = 0, r = 0, rq = 0;
  int prev_r = 0, prev2_r = 0, prev_k = 1, prev2_k = 1;
  // group contexts (grc._ctx_regs) folded into model bases: the RT
  // model, the RE base, the UT model without its rq term
  int mRT = kBRT + 3 * 4, mRE = kBRE, cUT = kBUT + 3 * 8;
  for (int t = 0; t < nsteps && opos < nsym; ++t) {
    const int pf = fine[mdl * nl];
    const int pc = coarse.get(phase);
    const int pe = mix(pf, pc, sinit[mdl]);

    // rANS step; the refill is a select on the word the stream holds
    const uint32_t f0 = kScale - pe;
    const uint32_t slot = x & (kScale - 1);
    const bool b = slot >= f0;
    x = (b ? static_cast<uint32_t>(pe) : f0) * (x >> kProbBits) + slot -
        (b ? f0 : 0u);
    const bool need = x < kRansL;
    x = need ? (x << 16) | in.peek() : x;
    in.advance(need);
    fine[mdl * nl] = static_cast<uint16_t>(adapt(pf, b, kRateF));
    coarse.set(phase, adapt(pc, b, kRateC));

    // transition
    const bool run = phase >= 4;
    const bool isE = phase == 2 || phase == 5;  // exponent, unary
    const bool isM = phase == 3 || phase == 6;  // mantissa, tree path
    const int cap = run ? kMaxEk : 7;
    const bool e_cont = isE && b && lvl + 1 < cap;
    const bool enter_m = isE && !e_cont;
    const int ek = b ? cap : lvl;  // the exponent, when enter_m
    const int acc2 = acc * 2 + b;
    const bool m_done = isM && left == 1;
    const bool to_e = (phase == 1 || phase == 4) && !b;
    const bool rank_done = (phase <= 1 && b) || (m_done && !run);
    const bool complete = (phase == 4 && b) || (m_done && run);
    const int r_n = phase == 0 ? 0 : (phase == 1 ? 1 : acc2);
    const int rq_n = r_n == 0 ? 1 : min(r_n - 1, 2);
    const int mb_n = run ? kBUM + (ek - 1) * 32 : kBRM + (ek - 1) * 64;
    const int m_cont = mbase + min(acc2, run ? 31 : 63);

    int nmdl = isM ? m_cont : mdl + 4;                 // mantissa / RE, UE
    nmdl = enter_m ? mb_n + 1 : nmdl;
    nmdl = to_e ? (run ? kBUE + rq : mRE) : nmdl;
    nmdl = rank_done ? cUT + rq_n * 32 : nmdl;
    nmdl = phase == 0 && !b ? mRT : nmdl;
    int nphase = (to_e || enter_m) ? phase + 1 : phase;
    nphase = rank_done ? 4 : nphase;
    nphase = (phase == 0 && !b) || complete ? 1 : nphase;
    lvl = to_e ? 1 : (e_cont ? lvl + 1 : lvl);
    acc = enter_m ? 1 : (isM ? acc2 : acc);
    left = enter_m ? ek : (isM ? left - 1 : left);
    mbase = enter_m ? mb_n : mbase;
    r = rank_done ? r_n : r;
    rq = rank_done ? rq_n : rq;

    // a completed group: its rank out at its first position, the group
    // registers shifted, the contexts' model bases recomputed
    const int k = clampi(phase == 6 ? acc2 : 1, 0, max(nsym - opos, 1));
    if (complete && r > 0) orow[opos] = r;
    if (complete) {
      prev2_r = prev_r;
      prev2_k = prev_k;
      prev_r = r;
      prev_k = k;
      const int prev_e = r > 0 ? 31 - __clz(r) : 0;
      const int q1 = min(prev_r, 3);
      const int cRun = (prev_k < 3) * 2 + (prev2_k < 3);
      mRT = kBRT + (q1 * 4 + min(prev2_r, 3)) * 16 + cRun * 4 +
            min(prev_e, 3);
      mRE = kBRE + min(q1 * 2 + (prev2_r > 0), 3);
      cUT = kBUT + cRun * 8 + (prev_r == 1) * 4 + (prev2_r == 1) * 2 +
            (prev_r > 4);
    }
    opos += complete ? k : 0;
    r = complete ? 0 : r;
    phase = nphase;
    mdl = complete ? mRT : nmdl;
  }
}

}  // namespace

extern "C" int tplc_grc_decode(const void* words, const void* states,
                               const void* init, const void* cinit,
                               void* out, int L, int Wc, int m, int nsteps,
                               int chunk, int nl, void* stream) {
  cudaError_t err = allow_smem(grc_decode_kernel, nl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L > 0) {
    const int threads = (nl + 31) / 32 * 32;
    grc_decode_kernel<<<(L + nl - 1) / nl, threads, smem_bytes(nl),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(words),
        static_cast<const uint32_t*>(states),
        static_cast<const int32_t*>(init), static_cast<const int32_t*>(cinit),
        static_cast<int32_t*>(out), L, Wc, m, nsteps, chunk, nl);
  }
  return static_cast<int>(cudaGetLastError());
}
