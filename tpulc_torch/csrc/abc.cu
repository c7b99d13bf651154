// The adaptive binary coder's (bsc -e2 on the ST sorters) two serial
// walks for Hopper (sm_90a).  tpulc leaves them to XLA fori_loops
// (tpulc/codecs/bsclike/rans_adaptive.py: abc_encode's model pass,
// :228-263, and reverse rANS pass, :265-311; abc_decode's FSM,
// :314-445).  Wrappers and plain PyTorch versions:
// tpulc_torch/codecs/bsclike/abc_kernels.py (abc_encode_walk,
// abc_decode_walk).
//
// Encode: grid uint8[W, L] step-major (event t of lane l at t * L + l,
// (model + 1) * 2 + bit, 0 = no event), nbits int32[L] (lane l's events
// are t < nbits), inits int32[B, 117] (lane l starts from row l /
// lcap), probs int16[W, L] scratch -> words int16[L, W+2] (uint16
// values, zeroed by the caller), counts int64[L], states int64[L]
// (uint32 values).  Model pass, t ascending: p = the model's
// probability, probs[t] = p, then p += ((bit << 12) - p) >> 5 clipped
// to [8, 4088].  rANS pass, t descending from nbits-1 from x = 2^16:
// f = p or 4096 - p, c = 4096 - p or 0 (bit 1 or 0); when x >= f << 20
// (uint32) emit x's low 16 bits and shift x right by 16; then x = (x /
// f) << 12 + x % f + c mod 2^32 (divisor max(f, 1)).  Words land in
// emission order and each row's first `count` are reversed at the end.
//
// Decode: words int16[L, Wc], states int64[L] (uint32 values),
// lane_cls int32[L] (c1 * 4 + c2 entering the lane), nsym int32[L],
// inits as above -> out int32[L, chunk] (zeroed by the caller).  Up to
// `steps` steps, one bit each, while the lane has rebuilt fewer than
// nsym symbols: the model from the FSM (phase E0, E1, EXP or MANT and
// the two context classes, clipped to [0, 116]); bit = (x & 4095) >=
// 4096 - p; x = f * (x >> 12) + slot - c mod 2^32 and, below 2^16, x =
// x << 16 | the next word (read at min(rpos, Wc - 1)); adapt; on a
// finished symbol write it and roll the contexts.
//
// Bound on the H100: each lane is one dependent chain of steps (a
// shared-memory read-modify-write of the model, the rANS arithmetic
// with a 32-bit divide on encode) of ~25 integer operations (encode,
// both passes) or ~60 (decode), and the bytes are the grid read twice,
// the probabilities written and read once and the words written
// (encode), or the words read and the symbols written (decode).
// Design, simple first: one thread a lane, 32 lanes (one warp) a CUDA
// block, so that a cell's few thousand lanes spread over every SM;
// each lane's 117 probabilities in shared memory as int32 [117][32],
// so that a warp's 32 lanes hit 32 banks whatever models they pick;
// the grid and the probabilities step-major, so that a warp's lanes
// touch neighbouring entries at a step; events and probabilities
// prefetched kBatch steps ahead in registers; the decode loads a
// lane's next word before it is known to be needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kModels = 117;
constexpr int kBatch = 16;
constexpr int kProbBits = 12;
constexpr uint32_t kScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;

__device__ __forceinline__ int adapt(int p, int bit) {
  const int q = p + (((bit << kProbBits) - p) >> 5);
  return q < 8 ? 8 : (q > static_cast<int>(kScale) - 8 ? kScale - 8 : q);
}

__device__ __forceinline__ int model_of(int e) {
  const int m = (e >> 1) - 1;
  return m < 0 ? 0 : (m > kModels - 1 ? kModels - 1 : m);
}

__device__ __forceinline__ int ctx_class(int s) {
  return (s >= 1) + (s >= 2) + (s >= 3) + (s >= 4) + (s >= 6) + (s >= 10) +
         (s >= 18);
}

__device__ __forceinline__ void load_inits(int32_t (*p)[kLanes],
                                           const int32_t* init, int lt) {
  for (int m = 0; m < kModels; ++m) p[m][lt] = __ldg(init + m);
}

__global__ void __launch_bounds__(kLanes)
abc_encode_kernel(const uint8_t* __restrict__ grid,
                  const int32_t* __restrict__ nbits,
                  const int32_t* __restrict__ inits,
                  uint16_t* __restrict__ probs, uint16_t* __restrict__ words,
                  long long* __restrict__ counts,
                  long long* __restrict__ states, int W, int L, int lcap) {
  __shared__ int32_t p[kModels][kLanes];
  const int lt = threadIdx.x;
  const int l = blockIdx.x * kLanes + lt;
  if (l >= L) return;
  load_inits(p, inits + static_cast<size_t>(l / lcap) * kModels, lt);
  const size_t stride = static_cast<size_t>(L);
  const uint8_t* g = grid + l;
  uint16_t* pr = probs + l;
  const int n = min(max(nbits[l], 0), W);

  // model pass
  for (int t0 = 0; t0 < n; t0 += kBatch) {
    int e[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      e[i] = t0 + i < n ? __ldg(g + (t0 + i) * stride) : 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (t0 + i >= n) break;
      const int m = model_of(e[i]);
      const int pv = p[m][lt];
      pr[(t0 + i) * stride] = static_cast<uint16_t>(pv);
      if (e[i] > 0) p[m][lt] = adapt(pv, e[i] & 1);
    }
  }

  // reverse rANS pass
  uint16_t* row = words + static_cast<size_t>(l) * (W + 2);
  uint32_t x = kRansL;
  int count = 0;
  for (int t0 = n - 1; t0 >= 0; t0 -= kBatch) {
    int e[kBatch];
    uint32_t pv[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int t = t0 - i;
      e[i] = t >= 0 ? __ldg(g + t * stride) : 0;
      pv[i] = t >= 0 ? pr[t * stride] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (e[i] == 0) continue;
      const bool one = e[i] & 1;
      const uint32_t f = one ? pv[i] : kScale - pv[i];
      const uint32_t c = one ? kScale - pv[i] : 0u;
      if (x >= (f << (32 - kProbBits))) {
        row[count++] = static_cast<uint16_t>(x & 0xFFFFu);
        x >>= 16;
      }
      const uint32_t fx = f > 1 ? f : 1;
      x = ((x / fx) << kProbBits) + x % fx + c;
    }
  }
  for (int i = 0, j = count - 1; i < j; ++i, --j) {
    const uint16_t v = row[i];
    row[i] = row[j];
    row[j] = v;
  }
  counts[l] = count;
  states[l] = x;
}

__global__ void __launch_bounds__(kLanes)
abc_decode_kernel(const uint16_t* __restrict__ words,
                  const long long* __restrict__ states,
                  const int32_t* __restrict__ lane_cls,
                  const int32_t* __restrict__ nsym,
                  const int32_t* __restrict__ inits,
                  int32_t* __restrict__ out, int Wc, int L, int lcap,
                  int chunk, int steps) {
  __shared__ int32_t p[kModels][kLanes];
  const int lt = threadIdx.x;
  const int l = blockIdx.x * kLanes + lt;
  if (l >= L) return;
  load_inits(p, inits + static_cast<size_t>(l / lcap) * kModels, lt);
  const uint16_t* w = words + static_cast<size_t>(l) * Wc;
  int32_t* o = out + static_cast<size_t>(l) * chunk;
  const int n = min(max(nsym[l], 0), chunk);
  uint32_t x = static_cast<uint32_t>(states[l]);
  int c1 = lane_cls[l] >> 2, c2 = lane_cls[l] & 3;
  int phase = 0, lvl = 0, v1 = 0, ee = 0, mpos = 0, sym_i = 0, rpos = 0;
  uint32_t wn = __ldg(w);
  for (int t = 0; t < steps && sym_i < n; ++t) {
    int m = phase == 0   ? c1 * 4 + c2
            : phase == 1 ? 32 + c1
            : phase == 2 ? 40 + min(lvl, 6) * 4 + min(c1, 3)
                         : 68 + (ee - 2) * 7 + mpos;
    m = m < 0 ? 0 : (m > kModels - 1 ? kModels - 1 : m);
    const int pv = p[m][lt];
    const uint32_t p1 = static_cast<uint32_t>(pv);
    const uint32_t f0 = kScale - p1;
    const uint32_t slot = x & (kScale - 1);
    const int bit = slot >= f0;
    const uint32_t f = bit ? p1 : f0;
    const uint32_t c = bit ? f0 : 0u;
    x = f * (x >> kProbBits) + slot - c;
    if (x < kRansL) {
      x = (x << 16) | wn;
      ++rpos;
      wn = __ldg(w + min(rpos, Wc - 1));
    }
    p[m][lt] = adapt(pv, bit);
    // the FSM, as tpulc's (rans_adaptive.py:381-430)
    int lvl_n = phase == 2 && bit ? lvl + 1 : lvl;
    const bool to8 = phase == 2 && bit && lvl_n == 7;  // E = 8 implied
    const bool stop = phase == 2 && !bit;               // E = lvl + 1
    const int e_stop = lvl + 1;
    const bool emit0 = phase == 0 && bit;
    const bool emit1 = phase == 1 && bit;
    const bool emit2 = stop && e_stop == 1;
    int v1_n = phase == 3 ? (v1 << 1) | bit : v1;
    int mpos_n = phase == 3 ? mpos + 1 : mpos;
    const bool emit3 = phase == 3 && mpos_n == ee - 1;
    const bool emitted = emit0 || emit1 || emit2 || emit3;
    const int s = emit0 ? 0 : emit1 ? 1 : emit2 ? 2 : v1_n + 1;
    const bool enter_mant = to8 || (stop && e_stop > 1);
    const int phase_n = emitted        ? 0
                        : phase == 0   ? 1
                        : phase == 1   ? 2
                        : enter_mant   ? 3
                                       : phase;
    ee = to8 ? 8 : stop ? e_stop : ee;
    if (enter_mant) {
      v1_n = 1;
      mpos_n = 0;
    }
    if (emitted || (phase == 1 && !bit)) lvl_n = 0;
    if (emitted) {
      o[sym_i++] = s;
      c2 = min(c1, 3);
      c1 = ctx_class(s);
    }
    phase = phase_n;
    lvl = lvl_n;
    v1 = v1_n;
    mpos = mpos_n;
  }
}

}  // namespace

extern "C" int tplc_abc_encode(const void* grid, const void* nbits,
                               const void* inits, void* probs, void* words,
                               void* counts, void* states, int W, int L,
                               int lcap, void* stream) {
  if (L > 0) {
    abc_encode_kernel<<<(L + kLanes - 1) / kLanes, kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(grid), static_cast<const int32_t*>(nbits),
        static_cast<const int32_t*>(inits), static_cast<uint16_t*>(probs),
        static_cast<uint16_t*>(words), static_cast<long long*>(counts),
        static_cast<long long*>(states), W, L, lcap);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tplc_abc_decode(const void* words, const void* states,
                               const void* lane_cls, const void* nsym,
                               const void* inits, void* out, int Wc, int L,
                               int lcap, int chunk, int steps, void* stream) {
  if (L > 0) {
    abc_decode_kernel<<<(L + kLanes - 1) / kLanes, kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(words),
        static_cast<const long long*>(states),
        static_cast<const int32_t*>(lane_cls),
        static_cast<const int32_t*>(nsym), static_cast<const int32_t*>(inits),
        static_cast<int32_t*>(out), Wc, L, lcap, chunk, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
