// bsc coder 1's two serial walks, the order-2 context rANS encode and
// decode, for Hopper (sm_90a).  tpulc leaves both to XLA
// (tpulc/codecs/bsclike/rans.py: rans_encode_ctx_batch and
// rans_decode_ctx_batch, fori_loops over the 512 steps of a lane).
// Wrappers and plain PyTorch versions: tpulc_torch/codecs/bsclike/
// rans.py (rans_encode_walk, rans_decode_walk).
//
// Encode: idx int32[C, L] step-major (table entry ctx * S + sym of step
// j of lane l), nsym int32[L], fc int32 packed table (cum | freq << 14)
// -> words int16[L, C+2] (uint16 values, zeroed by the caller), counts
// int64[L], states int64[L] (uint32 values).  Lane l starts at x = 2^16
// and walks j = nsym-1 down to 0: when f < 2^14 and x >= f << 18 it
// emits x's low 16 bits and shifts x right by 16; then x = (x / f) <<
// 14 + x % f + c, mod 2^32 (divisor max(f, 1)).  Words land in the
// lane's row in emission order, and the row's first `count` entries are
// reversed at the end, so the decoder reads them last emitted first.
//
// Decode: words int16[L, C+2], states int64[L] (uint32 values), fctx
// int64[L] (the context entering the lane, offset by its block's
// NCTX-context base, block = l / nlanes), nsym int32[L], lut int16[R *
// 2^14] (slot -> symbol, values < S), fc as above -> out int32[L, C].
// Step j < nsym: slot = x & (2^14 - 1), s = lut[k * 2^14 + slot], (f,
// c) = fc[k * S + s], x = f * (x >> 14) + slot - c mod 2^32, and when x
// < 2^16 it takes the next word (read at min(rpos, C+1)); out = s and
// the context becomes base + class(s) * 4 + min((k - base) >> 2, 3).
// Steps at or past nsym write 0.
//
// Bound on the H100: each lane is a chain of dependent steps (encode: a
// table read, a compare, a 32-bit divide by a divisor known ahead;
// decode: two dependent table reads and a multiply), ~35 integer
// operations a step; the bytes are the step tables or words read once
// and the outputs written once.  Design: one thread a lane, one warp a
// block, so that a block of few lanes (pg1661 x 6: 767 used lanes) still
// spreads over many SMs.  Encode prefetches kBatch steps of idx (one
// coalesced row a step) and their table entries into registers, two
// register batches in turn, so a batch's serial steps wait on no load;
// the divide is a multiply-high by a reciprocal formed from the
// prefetched f, off the chain.  Decode's tables (4 MiB of slot table
// and 128 KB of packed entries at B = 4 blocks) stay in L2; the next
// word is loaded before it is known to be needed, and four steps'
// symbols leave as one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kBatch = 16;
constexpr int kProbBits = 14;
constexpr uint32_t kScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kNctx = 32;
constexpr int kC2 = 4;

// Table entries of steps j0, j0-1, ..., j0-kBatch+1 (entry 0 below
// step 0: those steps are never coded).
__device__ __forceinline__ void load_batch(int (&e)[kBatch],
                                           const int32_t* idx,
                                           const int32_t* fc, size_t stride,
                                           int j0) {
  int t[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    t[i] = j0 - i >= 0 ? __ldg(idx + (j0 - i) * stride) : -1;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) e[i] = t[i] >= 0 ? __ldg(fc + t[i]) : 0;
}

// Code steps j0, j0-1, ..., j0-kBatch+1 (those >= 0).
__device__ __forceinline__ void encode_batch(const int (&e)[kBatch], int j0,
                                             uint32_t& x, int& count,
                                             int16_t* row) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (j0 - i < 0) break;
    const uint32_t f = static_cast<uint32_t>(e[i]) >> kProbBits;
    const uint32_t c = static_cast<uint32_t>(e[i]) & (kScale - 1);
    const uint32_t fx = f > 1 ? f : 1;
    // x / fx as a multiply-high by rcp = floor((2^32 - 1) / fx): the
    // estimate is floor(x / fx) or one less, one correction
    const uint32_t rcp = 0xFFFFFFFFu / fx;
    const bool emit = f < kScale && x >= (f << (32 - kProbBits));
    if (emit) row[count] = static_cast<int16_t>(x & 0xFFFFu);
    count += emit;
    const uint32_t y = emit ? x >> 16 : x;
    uint32_t q = __umulhi(y, rcp);
    uint32_t r = y - q * fx;
    const bool over = r >= fx;
    q += over;
    r -= over ? fx : 0u;
    x = (q << kProbBits) + r + c;
  }
}

__global__ void __launch_bounds__(kThreads)
rans_encode_kernel(const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ nsym,
                   const int32_t* __restrict__ fc,
                   int16_t* __restrict__ words,
                   long long* __restrict__ counts,
                   long long* __restrict__ states, int C, int L) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const size_t stride = static_cast<size_t>(L);
  const int32_t* col = idx + l;
  int16_t* row = words + static_cast<size_t>(l) * (C + 2);
  const int n = min(max(nsym[l], 0), C);
  uint32_t x = kRansL;
  int count = 0;
  int ea[kBatch], eb[kBatch];
  load_batch(ea, col, fc, stride, n - 1);
  for (int j0 = n - 1; j0 >= 0; j0 -= 2 * kBatch) {
    load_batch(eb, col, fc, stride, j0 - kBatch);
    encode_batch(ea, j0, x, count, row);
    if (j0 - kBatch < 0) break;
    load_batch(ea, col, fc, stride, j0 - 2 * kBatch);
    encode_batch(eb, j0 - kBatch, x, count, row);
  }
  for (int i = 0, j = count - 1; i < j; ++i, --j) {
    const int16_t v = row[i];
    row[i] = row[j];
    row[j] = v;
  }
  counts[l] = count;
  states[l] = x;
}

__device__ __forceinline__ int ctx_class(int s) {
  return (s >= 1) + (s >= 2) + (s >= 3) + (s >= 4) + (s >= 6) + (s >= 10) +
         (s >= 18);
}

__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint16_t* __restrict__ words,
                   const long long* __restrict__ states,
                   const long long* __restrict__ fctx,
                   const int32_t* __restrict__ nsym,
                   const uint16_t* __restrict__ lut,
                   const int32_t* __restrict__ fc, int32_t* __restrict__ out,
                   int C, int L, int S, int nlanes) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const uint16_t* w = words + static_cast<size_t>(l) * (C + 2);
  int4* o = reinterpret_cast<int4*>(out + static_cast<size_t>(l) * C);
  const int n = min(max(nsym[l], 0), C);
  const long long base = static_cast<long long>(l / nlanes) * kNctx;
  uint32_t x = static_cast<uint32_t>(states[l]);
  long long k = fctx[l];
  int rpos = 0;
  uint32_t wn = __ldg(w);
  int buf[4];
  for (int j = 0; j < C; ++j) {
    int s = 0;
    if (j < n) {
      const uint32_t slot = x & (kScale - 1);
      s = __ldg(lut + (k << kProbBits) + slot);
      const uint32_t e = static_cast<uint32_t>(__ldg(fc + k * S + s));
      x = (e >> kProbBits) * (x >> kProbBits) + slot - (e & (kScale - 1));
      if (x < kRansL) {
        x = (x << 16) | wn;
        ++rpos;
        wn = __ldg(w + min(rpos, C + 1));
      }
      const long long kl = k - base;
      const long long q = kl >> 2;  // floor division, as the plain version
      k = base + ctx_class(s) * kC2 + (q < kC2 - 1 ? q : kC2 - 1);
    }
    buf[j & 3] = s;
    if ((j & 3) == 3) o[j >> 2] = make_int4(buf[0], buf[1], buf[2], buf[3]);
  }
}

}  // namespace

extern "C" int tplc_rans_encode(const void* idx, const void* nsym,
                                const void* fc, void* words, void* counts,
                                void* states, int C, int L, void* stream) {
  if (L > 0) {
    rans_encode_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nsym),
        static_cast<const int32_t*>(fc), static_cast<int16_t*>(words),
        static_cast<long long*>(counts), static_cast<long long*>(states), C,
        L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tplc_rans_decode(const void* words, const void* states,
                                const void* fctx, const void* nsym,
                                const void* lut, const void* fc, void* out,
                                int C, int L, int S, int nlanes,
                                void* stream) {
  if (L > 0) {
    rans_decode_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(words),
        static_cast<const long long*>(states),
        static_cast<const long long*>(fctx),
        static_cast<const int32_t*>(nsym),
        static_cast<const uint16_t*>(lut), static_cast<const int32_t*>(fc),
        static_cast<int32_t*>(out), C, L, S, nlanes);
  }
  return static_cast<int>(cudaGetLastError());
}
