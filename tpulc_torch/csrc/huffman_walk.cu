// K3 — canonical Huffman chunk walk for Hopper (sm_90a).
//
// Replaces tpulc/codecs/huffman/pallas_decode.py:
// decode_canonical_indices_buffered (_kernel_buffered), in both its
// unpacked mode (the bz decode) and its packed mode (the huffman codec's
// default decode).  For each chunk c of stream b = c / (nsub / B) it
// decodes chunk_syms canonical INDICES starting at bit offs[c] of that
// stream's MSB-first uint32 words, with table t = tab[c]:
//   - window = the next L bits; the code length is the first l with
//     (window >> (L-l)) < lim[t][l], the index base[t][l] + that code;
//   - no length matches (a corrupt stream): advance one bit, index 0
//     (pallas_decode.py:260);
//   - end = min(tbits[b], offs[c] + chunk_syms * L)
//     (pallas_decode.py:340-343); at or past end the chunk emits 0 and
//     stops advancing (pallas_decode.py:276);
//   - packed: byte k of output word q is clip(index, 0, 255) of symbol
//     4q+k (pallas_decode.py:263-274), little-endian.
// Bits past a stream's W words read as zero.  The wrapper and the plain
// PyTorch version live in tpulc_torch/codecs/huffman/decode_kernels.py.
//
// Bound on the H100: the serial dependency of each chunk's walk (the
// next window depends on the last code length).  A 1 MiB huffman block
// has 8,192 chunks of 128 symbols, a 100 MB group 786,432 — enough
// threads to fill the card, but each thread runs 128 dependent steps, so
// the walk is latency-bound; a bz block has only ~7,000 chunks (under two
// warps per SM).  Design: one thread per chunk; its lim/base rows live
// in registers (the compare chain is unrolled over the maximum length),
// the stream is read straight from global memory (L1/L2-cached) into a
// 64-bit reservoir that refills once per symbol PAIR (two codes are
// <= 2L <= 32 bits).  The TPU wrapper's stride-32 row-gather layout
// (pallas_decode.py:321-359) is an HBM trick the card does not need.
// Tables are per table index, not per chunk: a 100 MB group's per-chunk
// copies would be 82 MB.  Known costs left for later: each thread writes
// its own output row, uncoalesced (K7 shows the step-major layout), and
// a sub-chunk split per warp would raise occupancy for bz.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 16;  // 2 * L <= 32 keeps one refill per pair
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ w,
                                            int64_t nwords, int64_t i) {
  return i < nwords ? w[i] : 0u;
}

__global__ void huffman_walk_kernel(const uint32_t* __restrict__ words,
                                    int nstreams, int nwords,
                                    const int32_t* __restrict__ tbits,
                                    const int32_t* __restrict__ offs, int nsub,
                                    const int32_t* __restrict__ lim,
                                    const int32_t* __restrict__ base,
                                    int ntab, const int32_t* __restrict__ tab,
                                    int32_t* __restrict__ out, int chunk_syms,
                                    int L, int packed) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= nsub) return;
  const int ccap = nsub / nstreams;
  const int b = c / ccap;
  const int t = min(max(tab[c], 0), ntab - 1);
  int lim_r[kMaxLen + 1], base_r[kMaxLen + 1];
#pragma unroll
  for (int l = 0; l <= kMaxLen; ++l) {
    lim_r[l] = l <= L ? lim[t * (L + 1) + l] : 0;
    base_r[l] = l <= L ? base[t * (L + 1) + l] : 0;
  }
  const uint32_t* w = words + static_cast<size_t>(b) * nwords;
  const int64_t start = static_cast<uint32_t>(offs[c]);
  const int64_t end =
      min(static_cast<int64_t>(tbits[b]),
          start + static_cast<int64_t>(chunk_syms) * L);
  int64_t pos = start;
  const int64_t w0 = start >> 5;
  const int sh = static_cast<int>(start & 31);
  uint64_t buf = ((static_cast<uint64_t>(word_at(w, nwords, w0)) << 32) |
                  word_at(w, nwords, w0 + 1))
                 << sh;
  int nav = 64 - sh;  // valid bits at the top of buf
  int64_t fidx = w0 + 2;
  const size_t row = static_cast<size_t>(c) *
                     static_cast<size_t>(packed ? chunk_syms / 4 : chunk_syms);
  int32_t* o = out + row;
  uint32_t quad = 0;
  for (int p = 0; p < chunk_syms; p += 2) {
    if (nav <= 32) {
      buf |= static_cast<uint64_t>(word_at(w, nwords, fidx)) << (32 - nav);
      nav += 32;
      ++fidx;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int win = static_cast<int>(buf >> (64 - L));
      int ln = 1, ci = 0;
      bool found = false;
#pragma unroll
      for (int l = 1; l <= kMaxLen; ++l) {
        if (l <= L && !found) {
          const int code = win >> (L - l);
          if (code < lim_r[l]) {
            ln = l;
            ci = base_r[l] + code;
            found = true;
          }
        }
      }
      const bool active = pos < end;
      const int v = active ? ci : 0;
      const int s = p + k;
      if (packed) {
        quad |= static_cast<uint32_t>(min(max(v, 0), 255)) << (8 * (s & 3));
        if ((s & 3) == 3) {
          o[s >> 2] = static_cast<int32_t>(quad);
          quad = 0;
        }
      } else {
        o[s] = v;
      }
      const int st = active ? ln : 0;
      buf <<= st;
      nav -= st;
      pos += st;
    }
  }
}

}  // namespace

extern "C" int tplc_huffman_walk(const void* words, int nstreams, int nwords,
                                 const void* tbits, const void* offs, int nsub,
                                 const void* lim, const void* base, int ntab,
                                 const void* tab, void* out, int chunk_syms,
                                 int L, int packed, void* stream) {
  if (L < 1 || L > kMaxLen || chunk_syms % (packed ? 4 : 2) != 0 ||
      nstreams < 1 || nsub % nstreams != 0 || ntab < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsub > 0)
    huffman_walk_kernel<<<(nsub + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), nstreams, nwords,
        static_cast<const int32_t*>(tbits), static_cast<const int32_t*>(offs),
        nsub, static_cast<const int32_t*>(lim),
        static_cast<const int32_t*>(base), ntab,
        static_cast<const int32_t*>(tab), static_cast<int32_t*>(out),
        chunk_syms, L, packed);
  return static_cast<int>(cudaGetLastError());
}
