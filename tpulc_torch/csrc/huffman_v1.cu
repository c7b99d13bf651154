// K7 — canonical Huffman chunk walk, v1 form, for Hopper (sm_90a).
//
// Replaces tpulc/codecs/huffman/pallas_decode.py:
// decode_canonical_indices (_kernel, pallas_decode.py:41-86), the decode
// that TPULC_HUFF_KERNEL=v1 selects.  Same contract as K3 unpacked
// (csrc/huffman_walk.cu): per chunk c of stream b = c / (nsub / B), from
// bit offs[c], table t = tab[c]; first l with (win >> (L-l)) < lim[t][l]
// gives length l and index base[t][l] + code, none gives length 1 and
// index 0; end = min(tbits[b], offs[c] + chunk_syms * L); steps at or
// past end emit 0 and do not advance; bits past the W words read as 0.
// The wrapper and the plain PyTorch version live in
// tpulc_torch/codecs/huffman/decode_kernels.py.
//
// Bound on the H100: as K3, the serial dependency of each chunk's walk,
// here with two dependent global loads per symbol and no reservoir.
// Design: what v1 is — one thread per chunk, one symbol per step; each
// step fetches words pos>>5 and pos>>5 + 1 from global memory (the TPU
// kernel's two masked sublane reductions, pallas_decode.py:54-60, become
// two L1-cached loads), runs the compare chain, emits and advances.  The
// output is step-major [chunk_syms, nsub], as the Pallas out_shape is,
// so at each step a warp stores 32 neighbouring int32s (one coalesced
// 128-byte transaction); the wrapper returns the [nsub, chunk_syms] view.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 16;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ w,
                                            int64_t nwords, int64_t i) {
  return i < nwords ? w[i] : 0u;
}

__global__ void huffman_v1_kernel(const uint32_t* __restrict__ words,
                                  int nstreams, int nwords,
                                  const int32_t* __restrict__ tbits,
                                  const int32_t* __restrict__ offs, int nsub,
                                  const int32_t* __restrict__ lim,
                                  const int32_t* __restrict__ base, int ntab,
                                  const int32_t* __restrict__ tab,
                                  int32_t* __restrict__ out, int chunk_syms,
                                  int L) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= nsub) return;
  const int b = c / (nsub / nstreams);
  const int t = min(max(tab[c], 0), ntab - 1);
  int lim_r[kMaxLen + 1], base_r[kMaxLen + 1];
#pragma unroll
  for (int l = 0; l <= kMaxLen; ++l) {
    lim_r[l] = l <= L ? lim[t * (L + 1) + l] : 0;
    base_r[l] = l <= L ? base[t * (L + 1) + l] : 0;
  }
  const uint32_t* w = words + static_cast<size_t>(b) * nwords;
  int64_t pos = static_cast<uint32_t>(offs[c]);
  const int64_t end = min(static_cast<int64_t>(tbits[b]),
                          pos + static_cast<int64_t>(chunk_syms) * L);
  for (int s = 0; s < chunk_syms; ++s) {
    const int64_t wi = pos >> 5;
    const int sh = static_cast<int>(pos & 31);
    const uint32_t hi = word_at(w, nwords, wi) << sh;
    const uint32_t lo = sh ? word_at(w, nwords, wi + 1) >> (32 - sh) : 0u;
    const int win = static_cast<int>((hi | lo) >> (32 - L));
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
    out[static_cast<size_t>(s) * nsub + c] = active ? ci : 0;
    pos += active ? ln : 0;
  }
}

}  // namespace

extern "C" int tplc_huffman_walk_v1(const void* words, int nstreams,
                                    int nwords, const void* tbits,
                                    const void* offs, int nsub,
                                    const void* lim, const void* base,
                                    int ntab, const void* tab, void* out,
                                    int chunk_syms, int L, void* stream) {
  if (L < 1 || L > kMaxLen || chunk_syms < 1 || nstreams < 1 ||
      nsub % nstreams != 0 || ntab < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsub > 0)
    huffman_v1_kernel<<<(nsub + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), nstreams, nwords,
        static_cast<const int32_t*>(tbits), static_cast<const int32_t*>(offs),
        nsub, static_cast<const int32_t*>(lim),
        static_cast<const int32_t*>(base), ntab,
        static_cast<const int32_t*>(tab), static_cast<int32_t*>(out),
        chunk_syms, L);
  return static_cast<int>(cudaGetLastError());
}
