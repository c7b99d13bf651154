// K8 — whole-group canonical Huffman walk, flat form, for Hopper (sm_90a).
//
// Replaces tpulc/codecs/huffman/pallas_decode.py:
// decode_canonical_indices_flat (_kernel_flat, pallas_decode.py:426-513),
// the decode that TPULC_HUFF_KERNEL=flat selects.  One launch decodes
// every chunk of a block group.  Chunk c of stream b = c / (nsub / B)
// starts at bit offs[c] and has bits_left[c] = min(tbits[b] - offs[c],
// chunk_syms * L) bits; its table is tile c / kTile's left-justified
// limits lj[l] = lim[l] << (L - l) and bases base[l].  Per step:
//   - window = the next L bits; length = 1 + sum_{l<L} [win >= lj[l]]
//     (left-justified canonical regions are nested, so the first-hit
//     chain of K3 becomes a monotone count);
//   - valid iff win < lj[L]; else length 1, index 0;
//   - index = base[length] + (win >> (L - length));
//   - emit while bits_left > 0, then bits_left -= length;
//   - packed output: byte k of word q is clip(index, 0, 255) of symbol
//     4q+k, little-endian.
// Bits past a stream's W words read as zero.  The wrapper and the plain
// PyTorch version live in tpulc_torch/codecs/huffman/decode_kernels.py.
//
// Bound on the H100: the serial dependency of each chunk's walk, as K3.
// Design: a CUDA block is one table tile of kTile chunks (the caller pads
// each stream's chunk count to a tile multiple, as decode.py:568-573
// pads to the TPU tile), so the tile's L+1 limits and bases are loaded
// once into shared memory and every thread's classifier reads them
// there, broadcast; one thread per chunk, with the 64-bit reservoir of
// K3 (one refill per symbol pair) reading the stream straight from
// global memory.  The TPU's 128-byte-row gather and in-row bit position
// (gather_rows, pallas_decode.py:585-615) are a v5e HBM trick and are
// not carried over.  Left for later: the packed row each thread writes
// is uncoalesced (128 B apart between neighbouring threads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 16;
constexpr int kTile = 128;  // = TILE in decode_kernels.py

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ w,
                                            int64_t nwords, int64_t i) {
  return i < nwords ? w[i] : 0u;
}

__global__ void __launch_bounds__(kTile)
    huffman_flat_kernel(const uint32_t* __restrict__ words, int nstreams,
                        int nwords, const int32_t* __restrict__ offs,
                        const int32_t* __restrict__ bits_left, int nsub,
                        const int32_t* __restrict__ lj,
                        const int32_t* __restrict__ base,
                        int32_t* __restrict__ out, int chunk_syms, int L) {
  __shared__ int lj_s[kMaxLen + 1];
  __shared__ int base_s[kMaxLen + 1];
  const int tile = blockIdx.x;
  if (threadIdx.x <= L) {
    lj_s[threadIdx.x] = lj[tile * (L + 1) + threadIdx.x];
    base_s[threadIdx.x] = base[tile * (L + 1) + threadIdx.x];
  }
  __syncthreads();
  const int c = tile * kTile + threadIdx.x;
  if (c >= nsub) return;
  const int b = c / (nsub / nstreams);
  const uint32_t* w = words + static_cast<size_t>(b) * nwords;
  const int64_t start = static_cast<uint32_t>(offs[c]);
  int left = bits_left[c];
  const int64_t w0 = start >> 5;
  const int sh = static_cast<int>(start & 31);
  uint64_t buf = ((static_cast<uint64_t>(word_at(w, nwords, w0)) << 32) |
                  word_at(w, nwords, w0 + 1))
                 << sh;
  int nav = 64 - sh;
  int64_t fidx = w0 + 2;
  int32_t* o = out + static_cast<size_t>(c) * (chunk_syms / 4);
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
      int ln = 1;
#pragma unroll
      for (int l = 1; l < kMaxLen; ++l)
        if (l < L) ln += win >= lj_s[l];
      const bool found = win < lj_s[L];
      if (!found) ln = 1;
      const int ci = found ? base_s[ln] + (win >> (L - ln)) : 0;
      const bool active = left > 0;
      const int s = p + k;
      quad |= static_cast<uint32_t>(min(max(active ? ci : 0, 0), 255))
              << (8 * (s & 3));
      if ((s & 3) == 3) {
        o[s >> 2] = static_cast<int32_t>(quad);
        quad = 0;
      }
      const int st = active ? ln : 0;
      left -= st;
      buf <<= st;
      nav -= st;
    }
  }
}

}  // namespace

extern "C" int tplc_huffman_walk_flat(const void* words, int nstreams,
                                      int nwords, const void* offs,
                                      const void* bits_left, int nsub,
                                      const void* lj, const void* base,
                                      void* out, int chunk_syms, int L,
                                      void* stream) {
  if (L < 1 || L > kMaxLen || chunk_syms % 4 != 0 || nstreams < 1 ||
      nsub % nstreams != 0 || (nsub / nstreams) % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsub > 0)
    huffman_flat_kernel<<<nsub / kTile, kTile, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), nstreams, nwords,
        static_cast<const int32_t*>(offs),
        static_cast<const int32_t*>(bits_left), nsub,
        static_cast<const int32_t*>(lj), static_cast<const int32_t*>(base),
        static_cast<int32_t*>(out), chunk_syms, L);
  return static_cast<int>(cudaGetLastError());
}
