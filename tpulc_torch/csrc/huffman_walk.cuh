// The canonical Huffman chunk walk's core for Hopper (sm_90a), shared by
// K3 (csrc/huffman_walk.cu), K7 (csrc/huffman_v1.cu) and K8
// (csrc/huffman_flat.cu).  Each of those files includes this header and
// instantiates only its own kernels, so the three build in parallel.
//
// What the three kernels share (the design notes are in huffman_walk.cu):
//   - a block is a tile of 32, 64 or 128 consecutive chunks of ONE stream,
//     one thread a chunk, and may walk several consecutive tiles;
//   - the tile's bits are one span of the stream, from its lowest active
//     start to its highest end + L, staged in shared memory with 16-byte
//     loads (stage_span); when the span exceeds the stage the whole tile
//     walks from global memory (decided once a block);
//   - a thread's 64-bit reservoir refills once a symbol pair, one word
//     read ahead of its use (refill);
//   - the classifier: limits left-justified in registers, all compares
//     independent (first_hits for K3/K7, count_rule for K8), or, for
//     L <= 12 and one table a tile, a 2^L window table built once by the
//     block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr int kMaxLen = 16;   // 2 * L <= 32 keeps one refill per pair
constexpr int kSlab = 128;    // symbols walked between two write-outs
constexpr int kStageWords = 36;  // stage words a chunk of the tile
constexpr int kRowPad = 4;    // words a shared output row exceeds its data
constexpr int kLutLen = 12;   // longest L that gets a window table
constexpr int kLutShare = 32; // most table entries a thread builds

// K3's and K7's arguments (one entry point signature each)
struct WalkArgs {
  const uint32_t* words;
  const int32_t* tbits;
  const int32_t* offs;
  const int32_t* lim;
  const int32_t* base;
  const int32_t* tab;
  int32_t* out;
  int nstreams, nwords, nsub, ntab, chunk_syms, L;
  int reps;  // consecutive tiles of a stream a block walks
};

// words of the staged span; an index past it reads the span's last word
// (such bits lie past end + L and are never looked at)
struct StageReader {
  const uint32_t* p;
  int last;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return p[min(i, last)];
  }
};

// words of the stream in global memory, zero past W
struct GlobalReader {
  const uint32_t* p;
  int nwords;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return i < nwords ? p[i] : 0u;
  }
};

struct WalkState {
  uint64_t buf;    // the reservoir, valid bits at the top
  uint32_t nextw;  // word `fidx`, read ahead of the refill that takes it
  int nav;         // valid bits in buf
  int fidx;
  int left;        // bits before the chunk's end (active while > 0)
};

template <class Reader>
__device__ __forceinline__ WalkState walk_begin(const Reader& rd, int i0,
                                                int sh, int left) {
  WalkState st;
  st.buf = ((static_cast<uint64_t>(rd(i0)) << 32) | rd(i0 + 1)) << sh;
  st.nav = 64 - sh;
  st.fidx = i0 + 2;
  st.nextw = rd(st.fidx);
  st.left = left;
  return st;
}

// before each symbol pair: top the reservoir up with the word read ahead,
// and read the next one
template <class Reader>
__device__ __forceinline__ void refill(WalkState& st, const Reader& rd) {
  if (st.nav <= 32) {
    st.buf |= static_cast<uint64_t>(st.nextw) << (32 - st.nav);
    st.nav += 32;
    ++st.fidx;
    st.nextw = rd(st.fidx);
  }
}

__device__ __forceinline__ void advance(WalkState& st, int ln) {
  const int adv = st.left > 0 ? ln : 0;
  st.buf <<= adv;
  st.nav -= adv;
  st.left -= adv;
}

// the first-hit rule (K3, K7): bit l-1 set where win >> (L-l) < lim[l],
// with lj[l] = clamp(lim[l], 0, 2^l) << (L-l) and 0 past L
template <int LT>
__device__ __forceinline__ unsigned first_hits(
    int win, const int (&lj)[(LT ? LT : kMaxLen) + 1]) {
  constexpr int LMAX = LT ? LT : kMaxLen;
  unsigned hits = 0;
#pragma unroll
  for (int l = 1; l <= LMAX; ++l)
    hits |= static_cast<unsigned>(win < lj[l]) << (l - 1);
  return hits;
}

// (length, index) by the first-hit rule, or (1, 0) when no length matches
template <int LT>
__device__ __forceinline__ void classify(
    int win, const int (&lj)[(LT ? LT : kMaxLen) + 1],
    const int32_t* __restrict__ base_col, int tile, int L, int& ln, int& ci) {
  const unsigned hits = first_hits<LT>(win, lj);
  const bool found = hits != 0;
  ln = found ? __ffs(hits) : 1;
  ci = found ? base_col[ln * tile] + (win >> (L - ln)) : 0;
}

// (length, clip(index, 0, 255)) by K8's count rule: length 1 + the l < L
// with win >= lj[l] (lj as given, INT_MAX at and past L), valid iff
// win < ljL = lj[L], else (1, 0).  The index is summed in 64 bits, as the
// plain version does, before the clip.
template <int LT>
__device__ __forceinline__ void count_rule(
    int win, const int (&lj)[(LT ? LT : kMaxLen) + 1], int ljL,
    const int32_t* __restrict__ base_col, int tile, int L, int& ln, int& ci) {
  constexpr int LMAX = LT ? LT : kMaxLen;
  int n = 1;
#pragma unroll
  for (int l = 1; l < LMAX; ++l) n += win >= lj[l];
  const bool found = win < ljL;
  ln = found ? n : 1;
  const long long v = static_cast<long long>(base_col[ln * tile]) +
                      (win >> (L - ln));
  ci = found ? static_cast<int>(min(max(v, 0LL), 255LL)) : 0;
}

template <int LT, bool kCount>
__device__ __forceinline__ void classify_by(
    int win, const int (&lj)[(LT ? LT : kMaxLen) + 1], int ljL,
    const int32_t* __restrict__ base_col, int tile, int L, int& ln, int& ci) {
  if (kCount)
    count_rule<LT>(win, lj, ljL, base_col, tile, L, ln, ci);
  else
    classify<LT>(win, lj, base_col, tile, L, ln, ci);
}

// S symbols (even; a multiple of 4 when packed) into `row`.  kLut: the
// window indexes a table of (clipped index << 8 | length), packed only.
template <int LT, bool kPacked, bool kLut, bool kCount, class Reader>
__device__ __forceinline__ void walk_slab(
    WalkState& st, const Reader& rd, const int (&lj)[(LT ? LT : kMaxLen) + 1],
    int ljL, const int32_t* __restrict__ base_col,
    const uint16_t* __restrict__ lut, int tile, int L, int S,
    int32_t* __restrict__ row) {
  constexpr int kStep = kPacked ? 4 : 2;
  for (int p = 0; p < S; p += kStep) {
    uint32_t quad = 0;
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if ((k & 1) == 0) refill(st, rd);
      const int win = static_cast<int>(st.buf >> (64 - L));
      int ln, ci;
      if (kLut) {
        const unsigned e = lut[win];
        ln = static_cast<int>(e & 0xffu);
        ci = static_cast<int>(e >> 8);
      } else {
        classify_by<LT, kCount>(win, lj, ljL, base_col, tile, L, ln, ci);
      }
      const int v = st.left > 0 ? ci : 0;
      if (kPacked)
        quad |= static_cast<uint32_t>(min(max(v, 0), 255)) << (8 * k);
      else
        row[p + k] = v;
      advance(st, ln);
    }
    if (kPacked) row[p >> 2] = static_cast<int32_t>(quad);
  }
}

// the packed walks' window table: each of the 2^L windows classified once
// into (clip(index, 0, 255) << 8) | length
template <int LT, bool kCount>
__device__ __forceinline__ void build_lut(
    uint16_t* lut, const int (&lj)[(LT ? LT : kMaxLen) + 1], int ljL,
    const int32_t* __restrict__ base_col, int tile, int L, int tid) {
  for (int win = tid; win < (1 << L); win += tile) {
    int ln, ci;
    classify_by<LT, kCount>(win, lj, ljL, base_col, tile, L, ln, ci);
    lut[win] = static_cast<uint16_t>((min(max(ci, 0), 255) << 8) | ln);
  }
}

// a chunk's table t for the first-hit rule: left-justified clamped limits
// into registers, the bases into this thread's shared column
template <int LT>
__device__ __forceinline__ void load_table(
    const int32_t* __restrict__ lim, const int32_t* __restrict__ base, int t,
    int L, int tile, int tid, int (&lj)[(LT ? LT : kMaxLen) + 1],
    int32_t* base_s) {
  constexpr int LMAX = LT ? LT : kMaxLen;
  lj[0] = 0;
#pragma unroll
  for (int l = 1; l <= LMAX; ++l) {
    if (l <= L) {
      const int v = lim[t * (L + 1) + l];
      lj[l] = min(max(v, 0), 1 << l) << (L - l);
      base_s[l * tile + tid] = base[t * (L + 1) + l];
    } else {
      lj[l] = 0;
    }
  }
}

// shared memory of a block of `tile` threads, in words: the stage, the
// base columns, the output tile (rows of `stride` words) and, with the
// window table, its 2^L 16-bit entries
__host__ __device__ constexpr int row_stride(int C, bool packed) {
  return ((packed ? (C < kSlab ? C : kSlab) / 4 : (C < kSlab ? C : kSlab)) + 3) /
             4 * 4 + kRowPad;
}

__host__ __device__ constexpr bool lut_fits(int L, int tile) {
  return L <= kLutLen && (1 << L) <= kLutShare * tile;
}

struct Span {
  int wbase;    // stage[0] is stream word wbase (>= -3)
  int nst;      // staged words (a multiple of 4), 0 when not staged
  bool staged;  // the tile walks from the stage, else from global memory
};

// The span of the tile's active chunks, in words: each active chunk gives
// its first word `wlo` and one past the last word it may read, `whi`
// (whi > 0).  The span starts on a 16-byte boundary and is copied into
// `stage` by 16-byte loads of neighbouring threads (words outside the
// stream as zero) when it fits tile * kStageWords words.  Every thread of
// the block calls this; it ends with the stage visible to all.
__device__ __forceinline__ Span stage_span(
    uint32_t* stage, unsigned& s_lo, unsigned& s_hi,
    const uint32_t* __restrict__ w, int nwords, bool act, unsigned wlo,
    unsigned whi, int tile, int tid) {
  if (tid == 0) {
    s_lo = 0xffffffffu;
    s_hi = 0u;
  }
  __syncthreads();
  if (act) {
    atomicMin(&s_lo, wlo);
    atomicMax(&s_hi, whi);
  }
  __syncthreads();
  const unsigned hi = s_hi;
  const int lo = hi != 0u ? static_cast<int>(s_lo) : 0;
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(w + lo) >> 2) & 3u);
  Span sp;
  sp.wbase = lo - mis;
  const int64_t span = hi != 0u ? static_cast<int64_t>(hi) - sp.wbase : 0;
  sp.staged = hi != 0u && span <= tile * kStageWords;
  sp.nst = sp.staged ? static_cast<int>((span + 3) & ~int64_t{3}) : 0;
  for (int g = 4 * tid; g < sp.nst; g += 4 * tile) {
    const int s = sp.wbase + g;
    uint4 v;
    if (s >= 0 && s + 3 < nwords) {
      v = *reinterpret_cast<const uint4*>(w + s);
    } else {
      v.x = s >= 0 && s < nwords ? w[s] : 0u;
      v.y = s + 1 >= 0 && s + 1 < nwords ? w[s + 1] : 0u;
      v.z = s + 2 >= 0 && s + 2 < nwords ? w[s + 2] : 0u;
      v.w = s + 3 >= 0 && s + 3 < nwords ? w[s + 3] : 0u;
    }
    *reinterpret_cast<uint4*>(stage + g) = v;
  }
  __syncthreads();
  return sp;
}

// one past the last word a chunk that ends at bit `end` may read
__device__ __forceinline__ unsigned span_end(int64_t end, int L) {
  return static_cast<unsigned>((end + L - 1) >> 5) + 1u;
}

// nt rows of sq words from the shared output tile (rows of `stride`
// words) to dst (rows of Q words): 16-byte stores where both sides allow
__device__ __forceinline__ void write_tile(int32_t* __restrict__ dst,
                                           const int32_t* __restrict__ otile,
                                           int nt, int sq, int Q, int stride,
                                           bool out16, int tile, int tid) {
  if (out16 && sq % 4 == 0) {
    const int n4 = sq / 4;
    for (int e = tid; e < nt * n4; e += tile) {
      const int r = e / n4;
      const int k = 4 * (e - r * n4);
      *reinterpret_cast<int4*>(dst + static_cast<size_t>(r) * Q + k) =
          *reinterpret_cast<const int4*>(otile + r * stride + k);
    }
  } else {
    for (int e = tid; e < nt * sq; e += tile) {
      const int r = e / sq;
      const int k = e - r * sq;
      dst[static_cast<size_t>(r) * Q + k] = otile[r * stride + k];
    }
  }
}

// chunks a tile: 128 (the only tile whose threads can share a 2^12-entry
// window table's build) once such tiles fill the card, 32 while most SMs
// would idle.  chip_smoke.py sweeps K3's tiles at both shapes: 7,032
// chunks take the same time at every tile, 786,432 a third less at 128.
inline int auto_tile(int nsub) { return nsub >= 32 * 1024 ? 128 : 32; }

// tiles a block: more than one only to spread a window table's build,
// and only while the blocks still fill the card several times over
inline int auto_reps(int nsub, int tile, bool lut) {
  return lut && nsub / tile >= 4096 ? 4 : 1;
}

// blocks of `tile` threads, each walking `reps` tiles of one stream
inline int walk_blocks(int nsub, int nstreams, int tile, int reps) {
  const int ccap = nsub / nstreams;
  const int tiles = (ccap + tile - 1) / tile;
  return nstreams * ((tiles + reps - 1) / reps);
}

// the tiles [jfirst, jend) of stream b (ccap chunks) that this block walks
struct BlockTiles {
  int ccap, b, jfirst, jend;
  __device__ __forceinline__ BlockTiles(int nsub, int nstreams, int tile,
                                        int reps) {
    ccap = nsub / nstreams;
    const int tiles = (ccap + tile - 1) / tile;        // a stream
    const int groups = (tiles + reps - 1) / reps;      // blocks a stream
    b = blockIdx.x / groups;
    jfirst = (blockIdx.x - b * groups) * reps;
    jend = min(jfirst + reps, tiles);
  }
};

template <class Kernel, class Args>
int launch_walk(Kernel kern, const Args& a, int blocks, int tile, int bytes,
                cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<blocks, tile, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace walk
