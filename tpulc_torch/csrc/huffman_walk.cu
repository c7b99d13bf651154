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
// Bound on the H100: bytes at the huffman codec's shape (a 100 MB group
// is 786,432 chunks: 59 MB of stream in, 100 MB of packed ranks out), the
// serial chain of 128 dependent steps a chunk at the bz shape (7,032
// chunks).  What a step must not wait for is device memory, so a block
// walks from shared memory only:
//   - a block is a tile of 32, 64 or 128 consecutive chunks of ONE stream
//     (a ragged last tile a stream, never a tile across two), one thread a
//     chunk; the entry point picks the tile from the shape;
//   - the tile's bits are one span of the stream, from its lowest start
//     to its highest end + L.  The block copies that span into shared
//     memory with 16-byte loads of neighbouring threads (words past W as
//     zero) and every thread's 64-bit reservoir refills from there, one
//     word a symbol pair, read one refill ahead of its use;
//   - offs comes from the wire and may be non-monotone, equal or far
//     apart.  A chunk that is never active (start >= end: bz pads with
//     offs == tbits) counts for no span and emits zeros without walking.
//     When the span of the others exceeds the stage (36 words a chunk:
//     9 bits a symbol at 128 symbols), the whole tile walks from global
//     memory instead, decided once a block;
//   - the classifier is off the chain: limits are clamped to [0, 2^l] and
//     left-justified once a thread (win >> (L-l) < lim[l] is then
//     win < lj[l], for any int32 limit), a step makes all L compares
//     independently into a bit mask, and __ffs gives the first hit.  L is
//     a template parameter (12, 15, and a generic build whose unused
//     limits are 0), so no length test runs in a step.  The limits are L
//     registers a thread; the bases, indexed by the hit, a column a
//     thread in shared memory;
//   - packed, with L <= 12 and one table for the whole tile (the huffman
//     codec: a table a stream), the classifier leaves the step
//     altogether: the block classifies each of the 2^L windows once, by
//     the same first-hit rule, into a shared table of (clipped index,
//     length), and a step is one 16-bit read.  A block then walks several
//     consecutive tiles of its stream (4 at the huffman codec's shape) and
//     keeps the table while the table index stays, so that the build (32
//     windows a thread at a 128-chunk tile) is spread over them.  A tile
//     with mixed tables, a longer L or the unpacked mode compares;
//   - a thread writes its symbols (packed: its words) into a shared
//     tile, 128 symbols at a time, and the block writes the tile out with
//     16-byte stores of neighbouring threads.  Rows are 4 words longer
//     than their data so that they stay 16-byte aligned; the walk's
//     stores then collide 4 ways on a bank, once a symbol (unpacked) or
//     a symbol quad (packed), which the instructions of a step hide.
// The TPU wrapper's stride-32 row-gather layout (pallas_decode.py:321-359)
// is an HBM trick the card does not need.  Tables are per table index,
// not per chunk: a 100 MB group's per-chunk copies would be 82 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 16;   // 2 * L <= 32 keeps one refill per pair
constexpr int kSlab = 128;    // symbols walked between two write-outs
constexpr int kStageWords = 36;  // stage words a chunk of the tile
constexpr int kRowPad = 4;    // words a shared output row exceeds its data
constexpr int kLutLen = 12;   // longest L that gets a window table
constexpr int kLutShare = 32; // most table entries a thread builds

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

// the first-hit rule on one L-bit window: (length, index), or (1, 0)
// when no length matches
template <int LT>
__device__ __forceinline__ void classify(
    int win, const int (&lj)[(LT ? LT : kMaxLen) + 1],
    const int32_t* __restrict__ base_col, int tile, int L, int& ln, int& ci) {
  constexpr int LMAX = LT ? LT : kMaxLen;
  unsigned hits = 0;
#pragma unroll
  for (int l = 1; l <= LMAX; ++l)
    hits |= static_cast<unsigned>(win < lj[l]) << (l - 1);
  const bool found = hits != 0;
  ln = found ? __ffs(hits) : 1;
  ci = found ? base_col[ln * tile] + (win >> (L - ln)) : 0;
}

// S symbols (even; a multiple of 4 when packed) into `row`.  kLut: the
// window indexes a table of (clipped index << 8 | length), packed only.
template <int LT, bool kPacked, bool kLut, class Reader>
__device__ __forceinline__ void walk_slab(
    WalkState& st, const Reader& rd, const int (&lj)[(LT ? LT : kMaxLen) + 1],
    const int32_t* __restrict__ base_col, const uint16_t* __restrict__ lut,
    int tile, int L, int S, int32_t* __restrict__ row) {
  constexpr int kStep = kPacked ? 4 : 2;
  for (int p = 0; p < S; p += kStep) {
    uint32_t quad = 0;
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if ((k & 1) == 0 && st.nav <= 32) {
        st.buf |= static_cast<uint64_t>(st.nextw) << (32 - st.nav);
        st.nav += 32;
        ++st.fidx;
        st.nextw = rd(st.fidx);
      }
      const int win = static_cast<int>(st.buf >> (64 - L));
      int ln, ci;
      if (kLut) {
        const unsigned e = lut[win];
        ln = static_cast<int>(e & 0xffu);
        ci = static_cast<int>(e >> 8);
      } else {
        classify<LT>(win, lj, base_col, tile, L, ln, ci);
      }
      const bool active = st.left > 0;
      const int v = active ? ci : 0;
      if (kPacked)
        quad |= static_cast<uint32_t>(min(max(v, 0), 255)) << (8 * k);
      else
        row[p + k] = v;
      const int adv = active ? ln : 0;
      st.buf <<= adv;
      st.nav -= adv;
      st.left -= adv;
    }
    if (kPacked) row[p >> 2] = static_cast<int32_t>(quad);
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

template <int LT, bool kPacked>
__global__ void huffman_walk_kernel(const WalkArgs a) {
  constexpr int LMAX = LT ? LT : kMaxLen;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned s_lo, s_hi;
  const int tile = blockDim.x;
  const int tid = threadIdx.x;
  const int L = LT ? LT : a.L;
  const int C = a.chunk_syms;
  const int Q = kPacked ? C / 4 : C;  // words of an output row
  const int stride = row_stride(C, kPacked);
  uint32_t* stage = smem;
  int32_t* base_s = reinterpret_cast<int32_t*>(smem + tile * kStageWords);
  int32_t* otile = base_s + (kMaxLen + 1) * tile;
  uint16_t* lut = reinterpret_cast<uint16_t*>(otile + tile * stride);
  int32_t* row = otile + tid * stride;
  const int32_t* base_col = base_s + tid;
  const bool out16 =
      (reinterpret_cast<uintptr_t>(a.out) & 15u) == 0 && Q % 4 == 0;
  const bool may_lut = kPacked && lut_fits(L, tile);

  const int ccap = a.nsub / a.nstreams;
  const int tiles = (ccap + tile - 1) / tile;        // a stream
  const int groups = (tiles + a.reps - 1) / a.reps;  // blocks a stream
  const int b = blockIdx.x / groups;
  const int jfirst = (blockIdx.x - b * groups) * a.reps;
  const uint32_t* w = a.words + static_cast<size_t>(b) * a.nwords;
  const GlobalReader grd{w, a.nwords};
  int lut_tab = -1;  // the table index the window table holds

  for (int j = jfirst; j < min(jfirst + a.reps, tiles); ++j) {
    const int j0 = j * tile;
    const int nt = min(tile, ccap - j0);  // chunks of this tile
    const int c0 = b * ccap + j0;
    const bool valid = tid < nt;
    const int c = c0 + (valid ? tid : 0);
    if (tid == 0) {
      s_lo = 0xffffffffu;
      s_hi = 0u;
    }

    // this chunk's table: left-justified clamped limits in registers,
    // the bases in this thread's shared column
    const int t = min(max(a.tab[c], 0), a.ntab - 1);
    int lj[LMAX + 1];
    lj[0] = 0;
#pragma unroll
    for (int l = 1; l <= LMAX; ++l) {
      if (l <= L) {
        const int v = a.lim[t * (L + 1) + l];
        lj[l] = min(max(v, 0), 1 << l) << (L - l);
        base_s[l * tile + tid] = a.base[t * (L + 1) + l];
      } else {
        lj[l] = 0;
      }
    }

    // packed, a short L and one table for the whole tile: the block
    // classifies every L-bit window once into a table (kept while the
    // next tiles use the same one), and a step is one shared-memory
    // read instead of L compares
    bool use_lut = false;
    if (may_lut) {
      const int tf = min(max(a.tab[c0], 0), a.ntab - 1);
      use_lut = __syncthreads_and(t == tf);
      if (use_lut && tf != lut_tab) {
        for (int win = tid; win < (1 << L); win += tile) {
          int ln, ci;
          classify<LT>(win, lj, base_col, tile, L, ln, ci);
          lut[win] = static_cast<uint16_t>((min(max(ci, 0), 255) << 8) | ln);
        }
        lut_tab = tf;
      }
    }

    const uint32_t start = static_cast<uint32_t>(a.offs[c]);
    const int64_t end =
        min(static_cast<int64_t>(a.tbits[b]),
            static_cast<int64_t>(start) + static_cast<int64_t>(C) * L);
    const bool act = valid && static_cast<int64_t>(start) < end;
    __syncthreads();
    if (act) {
      atomicMin(&s_lo, start);
      atomicMax(&s_hi, static_cast<unsigned>(end + L));
    }
    __syncthreads();

    // the span of the tile's active chunks, from a 16-byte boundary
    const unsigned lo = s_lo, hi = s_hi;
    const int wlo = static_cast<int>(lo >> 5);
    const int mis =
        static_cast<int>((reinterpret_cast<uintptr_t>(w + wlo) >> 2) & 3u);
    const int wbase = wlo - mis;  // stage[0] is stream word wbase (>= -3)
    const int64_t span =
        hi != 0u ? static_cast<int64_t>((hi - 1u) >> 5) - wbase + 1 : 0;
    const bool use_stage = hi != 0u && span <= tile * kStageWords;
    const int nst =
        use_stage ? static_cast<int>((span + 3) & ~int64_t{3}) : 0;
    for (int g = 4 * tid; g < nst; g += 4 * tile) {
      const int s = wbase + g;
      uint4 v;
      if (s >= 0 && s + 3 < a.nwords) {
        v = *reinterpret_cast<const uint4*>(w + s);
      } else {
        v.x = s >= 0 && s < a.nwords ? w[s] : 0u;
        v.y = s + 1 >= 0 && s + 1 < a.nwords ? w[s + 1] : 0u;
        v.z = s + 2 >= 0 && s + 2 < a.nwords ? w[s + 2] : 0u;
        v.w = s + 3 >= 0 && s + 3 < a.nwords ? w[s + 3] : 0u;
      }
      *reinterpret_cast<uint4*>(stage + g) = v;
    }
    __syncthreads();

    const StageReader srd{stage, nst - 1};
    const int w0 = static_cast<int>(start >> 5);
    const int sh = static_cast<int>(start & 31u);
    const int left = act ? static_cast<int>(end - start) : 0;
    WalkState st = {};
    if (act)
      st = use_stage ? walk_begin(srd, w0 - wbase, sh, left)
                     : walk_begin(grd, w0, sh, left);

    for (int s0 = 0; s0 < C; s0 += kSlab) {
      const int S = min(kSlab, C - s0);
      const int sq = kPacked ? S / 4 : S;  // words of this slab a row
      if (act) {
        if (kPacked && use_lut) {
          if (use_stage)
            walk_slab<LT, kPacked, true>(st, srd, lj, base_col, lut, tile, L,
                                         S, row);
          else
            walk_slab<LT, kPacked, true>(st, grd, lj, base_col, lut, tile, L,
                                         S, row);
        } else if (use_stage) {
          walk_slab<LT, kPacked, false>(st, srd, lj, base_col, lut, tile, L,
                                        S, row);
        } else {
          walk_slab<LT, kPacked, false>(st, grd, lj, base_col, lut, tile, L,
                                        S, row);
        }
      } else if (valid) {
        for (int k = 0; k < sq; ++k) row[k] = 0;
      }
      __syncthreads();
      int32_t* dst =
          a.out + static_cast<size_t>(c0) * Q + (kPacked ? s0 / 4 : s0);
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
      __syncthreads();
    }
  }
}

template <int LT, bool kPacked>
int launch(const WalkArgs& a, int tile, cudaStream_t stream) {
  const int ccap = a.nsub / a.nstreams;
  const int tiles = (ccap + tile - 1) / tile;
  const int blocks = a.nstreams * ((tiles + a.reps - 1) / a.reps);
  const int bytes =
      4 * tile * (kStageWords + kMaxLen + 1 + row_stride(a.chunk_syms, kPacked)) +
      (kPacked && lut_fits(a.L, tile) ? 2 << a.L : 0);
  auto* kern = huffman_walk_kernel<LT, kPacked>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<blocks, tile, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPacked>
int launch_len(const WalkArgs& a, int tile, cudaStream_t stream) {
  if (a.L == 12) return launch<12, kPacked>(a, tile, stream);
  if (a.L == 15) return launch<15, kPacked>(a, tile, stream);
  return launch<0, kPacked>(a, tile, stream);
}

// chunks a tile: 128 (the only tile whose threads can share a 2^12-entry
// window table's build) once such tiles fill the card, 32 while most SMs
// would idle.  chip_smoke.py sweeps the tiles at both shapes: 7,032
// chunks take the same time at every tile, 786,432 a third less at 128.
int auto_tile(int nsub) { return nsub >= 32 * 1024 ? 128 : 32; }

// tiles a block: more than one only to spread a window table's build,
// and only while the blocks still fill the card several times over
int auto_reps(int nsub, int tile, bool lut) {
  return lut && nsub / tile >= 4096 ? 4 : 1;
}

}  // namespace

// tile = chunks a block (32, 64 or 128; 0 picks from the shape).  A
// packed walk with L <= 12 and at most 32 window-table entries a thread
// builds the table where a tile has one code table (lut_fits), and a
// block then walks auto_reps consecutive tiles of its stream.
extern "C" int tplc_huffman_walk(const void* words, int nstreams, int nwords,
                                 const void* tbits, const void* offs, int nsub,
                                 const void* lim, const void* base, int ntab,
                                 const void* tab, void* out, int chunk_syms,
                                 int L, int packed, int tile, void* stream) {
  if (L < 1 || L > kMaxLen || chunk_syms < 0 || chunk_syms > (1 << 20) ||
      chunk_syms % (packed ? 4 : 2) != 0 || nstreams < 1 ||
      nsub % nstreams != 0 || ntab < 1 ||
      (tile != 0 && tile != 32 && tile != 64 && tile != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsub == 0 || chunk_syms == 0) return static_cast<int>(cudaGetLastError());
  if (tile == 0) tile = auto_tile(nsub);
  const int reps = auto_reps(nsub, tile, packed && lut_fits(L, tile));
  const WalkArgs a = {static_cast<const uint32_t*>(words),
                      static_cast<const int32_t*>(tbits),
                      static_cast<const int32_t*>(offs),
                      static_cast<const int32_t*>(lim),
                      static_cast<const int32_t*>(base),
                      static_cast<const int32_t*>(tab),
                      static_cast<int32_t*>(out),
                      nstreams, nwords, nsub, ntab, chunk_syms, L, reps};
  auto* s = static_cast<cudaStream_t>(stream);
  return packed ? launch_len<true>(a, tile, s) : launch_len<false>(a, tile, s);
}
