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
// The output is step-major int32[chunk_syms, nsub], as the Pallas
// out_shape is; the wrapper returns the [nsub, chunk_syms] view.  The
// wrapper and the plain PyTorch version live in
// tpulc_torch/codecs/huffman/decode_kernels.py.
//
// Bound on the H100: bytes.  At the huffman codec's shape (786,432 chunks
// of 128) the output alone is 402.7 MB of int32 indices, against 59 MB of
// stream read.  The design is K3's walk (csrc/huffman_walk.cuh): a block
// stages its tile's bit span in shared memory and every thread's
// reservoir refills from there one word ahead, so no step waits for a
// global load.  What differs:
//   - no shared output tile: at step s the tile's threads store their
//     indices to out[s * nsub + c0 .. c0 + nt), neighbouring int32s, so a
//     warp writes whole 128-byte lines straight from the walk.  A chunk
//     that is never active walks too, from an empty state that never
//     reads a word, so that its zeros join the warp's stores;
//   - the index is an unclipped int32 (a hostile table's bases are any
//     int32), so K3's 16-bit (clipped index, length) window table cannot
//     hold it.  With one table for the tile, where the 2^L entries fit
//     (lut_fits: L <= 12 at a 128-chunk tile), the block builds a table
//     of LENGTHS alone (0 where no length matches) by the first-hit rule,
//     and a step reads one byte of it and adds the base of that length
//     from the thread's shared column to the window's top bits.  At
//     786,432 chunks of 128 this took 0.2048 / 0.2072 ms on the device
//     against 0.2641 / 0.2641 for K3's L compares on an H100 (PERF.md
//     section 6), so the compares remain only where the table does
//     not fit or the tile's tables differ.

#include "huffman_walk.cuh"

namespace {

using namespace walk;

// the state of a chunk that never walks: it emits zeros and, with a full
// reservoir that never drains, never reads a word
__device__ __forceinline__ WalkState walk_idle() {
  WalkState st;
  st.buf = 0;
  st.nextw = 0;
  st.nav = 64;
  st.fidx = 0;
  st.left = 0;
  return st;
}

// S steps (even) of one chunk, step s stored at o[s * nsub] where
// `store`.  kLut: `lens` is the 2^L table of code lengths (0: no match).
template <int LT, bool kLut, class Reader>
__device__ __forceinline__ void walk_steps(
    WalkState& st, const Reader& rd, const int (&lj)[(LT ? LT : kMaxLen) + 1],
    const int32_t* __restrict__ base_col, const uint8_t* __restrict__ lens,
    int tile, int L, int S, int32_t* __restrict__ o, size_t nsub,
    bool store) {
  for (int p = 0; p < S; p += 2) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 0) refill(st, rd);
      const int win = static_cast<int>(st.buf >> (64 - L));
      int ln, ci;
      if (kLut) {
        const int e = lens[win];
        ln = e ? e : 1;
        ci = e ? static_cast<int>(static_cast<unsigned>(base_col[e * tile]) +
                                  static_cast<unsigned>(win >> (L - e)))
               : 0;
      } else {
        classify<LT>(win, lj, base_col, tile, L, ln, ci);
      }
      if (store) *o = st.left > 0 ? ci : 0;
      o += nsub;
      advance(st, ln);
    }
  }
}

template <int LT>
__global__ void huffman_v1_kernel(const WalkArgs a) {
  constexpr int LMAX = LT ? LT : kMaxLen;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned s_lo, s_hi;
  const int tile = blockDim.x;
  const int tid = threadIdx.x;
  const int L = LT ? LT : a.L;
  const int C = a.chunk_syms;
  uint32_t* stage = smem;
  int32_t* base_s = reinterpret_cast<int32_t*>(smem + tile * kStageWords);
  uint8_t* lens = reinterpret_cast<uint8_t*>(base_s + (kMaxLen + 1) * tile);
  const int32_t* base_col = base_s + tid;
  const bool may_lut = lut_fits(L, tile);

  const BlockTiles bt(a.nsub, a.nstreams, tile, a.reps);
  const uint32_t* w = a.words + static_cast<size_t>(bt.b) * a.nwords;
  const GlobalReader grd{w, a.nwords};
  int lut_tab = -1;  // the table index the length table holds

  for (int j = bt.jfirst; j < bt.jend; ++j) {
    const int j0 = j * tile;
    const int nt = min(tile, bt.ccap - j0);
    const int c0 = bt.b * bt.ccap + j0;
    const bool valid = tid < nt;
    const int c = c0 + (valid ? tid : 0);

    const int t = min(max(a.tab[c], 0), a.ntab - 1);
    int lj[LMAX + 1];
    load_table<LT>(a.lim, a.base, t, L, tile, tid, lj, base_s);

    bool use_lut = false;
    if (may_lut) {
      const int tf = min(max(a.tab[c0], 0), a.ntab - 1);
      use_lut = __syncthreads_and(t == tf);
      if (use_lut && tf != lut_tab) {
        for (int win = tid; win < (1 << L); win += tile) {
          const unsigned hits = first_hits<LT>(win, lj);
          lens[win] = static_cast<uint8_t>(hits ? __ffs(hits) : 0);
        }
        lut_tab = tf;
      }
    }

    const uint32_t start = static_cast<uint32_t>(a.offs[c]);
    const int64_t end =
        min(static_cast<int64_t>(a.tbits[bt.b]),
            static_cast<int64_t>(start) + static_cast<int64_t>(C) * L);
    const bool act = valid && static_cast<int64_t>(start) < end;
    const Span sp = stage_span(stage, s_lo, s_hi, w, a.nwords, act,
                               start >> 5, act ? span_end(end, L) : 0u, tile,
                               tid);

    const StageReader srd{stage, sp.nst - 1};
    const int w0 = static_cast<int>(start >> 5);
    const int sh = static_cast<int>(start & 31u);
    const int left = act ? static_cast<int>(end - start) : 0;
    int32_t* o = a.out + c;
    const size_t nsub = static_cast<size_t>(a.nsub);
    if (sp.staged) {
      WalkState st = act ? walk_begin(srd, w0 - sp.wbase, sh, left)
                         : walk_idle();
      if (use_lut)
        walk_steps<LT, true>(st, srd, lj, base_col, lens, tile, L, C, o,
                             nsub, valid);
      else
        walk_steps<LT, false>(st, srd, lj, base_col, lens, tile, L, C, o,
                              nsub, valid);
    } else {
      WalkState st = act ? walk_begin(grd, w0, sh, left) : walk_idle();
      if (use_lut)
        walk_steps<LT, true>(st, grd, lj, base_col, lens, tile, L, C, o,
                             nsub, valid);
      else
        walk_steps<LT, false>(st, grd, lj, base_col, lens, tile, L, C, o,
                              nsub, valid);
    }
    __syncthreads();  // the stage and the tables are the next tile's
  }
}

template <int LT>
int launch(const WalkArgs& a, int tile, cudaStream_t stream) {
  const int bytes = 4 * tile * (kStageWords + kMaxLen + 1) +
                    (lut_fits(a.L, tile) ? 1 << a.L : 0);
  return launch_walk(huffman_v1_kernel<LT>, a,
                     walk_blocks(a.nsub, a.nstreams, tile, a.reps), tile,
                     bytes, stream);
}

}  // namespace

// The tile and the tiles a block walks are K3's (auto_tile, auto_reps).
extern "C" int tplc_huffman_walk_v1(const void* words, int nstreams,
                                    int nwords, const void* tbits,
                                    const void* offs, int nsub,
                                    const void* lim, const void* base,
                                    int ntab, const void* tab, void* out,
                                    int chunk_syms, int L, void* stream) {
  if (L < 1 || L > kMaxLen || chunk_syms < 0 || chunk_syms > (1 << 20) ||
      chunk_syms % 2 != 0 || nstreams < 1 || nsub % nstreams != 0 ||
      ntab < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsub == 0 || chunk_syms == 0) return static_cast<int>(cudaGetLastError());
  const int tile = auto_tile(nsub);
  const WalkArgs a = {static_cast<const uint32_t*>(words),
                      static_cast<const int32_t*>(tbits),
                      static_cast<const int32_t*>(offs),
                      static_cast<const int32_t*>(lim),
                      static_cast<const int32_t*>(base),
                      static_cast<const int32_t*>(tab),
                      static_cast<int32_t*>(out),
                      nstreams, nwords, nsub, ntab, chunk_syms, L,
                      auto_reps(nsub, tile, lut_fits(L, tile))};
  auto* s = static_cast<cudaStream_t>(stream);
  if (L == 12) return launch<12>(a, tile, s);
  if (L == 15) return launch<15>(a, tile, s);
  return launch<0>(a, tile, s);
}
