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
// walks from shared memory only (the core is csrc/huffman_walk.cuh,
// shared with K7 and K8):
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

#include "huffman_walk.cuh"

namespace {

using namespace walk;

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

  const BlockTiles bt(a.nsub, a.nstreams, tile, a.reps);
  const uint32_t* w = a.words + static_cast<size_t>(bt.b) * a.nwords;
  const GlobalReader grd{w, a.nwords};
  int lut_tab = -1;  // the table index the window table holds

  for (int j = bt.jfirst; j < bt.jend; ++j) {
    const int j0 = j * tile;
    const int nt = min(tile, bt.ccap - j0);  // chunks of this tile
    const int c0 = bt.b * bt.ccap + j0;
    const bool valid = tid < nt;
    const int c = c0 + (valid ? tid : 0);

    // this chunk's table: left-justified clamped limits in registers,
    // the bases in this thread's shared column
    const int t = min(max(a.tab[c], 0), a.ntab - 1);
    int lj[LMAX + 1];
    load_table<LT>(a.lim, a.base, t, L, tile, tid, lj, base_s);

    // packed, a short L and one table for the whole tile: the block
    // classifies every L-bit window once into a table (kept while the
    // next tiles use the same one), and a step is one shared-memory
    // read instead of L compares
    bool use_lut = false;
    if (may_lut) {
      const int tf = min(max(a.tab[c0], 0), a.ntab - 1);
      use_lut = __syncthreads_and(t == tf);
      if (use_lut && tf != lut_tab) {
        build_lut<LT, false>(lut, lj, 0, base_col, tile, L, tid);
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
    WalkState st = {};
    if (act)
      st = sp.staged ? walk_begin(srd, w0 - sp.wbase, sh, left)
                     : walk_begin(grd, w0, sh, left);

    for (int s0 = 0; s0 < C; s0 += kSlab) {
      const int S = min(kSlab, C - s0);
      const int sq = kPacked ? S / 4 : S;  // words of this slab a row
      if (act) {
        if (kPacked && use_lut) {
          if (sp.staged)
            walk_slab<LT, kPacked, true, false>(st, srd, lj, 0, base_col, lut,
                                                tile, L, S, row);
          else
            walk_slab<LT, kPacked, true, false>(st, grd, lj, 0, base_col, lut,
                                                tile, L, S, row);
        } else if (sp.staged) {
          walk_slab<LT, kPacked, false, false>(st, srd, lj, 0, base_col, lut,
                                               tile, L, S, row);
        } else {
          walk_slab<LT, kPacked, false, false>(st, grd, lj, 0, base_col, lut,
                                               tile, L, S, row);
        }
      } else if (valid) {
        for (int k = 0; k < sq; ++k) row[k] = 0;
      }
      __syncthreads();
      write_tile(a.out + static_cast<size_t>(c0) * Q + (kPacked ? s0 / 4 : s0),
                 otile, nt, sq, Q, stride, out16, tile, tid);
      __syncthreads();
    }
  }
}

template <int LT, bool kPacked>
int launch(const WalkArgs& a, int tile, cudaStream_t stream) {
  const int bytes =
      4 * tile * (kStageWords + kMaxLen + 1 + row_stride(a.chunk_syms, kPacked)) +
      (kPacked && lut_fits(a.L, tile) ? 2 << a.L : 0);
  return launch_walk(huffman_walk_kernel<LT, kPacked>, a,
                     walk_blocks(a.nsub, a.nstreams, tile, a.reps), tile,
                     bytes, stream);
}

template <bool kPacked>
int launch_len(const WalkArgs& a, int tile, cudaStream_t stream) {
  if (a.L == 12) return launch<12, kPacked>(a, tile, stream);
  if (a.L == 15) return launch<15, kPacked>(a, tile, stream);
  return launch<0, kPacked>(a, tile, stream);
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
