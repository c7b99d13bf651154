// K8 — whole-group canonical Huffman walk, flat form, for Hopper (sm_90a).
//
// Replaces tpulc/codecs/huffman/pallas_decode.py:
// decode_canonical_indices_flat (_kernel_flat, pallas_decode.py:426-513),
// the decode that TPULC_HUFF_KERNEL=flat selects.  One launch decodes
// every chunk of a block group.  Chunk c of stream b = c / (nsub / B)
// starts at bit offs[c] (read as uint32) and walks chunk_syms steps while
// its bits_left[c] > 0; its table is TABLE tile c / kTableTile's
// left-justified limits lj[l] and bases base[l], used as given.  Per step:
//   - window = the next L bits; length = 1 + sum_{l<L} [win >= lj[l]]
//     (on a canonical table the left-justified regions are nested, so the
//     first-hit chain of K3 becomes a monotone count);
//   - valid iff win < lj[L]; else length 1, index 0;
//   - index = base[length] + (win >> (L - length)), summed in 64 bits;
//   - emit while bits_left > 0, then bits_left -= length;
//   - packed output: byte k of word q is clip(index, 0, 255) of symbol
//     4q+k, little-endian.
// Bits past a stream's W words read as zero.  The wrapper and the plain
// PyTorch version live in tpulc_torch/codecs/huffman/decode_kernels.py.
//
// Bound on the H100: bytes at the huffman codec's shape (59 MB of stream
// in, 100 MB of packed ranks out), as K3 packed, whose walk this is
// (csrc/huffman_walk.cuh): the tile's bit span staged in shared memory
// by 16-byte loads, the reservoir read one word ahead from there, the
// symbols packed into a shared output tile written out with 16-byte
// stores.  What K8's contract changes:
//   - a chunk's end is start + min(bits_left, chunk_syms * L), in 64 bits
//     (start may lie anywhere in uint32, bits_left is any int32); a chunk
//     with bits_left <= 0 is never active, counts for no span and emits
//     zeros; a start past the stream reads zeros;
//   - a block tile (32, 64 or 128 chunks, K3's auto_tile) lies inside one
//     128-chunk table tile, because each stream's chunk count is a
//     multiple of 128, so a block tile always has one table.  Where the
//     2^L entries fit (lut_fits: L <= 12 at a 128-chunk block tile) the
//     block builds K3's window table of (clipped index << 8 | length) by
//     the count rule, and keeps
//     it across the tiles it walks while the next table's 2(L+1) values
//     equal the ones it holds (one value a thread, __syncthreads_and); at
//     the huffman codec's shape the 64 tiles of a stream share one table.
//     Otherwise a step makes the L-1 compares of the count rule, limits in
//     registers (INT_MAX at and past L, so the generic build needs no
//     length test) and bases in the thread's shared column.
// The TPU's 128-byte-row gather and in-row bit position (gather_rows,
// pallas_decode.py:585-615) are a v5e HBM trick and are not carried over.

#include <climits>

#include "huffman_walk.cuh"

namespace {

using namespace walk;

constexpr int kTableTile = 128;  // chunks a table = TILE in decode_kernels.py

struct FlatArgs {
  const uint32_t* words;
  const int32_t* offs;
  const int32_t* bits_left;
  const int32_t* lj;
  const int32_t* base;
  int32_t* out;
  int nstreams, nwords, nsub, chunk_syms, L;
  int reps;  // consecutive tiles of a stream a block walks
};

template <int LT>
__global__ void huffman_flat_kernel(const FlatArgs a) {
  constexpr int LMAX = LT ? LT : kMaxLen;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned s_lo, s_hi;
  __shared__ int held[2 * (kMaxLen + 1)];  // the window table's lj, base
  const int tile = blockDim.x;
  const int tid = threadIdx.x;
  const int L = LT ? LT : a.L;
  const int C = a.chunk_syms;
  const int Q = C / 4;  // words of an output row
  const int stride = row_stride(C, true);
  uint32_t* stage = smem;
  int32_t* base_s = reinterpret_cast<int32_t*>(smem + tile * kStageWords);
  int32_t* otile = base_s + (kMaxLen + 1) * tile;
  uint16_t* lut = reinterpret_cast<uint16_t*>(otile + tile * stride);
  int32_t* row = otile + tid * stride;
  const int32_t* base_col = base_s + tid;
  const bool out16 =
      (reinterpret_cast<uintptr_t>(a.out) & 15u) == 0 && Q % 4 == 0;
  const bool use_lut = lut_fits(L, tile);
  const int nheld = 2 * (L + 1);

  const BlockTiles bt(a.nsub, a.nstreams, tile, a.reps);
  const uint32_t* w = a.words + static_cast<size_t>(bt.b) * a.nwords;
  const GlobalReader grd{w, a.nwords};
  int lut_tt = -1;  // the table tile the window table was built from

  for (int j = bt.jfirst; j < bt.jend; ++j) {
    const int j0 = j * tile;
    const int nt = min(tile, bt.ccap - j0);
    const int c0 = bt.b * bt.ccap + j0;
    const bool valid = tid < nt;
    const int c = c0 + (valid ? tid : 0);

    // the tile's table: limits in registers, bases in the shared columns
    const int tt = c0 / kTableTile;
    const int32_t* ljt = a.lj + tt * (L + 1);
    const int32_t* bst = a.base + tt * (L + 1);
    int lj[LMAX + 1];
    lj[0] = 0;
#pragma unroll
    for (int l = 1; l <= LMAX; ++l) {
      lj[l] = l < L ? ljt[l] : INT_MAX;
      if (l <= L) base_s[l * tile + tid] = bst[l];
    }
    const int ljL = ljt[L];

    if (use_lut && tt != lut_tt) {
      // keep the window table when this table's values are the ones it
      // was built from
      const int v = tid < nheld ? (tid <= L ? ljt[tid] : bst[tid - L - 1])
                                : 0;
      const bool same = __syncthreads_and(
          lut_tt >= 0 && (tid >= nheld || v == held[tid]));
      if (!same) {
        if (tid < nheld) held[tid] = v;
        build_lut<LT, true>(lut, lj, ljL, base_col, tile, L, tid);
      }
      lut_tt = tt;
    }

    const uint32_t start = static_cast<uint32_t>(a.offs[c]);
    const int bl = a.bits_left[c];
    const bool act = valid && bl > 0;
    const int64_t end =
        static_cast<int64_t>(start) +
        min(static_cast<int64_t>(bl), static_cast<int64_t>(C) * L);
    const Span sp = stage_span(stage, s_lo, s_hi, w, a.nwords, act,
                               start >> 5, act ? span_end(end, L) : 0u, tile,
                               tid);

    const StageReader srd{stage, sp.nst - 1};
    const int w0 = static_cast<int>(start >> 5);
    const int sh = static_cast<int>(start & 31u);
    WalkState st = {};
    if (act)
      st = sp.staged ? walk_begin(srd, w0 - sp.wbase, sh, bl)
                     : walk_begin(grd, w0, sh, bl);

    for (int s0 = 0; s0 < C; s0 += kSlab) {
      const int S = min(kSlab, C - s0);
      const int sq = S / 4;
      if (act) {
        if (use_lut) {
          if (sp.staged)
            walk_slab<LT, true, true, true>(st, srd, lj, ljL, base_col, lut,
                                            tile, L, S, row);
          else
            walk_slab<LT, true, true, true>(st, grd, lj, ljL, base_col, lut,
                                            tile, L, S, row);
        } else if (sp.staged) {
          walk_slab<LT, true, false, true>(st, srd, lj, ljL, base_col, lut,
                                           tile, L, S, row);
        } else {
          walk_slab<LT, true, false, true>(st, grd, lj, ljL, base_col, lut,
                                           tile, L, S, row);
        }
      } else if (valid) {
        for (int k = 0; k < sq; ++k) row[k] = 0;
      }
      __syncthreads();
      write_tile(a.out + static_cast<size_t>(c0) * Q + s0 / 4, otile, nt, sq,
                 Q, stride, out16, tile, tid);
      __syncthreads();
    }
  }
}

template <int LT>
int launch(const FlatArgs& a, int tile, cudaStream_t stream) {
  const int bytes =
      4 * tile * (kStageWords + kMaxLen + 1 + row_stride(a.chunk_syms, true)) +
      (lut_fits(a.L, tile) ? 2 << a.L : 0);
  return launch_walk(huffman_flat_kernel<LT>, a,
                     walk_blocks(a.nsub, a.nstreams, tile, a.reps), tile,
                     bytes, stream);
}

}  // namespace

// The tile and the tiles a block walks are K3's (auto_tile, auto_reps).
extern "C" int tplc_huffman_walk_flat(const void* words, int nstreams,
                                      int nwords, const void* offs,
                                      const void* bits_left, int nsub,
                                      const void* lj, const void* base,
                                      void* out, int chunk_syms, int L,
                                      void* stream) {
  if (L < 1 || L > kMaxLen || chunk_syms < 0 || chunk_syms > (1 << 20) ||
      chunk_syms % 4 != 0 || nstreams < 1 || nsub % nstreams != 0 ||
      (nsub / nstreams) % kTableTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsub == 0 || chunk_syms == 0) return static_cast<int>(cudaGetLastError());
  const int tile = auto_tile(nsub);
  const FlatArgs a = {static_cast<const uint32_t*>(words),
                      static_cast<const int32_t*>(offs),
                      static_cast<const int32_t*>(bits_left),
                      static_cast<const int32_t*>(lj),
                      static_cast<const int32_t*>(base),
                      static_cast<int32_t*>(out),
                      nstreams, nwords, nsub, chunk_syms, L,
                      auto_reps(nsub, tile, lut_fits(L, tile))};
  auto* s = static_cast<cudaStream_t>(stream);
  if (L == 12) return launch<12>(a, tile, s);
  if (L == 15) return launch<15>(a, tile, s);
  return launch<0>(a, tile, s);
}
