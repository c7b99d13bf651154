// MTF kernels for Hopper (sm_90a): K1 recency, the start tables between
// K1 and K2, K2 encode lockstep and K4 decode lockstep (both a group of
// lanes a chunk, the table in registers).
// Plain C entry points, loaded with ctypes by tpulc_torch/cuda_lib.py;
// wrappers and plain PyTorch versions live in
// tpulc_torch/primitives/mtf_kernels.py.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kAlpha = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// ---------------------------------------------------------------------
// K1 — replaces tpulc/primitives/mtf_pallas.py:mtf_recency_pallas
// (_recency_kernel): for each chunk, the last step index of every
// symbol, -1 where absent (symbols outside [0, 256) are ignored).
// int32[nchunks, C] -> int32[nchunks, 256]; and, where the caller asks,
// the start tables' tile maxima in the same pass (below).
//
// Bound on the H100: bytes.  A 128-step chunk is 512 B of symbols in
// and a 1 KB row out (314.6 MB, 0.094 ms, at a 25 MiB block's 204,800
// chunks), the tile maxima 1 KB a tile more; there is almost no
// compute.  Design: a block owns one start-table tile of T chunks (the
// tile the start tables take for this chunk count, so that its maxima
// land where they look for them), and its kRecWarps warps take the
// tile's chunks in turn, a warp a chunk.  Lane i reads steps i, i+32,
// ...: each 32-step round is one coalesced 128-byte load, and the next
// batch of kRecRounds rounds (the warp's next chunk, for C <= 128) is in
// flight while the current one is reduced.  After a BWT, long runs of
// one symbol are the rule, and one shared-memory atomicMax a symbol
// serialises the lanes of a run on one address.  Here, in each round,
// __match_any_sync names the lanes that hold the same symbol and only
// the highest of them (the last step) stores its step into the warp's
// 256-entry row in shared memory; rounds go in ascending step order, so
// the last store is the last occurrence.  (The same kernel with an
// atomicMax a symbol in place of the match took 7-22 % longer at both
// of chip_smoke.py's shapes: PERF.md.)  The row leaves as two 16-byte
// stores a lane (a warp stores 512 contiguous bytes at a time) and is
// reset to -1 for the warp's next chunk.  The tile maxima: each lane keeps the running max
// of c*C + step over the 8 entries of its stores, the warps merge these
// through shared memory at the end of the tile, and the block writes
// part[s * ntiles + tile] as the start tables' first pass
// (mtf_tile_max_kernel) would, without their reading the rows again.
// ---------------------------------------------------------------------
constexpr int kRecWarps = 8;
constexpr int kRecThreads = 32 * kRecWarps;
constexpr int kRecRounds = 4;  // 32-step rounds a batch
constexpr int kRecBatch = 32 * kRecRounds;
static_assert(kRecThreads == kAlpha, "the merge takes a thread a symbol");

// batch q of row p (C steps): register r of lane i holds step
// kRecBatch*q + 32*r + i, -1 past the row's end
__device__ __forceinline__ void rec_batch(int32_t (&v)[kRecRounds],
                                          const int32_t* __restrict__ p,
                                          int q, int C, int lane) {
#pragma unroll
  for (int r = 0; r < kRecRounds; ++r) {
    const int t = kRecBatch * q + 32 * r + lane;
    v[r] = t < C ? p[t] : -1;
  }
}

__device__ __forceinline__ int32_t rec_key(int32_t rec, int base) {
  return rec >= 0 ? rec + base : -1;
}

__global__ void __launch_bounds__(kRecThreads)
    mtf_recency_kernel(const int32_t* __restrict__ syms,
                       int32_t* __restrict__ out, int32_t* __restrict__ part,
                       int nchunks, int C, int T, int ntiles) {
  __shared__ __align__(16) int32_t rows[kRecWarps][kAlpha];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* last = rows[warp];
  int4* row = reinterpret_cast<int4*>(last);
  const int4 none = make_int4(-1, -1, -1, -1);
  row[lane] = none;
  row[lane + 32] = none;
  const int c0 = blockIdx.x * T;
  const int c1 = min(c0 + T, nchunks);
  const int nb = max((C + kRecBatch - 1) / kRecBatch, 1);
  // this lane's tile maxima: entries 4*lane .. +3 and 128 + 4*lane .. +3
  int32_t m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = -1;
  int c = c0 + warp, q = 0;
  int32_t cur[kRecRounds], nxt[kRecRounds];
  if (c < c1) rec_batch(cur, syms + static_cast<size_t>(c) * C, 0, C, lane);
  __syncwarp();
  while (c < c1) {  // uniform in the warp
    // the next batch: this chunk's next, or the warp's next chunk's first
    const int qn = q + 1 < nb ? q + 1 : 0;
    const int cn = qn == 0 ? c + kRecWarps : c;
    if (cn < c1)
      rec_batch(nxt, syms + static_cast<size_t>(cn) * C, qn, C, lane);
#pragma unroll
    for (int r = 0; r < kRecRounds; ++r) {
      const int32_t s = cur[r];
      const bool live = static_cast<unsigned>(s) < kAlpha;
      const unsigned peers = __match_any_sync(kFullMask, s);
      if (live && 31 - __clz(peers) == lane)
        last[s] = kRecBatch * q + 32 * r + lane;
      __syncwarp();  // orders this round's stores before the next's
    }
    if (qn == 0) {  // chunk c is done
      const int4 a = row[lane], b = row[lane + 32];
      int4* o = reinterpret_cast<int4*>(out + static_cast<size_t>(c) * kAlpha);
      o[lane] = a;
      o[lane + 32] = b;
      row[lane] = none;
      row[lane + 32] = none;
      if (part != nullptr) {  // then nchunks * C < 2^31
        const int base = c * C;
        m[0] = max(m[0], rec_key(a.x, base));
        m[1] = max(m[1], rec_key(a.y, base));
        m[2] = max(m[2], rec_key(a.z, base));
        m[3] = max(m[3], rec_key(a.w, base));
        m[4] = max(m[4], rec_key(b.x, base));
        m[5] = max(m[5], rec_key(b.y, base));
        m[6] = max(m[6], rec_key(b.z, base));
        m[7] = max(m[7], rec_key(b.w, base));
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < kRecRounds; ++r) cur[r] = nxt[r];
    c = cn;
    q = qn;
  }
  if (part != nullptr) {  // uniform in the block
    row[lane] = make_int4(m[0], m[1], m[2], m[3]);
    row[lane + 32] = make_int4(m[4], m[5], m[6], m[7]);
    __syncthreads();
    const int s = threadIdx.x;
    int32_t v = rows[0][s];
#pragma unroll
    for (int w = 1; w < kRecWarps; ++w) v = max(v, rows[w][s]);
    part[static_cast<size_t>(s) * ntiles + blockIdx.x] = v;
  }
}

// ---------------------------------------------------------------------
// K4 — replaces mtf_pallas.py:mtf_lockstep_pallas (_mtf_kernel): MTF by
// RANK from a start table; emits symbols and the final table.  One body
// serves both serial phases of the decode: the chunk-permutation build
// (table0 == nullptr: the identity is made in registers, and the caller
// passes syms == nullptr) and the symbol walk (table_out == nullptr).
//
// Bound on the H100: bytes at large shapes (a 25 MiB bsc block is
// 204,800 chunks: 1 KB of table and 512 B of ranks in, as much out, per
// chunk), the serial chain of 128 steps a chunk at small ones (a 900 KB
// bz block is 7,032 chunks).  Design: a group of G lanes (32, 16 or 8)
// owns a chunk.  Lane i keeps table positions R*i .. R*i+R-1 (R = 256/G)
// in registers; there is no shared memory.  The table rows arrive and
// leave as 16-byte accesses, the ranks and symbols as runs of
// neighbouring words of the group's lanes.  A step is O(1) whatever the
// rank: the rank is broadcast from the lane that loaded it (so it is
// uniform in the group), the owner lane r / R selects its entry r % R
// and broadcasts the symbol, and every lane shifts its registers by one
// under a compare of its positions with r, taking its neighbour's last
// entry by __shfl_up_sync.  A rank-0 step moves nothing and emits the
// front symbol, and after a BWT most ranks are 0, so such a step is
// never visited: a ballot finds the steps with r > 0, only those are
// walked, and every lane fills its rank-0 outputs with the symbol of the
// last walked step before them.  (Walking every step, and branching
// around a rank-0 step, both lost to this on the card at every lane
// count: PERF.md.)  The TPU's two 128-lane halves and masked reductions
// (mtf_pallas.py:9-17) are gone; table entries stay int32, because the
// plain version moves any int32 value.
// ---------------------------------------------------------------------
constexpr int kDecThreads = 128;
constexpr int kAutoLanes = 32;  // set from the sweep in chip_smoke.py

// 4 consecutive int32 at p[i..i+3] of a row of n: one 16-byte access
// when `vec` (the caller checked alignment), else guarded scalars
__device__ __forceinline__ void load4(int32_t (&v)[4],
                                      const int32_t* __restrict__ p, int i,
                                      int n, bool vec) {
  if (vec && i + 3 < n) {
    const int4 q = *reinterpret_cast<const int4*>(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n ? p[i + k] : 0;
  }
}

__device__ __forceinline__ void store4(const int32_t (&v)[4],
                                       int32_t* __restrict__ p, int i, int n,
                                       bool vec) {
  if (vec && i + 3 < n) {
    *reinterpret_cast<int4*>(p + i) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) p[i + k] = v[k];
  }
}

// the register table of a group of G lanes: lane i holds positions
// R*i .. R*i+R-1 of its chunk's 256-entry table
template <int G>
__device__ __forceinline__ void tab_load(int32_t (&t)[kAlpha / G],
                                         const int32_t* __restrict__ row,
                                         int lane, bool vec) {
  constexpr int R = kAlpha / G;
#pragma unroll
  for (int k = 0; k < R; k += 4) {
    int32_t v[4];
    load4(v, row, R * lane + k, kAlpha, vec);
#pragma unroll
    for (int j = 0; j < 4; ++j) t[k + j] = v[j];
  }
}

template <int G>
__device__ __forceinline__ void tab_identity(int32_t (&t)[kAlpha / G],
                                             int lane) {
  constexpr int R = kAlpha / G;
#pragma unroll
  for (int j = 0; j < R; ++j) t[j] = R * lane + j;
}

template <int G>
__device__ __forceinline__ void tab_store(const int32_t (&t)[kAlpha / G],
                                          int32_t* __restrict__ row, int lane,
                                          bool vec) {
  constexpr int R = kAlpha / G;
#pragma unroll
  for (int k = 0; k < R; k += 4) {
    const int32_t v[4] = {t[k], t[k + 1], t[k + 2], t[k + 3]};
    store4(v, row, R * lane + k, kAlpha, vec);
  }
}

// this lane's entry at in-lane position d (garbage unless 0 <= d < R)
template <int G>
__device__ __forceinline__ int32_t tab_pick(const int32_t (&t)[kAlpha / G],
                                            int d) {
  constexpr int R = kAlpha / G;
  int32_t s = t[0];
#pragma unroll
  for (int j = 1; j < R; ++j)
    if (d == j) s = t[j];
  return s;
}

// move table position r (holding sym) to the front: positions 1..r take
// their left neighbour's entry, position 0 takes sym.  d = r - R*lane.
template <int G>
__device__ __forceinline__ void tab_shift(int32_t (&t)[kAlpha / G], int d,
                                          int32_t sym, int lane,
                                          unsigned mask) {
  constexpr int R = kAlpha / G;
  const int32_t prev = __shfl_up_sync(mask, t[R - 1], 1, G);
#pragma unroll
  for (int j = R - 1; j > 0; --j)
    if (j <= d) t[j] = t[j - 1];
  if (d >= 0) t[0] = lane == 0 ? sym : prev;
}

// one decode step: the symbol at rank r (uniform in the group), moved
// to the front
template <int G>
__device__ __forceinline__ int32_t tab_decode_step(int32_t (&t)[kAlpha / G],
                                                   int r, int lane,
                                                   unsigned mask) {
  constexpr int R = kAlpha / G;
  const int d = r - R * lane;
  const int32_t sym = __shfl_sync(mask, tab_pick<G>(t, d), r / R, G);
  tab_shift<G>(t, d, sym, lane, mask);
  return sym;
}

template <int G>
__global__ void __launch_bounds__(kDecThreads)
    mtf_decode_kernel(const int32_t* __restrict__ table0,
                      const int32_t* __restrict__ ranks,
                      int32_t* __restrict__ syms,
                      int32_t* __restrict__ table_out, int nchunks, int C,
                      int vec_tab) {
  constexpr int R = kAlpha / G;
  const int lane = threadIdx.x & (G - 1);
  const int shift = (threadIdx.x & 31) & ~(G - 1);  // the group's first lane
  const unsigned bits = G == 32 ? kFullMask : (1u << (G & 31)) - 1u;
  const unsigned mask = bits << shift;
  const int grp = (blockIdx.x * kDecThreads + threadIdx.x) / G;
  const bool live = grp < nchunks;
  // lanes past the last chunk walk a copy of it and store nothing, so
  // that every lane of a warp reaches every shuffle
  const size_t c = live ? grp : nchunks - 1;
  int32_t t[R];
  if (table0 != nullptr)
    tab_load<G>(t, table0 + c * kAlpha, lane, vec_tab);
  else
    tab_identity<G>(t, lane);
  const int32_t* in = ranks + c * C;
  int32_t* o = syms != nullptr && live ? syms + c * C : nullptr;
  // a batch is 4 * G steps: register k of lane i holds step G*k + i, so
  // that a load or store of the group is one run of neighbouring words
  for (int s0 = 0; s0 < C; s0 += 4 * G) {
    int32_t rk[4], sy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = s0 + G * k + lane;
      rk[k] = i < C ? min(max(in[i], 0), kAlpha - 1) : 0;
    }
    // rank 0 moves nothing and emits the front symbol, which is the
    // last step's: walk only the steps a ballot finds with rank > 0
    int32_t front = __shfl_sync(mask, t[0], 0, G);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sy[k] = front;
      unsigned todo = (__ballot_sync(mask, rk[k] > 0) >> shift) & bits;
      while (todo != 0u) {
        const int p = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int r = __shfl_sync(mask, rk[k], p, G);
        front = tab_decode_step<G>(t, r, lane, mask);
        if (lane >= p) sy[k] = front;
      }
    }
    if (o != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = s0 + G * k + lane;
        if (i < C) o[i] = sy[k];
      }
    }
  }
  if (table_out != nullptr && live)
    tab_store<G>(t, table_out + c * kAlpha, lane, vec_tab);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int G>
void launch_decode(const int32_t* t0, const int32_t* r, int32_t* s,
                   int32_t* to, int nchunks, int C, cudaStream_t stream) {
  const int per_block = kDecThreads / G;
  const int blocks = (nchunks + per_block - 1) / per_block;
  const int vec_tab = aligned16(t0) && aligned16(to);
  mtf_decode_kernel<G><<<blocks, kDecThreads, 0, stream>>>(
      t0, r, s, to, nchunks, C, vec_tab);
}

// ---------------------------------------------------------------------
// K2 — replaces mtf_pallas.py:mtf_encode_lockstep_pallas
// (_mtf_encode_kernel): MTF by SYMBOL from each chunk's start table;
// emits ranks and the final table.  A symbol's rank is its FIRST
// position in the table (tpulc's XLA step and list.index; its Pallas
// kernel takes the last on a table with duplicates); an absent symbol
// gets rank 0 and overwrites position 0.
//
// Bound on the H100: bytes at large shapes (a 25 MiB bsc block is
// 204,800 chunks: 1 KB of table and 512 B of symbols in, as much out,
// per chunk), the serial chain of 128 steps a chunk at small ones.
// Design: K4's register table.  A warp owns a chunk (32 lanes: builds
// of 16 and 8 lanes were slower at both shapes, PERF.md), lane i keeps
// positions 8i .. 8i+7.  The find compares a lane's 8 entries with the
// symbol and keeps its first hit; a ballot names the first lane with a
// hit and one shuffle brings its index, so the rank is 8*owner + index,
// else 0.  The move is K4's tab_shift with d = rank - 8*lane; with rank
// 0 it writes the symbol into position 0, so the absent symbol needs no
// branch of its own.  After step t-1 the front holds sym[t-1], so step
// t has rank 0 and moves nothing exactly when sym[t] == sym[t-1] (for
// t = 0: when sym[0] == table0[0]).  Symbols arrive strided over the
// warp's lanes, each is compared with its predecessor (a
// __shfl_up_sync, and the last symbol of the register before), a
// ballot marks the steps that differ and only those are walked; every
// other step emits 0.  The TPU's two 128-lane halves and masked
// max-reductions are gone.
// ---------------------------------------------------------------------
constexpr int kEncLanes = 32;
constexpr int kEncR = kAlpha / kEncLanes;

// one encode step of symbol `sym` (uniform in the warp): its rank, and
// the table with that position moved to the front
__device__ __forceinline__ int tab_encode_step(int32_t (&t)[kEncR],
                                               int32_t sym, int lane) {
  int idx = kEncR;  // this lane's first hit, kEncR for none
#pragma unroll
  for (int j = kEncR - 1; j >= 0; --j)
    if (t[j] == sym) idx = j;
  const unsigned hit = __ballot_sync(kFullMask, idx < kEncR);
  const int owner = hit != 0u ? __ffs(hit) - 1 : 0;
  const int at = __shfl_sync(kFullMask, idx, owner);
  const int r = hit != 0u ? kEncR * owner + at : 0;
  tab_shift<kEncLanes>(t, r - kEncR * lane, sym, lane, kFullMask);
  return r;
}

__global__ void __launch_bounds__(kDecThreads)
    mtf_encode_walk_kernel(const int32_t* __restrict__ table0,
                           const int32_t* __restrict__ syms,
                           int32_t* __restrict__ ranks,
                           int32_t* __restrict__ table_out, int nchunks,
                           int C, int vec_tab) {
  constexpr int G = kEncLanes;
  const int lane = threadIdx.x & (G - 1);
  const int grp = (blockIdx.x * kDecThreads + threadIdx.x) / G;
  const bool live = grp < nchunks;
  // lanes past the last chunk walk a copy of it and store nothing
  const size_t c = live ? grp : nchunks - 1;
  int32_t t[kEncR];
  tab_load<G>(t, table0 + c * kAlpha, lane, vec_tab);
  const int32_t* in = syms + c * C;
  int32_t* o = live ? ranks + c * C : nullptr;
  // the symbol at the front before the next step
  int32_t last = __shfl_sync(kFullMask, t[0], 0);
  // a batch is 4 * G steps: register k of lane i holds step G*k + i
  for (int s0 = 0; s0 < C; s0 += 4 * G) {
    int32_t sy[4], rk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = s0 + G * k + lane;
      sy[k] = i < C ? in[i] : 0;
      rk[k] = 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int32_t prev = __shfl_up_sync(kFullMask, sy[k], 1);
      if (lane == 0) prev = last;
      last = __shfl_sync(kFullMask, sy[k], G - 1);
      const bool walk = s0 + G * k + lane < C && sy[k] != prev;
      unsigned todo = __ballot_sync(kFullMask, walk);
      while (todo != 0u) {
        const int p = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int32_t sym = __shfl_sync(kFullMask, sy[k], p);
        const int r = tab_encode_step(t, sym, lane);
        if (lane == p) rk[k] = r;
      }
    }
    if (o != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = s0 + G * k + lane;
        if (i < C) o[i] = rk[k];
      }
    }
  }
  if (live) tab_store<G>(t, table_out + c * kAlpha, lane, vec_tab);
}

// ---------------------------------------------------------------------
// The MTF start tables between K1 and K2 — replaces the XLA stage of
// tpulc/primitives/mtf.py:85-96 (no pallas_call there): K1's rows
// rec[c][s] (the last step of symbol s in chunk c, -1 if absent) ->
// each chunk's start table: with key[c][s] the last global position
// (c'*C + rec[c'][s]) of s over the chunks c' < c, or -2 - s if none,
// the symbols in order of descending key.  The plain version is an
// exclusive torch.cummax over chunks and a stable argsort a row.
//
// Bound on the H100: bytes, K1's rows read once and the tables written
// once (420 MB a 25 MiB block: 0.125 ms; 14.4 MB a bz block: 4.3 us).
// Design: one launch (after a 16-byte memset) over K1's tiles of T
// chunks, a warp a tile, or half of one (split: small blocks, whose
// tiles alone would leave most SMs idle, give each warp T / 2 chunks),
// kStartWarps warps a block.  (The first
// design scanned the maxima in a launch of its own and walked a
// tile with the whole block, a thread a place and two barriers a chunk;
// a Fenwick tree of the maxima built in one launch waited on chains of
// nodes for 11-17 us at a bz block; a thread a symbol and one barrier a
// chunk took ~500-750 ns a chunk.)
// - The tiles' exclusive prefix, each symbol's last position before a
//   tile: the blocks of the first kScanBlocks tickets (an atomic ticket,
//   so that they run before anyone waits on them) scan K1's tile maxima
//   `part` over tiles, a warp a symbol row, kScanBatch chunks of 32 in
//   flight, into the prefix, symbol-major as `part` (a row contiguous,
//   the scanners' stores coalesced; a tile-major prefix, a warp's keys
//   one 1 KB row, took at the picked tile and split 0.0190 device ms
//   against 0.0177-0.0179 at a bz block, 0.0730 against 0.0681-0.0685
//   at an 8 MiB bucket, 0.2270 against 0.1888-0.1901 at a 25 MiB
//   block); every block waits on a count of finished scanners.  The
//   scanners scan before they fold (folding first held the prefix back
//   by the longest fold: at a bz block it was done 7.5 us into the
//   launch).
// - The first table of a warp's chunks, by the warp: its keys are the
//   tile's prefix, raised by the tile's chunks before the warp's part
//   (a step there is above every earlier position; folded kFoldBatch
//   rows at a time before the wait).  A seen symbol's place is the
//   count of seen keys above its own over the compacted list of seen
//   keys, counted as sign bits of differences (compares held up one
//   predicate register ~10 cycles each, ~6 us at a bz tile); an unseen
//   one's is nseen + its rank among the unseen (ballots).
// - Chunk c+1's table from chunk c's, by the warp, with no sort: lane i
//   holds places 32j + i (j < 8).  Each place's symbol reads its step in
//   c from K1's row in shared memory; the seen symbols go to the front,
//   newest first: each writes itself at its step in an inverse map of C
//   entries, which the warp reads back from step C-1 down, 128 steps at
//   once, compacting with ballots, and no further once every seen
//   symbol is found (the entries below were never written); the unseen keep their order behind them, placed by
//   ballot prefix counts; stores that a lane has no use for go to dummy
//   entries rather than under a predicate.  That equals the stable
//   argsort: the keys of symbols seen in c lie in [c*C, c*C + C), above
//   every other key, and the other keys do not change.  No barrier but
//   the warp's; the table leaves from registers, a coalesced 1 KB row.
// - K1's rows arrive by cp.async in a ring of kStartAhead rows a warp,
//   issued before the prefix is waited on.
// Domain (the plain version's on K1's output): each row holds values in
// [-1, C) and each step at most once, so every key is distinct.  Off it
// the kernel reads and writes only inside its arrays.  Without K1's
// maxima (part == nullptr) a first launch computes them into the
// scratch (mtf_tile_max_kernel).
// ---------------------------------------------------------------------
constexpr int kMaxStartChunk = 4096;  // the inverse map's entries
constexpr int kStartTiles[] = {8, 16, 32, 64};
constexpr int kStartWarps = 4;  // tiles a block, a warp each
constexpr int kStartThreads = 32 * kStartWarps;
constexpr int kStartAhead = 8;   // K1 rows a warp's ring holds
constexpr int kScanBlocks = 64;  // the most blocks that scan the maxima
constexpr int kScanBatch = 8;    // 32-tile chunks a scanning warp loads at once
constexpr int kFoldBatch = 8;    // K1 rows a warp folds at once
constexpr int kSplitWarps = 8;   // the most warps an SM that a split gives
constexpr int kMinPart = 4;      // the fewest chunks a warp of a split tile

bool known_tile(int tile) {
  for (int t : kStartTiles)
    if (t == tile) return true;
  return false;
}

// The tile for nchunks chunks: the largest of kStartTiles that still
// leaves 1.5 tiles an SM, else the smallest (-1 if the card does not
// answer).  On an H100, K1 and the start tables together at a bz block
// (7,032 chunks): 0.0255 device ms at 32, 0.0288 at 16, 0.0301 at 64,
// 0.0312 at 8; at a 25 MiB block (204,800): 0.3091 at 64, 0.3216 at 32.
int start_tile(int nchunks) {
  const int sms = sm_count();
  if (sms < 0) return -1;
  constexpr int n = sizeof(kStartTiles) / sizeof(kStartTiles[0]);
  for (int i = n - 1; i > 0; --i)
    if (2 * ((nchunks + kStartTiles[i] - 1) / kStartTiles[i]) >= 3 * sms)
      return kStartTiles[i];
  return kStartTiles[0];
}

// Warps a tile of T chunks: 2 where that keeps the warps at most
// kSplitWarps an SM and leaves at least kMinPart chunks a warp, else 1:
// a warp's first table costs about as much as a few chunks of its
// walk, and a small block's tiles alone would leave most SMs idle (-1
// if the card does not answer).  On an H100 (132 SMs), device ms at 1,
// 2 and 4 warps a tile over three runs: a bz block (220 tiles of 32)
// 0.0244-0.0260, 0.0177-0.0196, 0.0178-0.0192; bsc -e2's 1 MiB bucket
// (256 tiles of 32) 0.0235-0.0249, 0.0189-0.0201, 0.0189-0.0199; an 8
// MiB bucket (1,024 tiles of 64) 0.0679-0.0696, 0.0743-0.0774,
// 0.0742-0.0805.  4 warps won only at bzip2's last block (213 tiles, one
// run: 0.0182-0.0188 against 0.0191-0.0199).
int start_split(int ntiles, int T) {
  const int sms = sm_count();
  if (sms < 0) return -1;
  return T / 2 >= kMinPart && static_cast<long long>(ntiles) * 2 <=
                                  static_cast<long long>(kSplitWarps) * sms
             ? 2
             : 1;
}

__global__ void __launch_bounds__(kAlpha)
    mtf_tile_max_kernel(const int32_t* __restrict__ rec,
                        int32_t* __restrict__ part, int nchunks, int C,
                        int T, int ntiles) {
  const int s = threadIdx.x;
  const int c0 = blockIdx.x * T;
  const int c1 = min(c0 + T, nchunks);
  int32_t m = -1;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    const int32_t r = rec[static_cast<size_t>(c) * kAlpha + s];
    m = max(m, r >= 0 ? r + c * C : -1);
  }
  part[static_cast<size_t>(s) * ntiles + blockIdx.x] = m;
}

// the scratch, int32 words: the ticket and the count of finished
// scanners (4 words, cleared by the memset), the exclusive prefix over
// tiles (256 * ntiles, symbol-major), and, when part == nullptr, K1's tile maxima (256 *
// ntiles, symbol-major as K1 writes them)
struct StartScratch {
  uint32_t* ticket;
  uint32_t* scanned;
  int32_t* excl;
};

StartScratch start_scratch(void* scratch) {
  auto* w = static_cast<uint32_t*>(scratch);
  return {w, w + 1, reinterpret_cast<int32_t*>(w + 4)};
}

// a warp's shared memory: K1's ring, two tables of 256 entries and a
// dummy a lane, the seen keys of the first table, and the inverse map:
// C entries, a dummy a lane that stores go to, a dummy a lane that
// reads from (always -1), int16
constexpr int kTabEntries = kAlpha + 32;
constexpr size_t kStartRingBytes = sizeof(int32_t) * kAlpha * kStartAhead;
__host__ __device__ size_t start_warp_bytes(int C) {
  return kStartRingBytes + sizeof(int32_t) * (2 * kTabEntries + kAlpha) +
         (sizeof(int16_t) * (C + 64) + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// K1's row of chunk c into a ring slot, by the warp
__device__ __forceinline__ void fetch_row(int32_t* slot,
                                          const int32_t* __restrict__ rec,
                                          int c, bool vec, int lane) {
  const int32_t* src = rec + static_cast<size_t>(c) * kAlpha;
  if (vec) {
    cp_async16(slot + 4 * lane, src + 4 * lane);
    cp_async16(slot + 128 + 4 * lane, src + 128 + 4 * lane);
  } else {
#pragma unroll
    for (int j = 0; j < kAlpha / 32; ++j)
      cp_async4(slot + 32 * j + lane, src + 32 * j + lane);
  }
}

// the exclusive max-scan of one symbol's row of n tile maxima, by a
// warp, into the prefix: tile t's key at x[t]
__device__ __forceinline__ void scan_row(const int32_t* __restrict__ prow,
                                         int32_t* __restrict__ x, int n,
                                         int lane) {
  int32_t carry = -1;
  for (int b = 0; b < n; b += 32 * kScanBatch) {
    int32_t v[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const int i = b + 32 * k + lane;
      v[k] = i < n ? prow[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      int32_t a = v[k];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t u = __shfl_up_sync(kFullMask, a, o);
        if (lane >= o) a = max(a, u);
      }
      int32_t ex = __shfl_up_sync(kFullMask, a, 1);
      const int i = b + 32 * k + lane;
      if (i < n)
        x[i] = max(carry, lane == 0 ? -1 : ex);
      carry = max(carry, __shfl_sync(kFullMask, a, 31));
    }
  }
}

__global__ void __launch_bounds__(kStartThreads)
    mtf_start_kernel(const int32_t* __restrict__ rec,
                     const int32_t* __restrict__ part,
                     int32_t* __restrict__ out, StartScratch st, int nchunks,
                     int C, int T, int ntiles, int split, int nscan,
                     bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* mine = smem + start_warp_bytes(C) * warp;
  int32_t* ring = reinterpret_cast<int32_t*>(mine);
  int32_t* tabs = reinterpret_cast<int32_t*>(mine + kStartRingBytes);
  int32_t* keys = tabs + 2 * kTabEntries;
  int16_t* inv = reinterpret_cast<int16_t*>(keys + kAlpha);
  int tb = 0;
  if (ntiles > 1) {
    if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(st.ticket, 1u));
    __syncthreads();
    tb = s_ticket;
  }
  // K1's tile `tile`, its part `sub` of T / split chunks
  const int wid = tb * kStartWarps + warp;
  const int tile = wid / split, sub = wid % split, tw = T / split;
  const int c0 = tile * T + sub * tw;
  const int c1 = min(c0 + tw, nchunks);
  // the tile's first rows in flight while the prefix is scanned
  if (c0 < c1) {
#pragma unroll
    for (int k = 0; k < kStartAhead - 1; ++k) {
      if (c0 + k < c1) fetch_row(ring + k * kAlpha, rec, c0 + k, vec, lane);
      cp_async_commit();
    }
  }
  // the scanners first, so that the wait on them holds no fold up
  if (ntiles > 1 && tb < nscan) {
    const int per = (kAlpha + nscan - 1) / nscan;
    const int r1 = min(kAlpha, (tb + 1) * per);
    for (int r = tb * per + warp; r < r1; r += kStartWarps)
      scan_row(part + static_cast<size_t>(r) * ntiles,
               st.excl + static_cast<size_t>(r) * ntiles, ntiles, lane);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(st.scanned, 1u);
  }
  // this part's keys from the tile's chunks before it, kFoldBatch rows
  // in flight: a seen step's position is above every earlier one, and
  // above the prefix
  int32_t key[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) key[j] = -1;
  if (c0 < c1) {
    for (int c = tile * T; c < c0; c += kFoldBatch) {
      int32_t r[kFoldBatch][8];
#pragma unroll
      for (int k = 0; k < kFoldBatch; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          r[k][j] = c + k < c0 ? rec[static_cast<size_t>(c + k) * kAlpha +
                                     32 * j + lane]
                               : -1;
#pragma unroll
      for (int k = 0; k < kFoldBatch; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (r[k][j] >= 0) key[j] = (c + k) * C + r[k][j];
    }
  }
  if (ntiles > 1) {
    if (threadIdx.x == 0)
      while (ld_acquire(st.scanned) < static_cast<uint32_t>(nscan))
        __nanosleep(64);  // off the L2 slice the scanners count on
    __syncthreads();
  }
  if (c0 >= c1) return;  // the warp's tile is past the last
  // the first table: symbol 32j + lane's key, then its place
  if (ntiles > 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      key[j] = max(key[j],
                   __ldcg(st.excl + tile +
                          static_cast<size_t>(32 * j + lane) * ntiles));
  }
  unsigned bal[8];
  int nseen = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bal[j] = __ballot_sync(kFullMask, key[j] >= 0);
    if (key[j] >= 0) keys[nseen + __popc(bal[j] & ((1u << lane) - 1u))] = key[j];
    nseen += __popc(bal[j]);
  }
  for (int i = lane; i < C; i += 32) inv[i] = -1;
  inv[C + 32 + lane] = -1;
  const unsigned lt = (1u << lane) - 1u;
  __syncwarp();
  int pos[8], unseen = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned ub = ~bal[j];
    pos[j] = nseen + unseen + __popc(ub & ((1u << lane) - 1u));
    unseen += __popc(ub);
  }
  if (nseen > 0) {
    // minus the count of seen keys above each key, as sign bits: keys
    // and listed keys are in [-1, 2^31), so key - w does not overflow,
    // and no compare ties up a predicate register
    int above[8] = {};
    int q = 0;
    for (; q + 4 <= nseen; q += 4) {
      const int4 w = *reinterpret_cast<const int4*>(keys + q);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        above[j] += ((key[j] - w.x) >> 31) + ((key[j] - w.y) >> 31) +
                    ((key[j] - w.z) >> 31) + ((key[j] - w.w) >> 31);
    }
    for (; q < nseen; ++q) {
      const int32_t w = keys[q];
#pragma unroll
      for (int j = 0; j < 8; ++j) above[j] += (key[j] - w) >> 31;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (key[j] >= 0) pos[j] = min(-above[j], kAlpha - 1);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) tabs[pos[j]] = 32 * j + lane;
  __syncwarp();
  int32_t sym[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sym[j] = tabs[32 * j + lane] & (kAlpha - 1);
  // the walk: chunk c0 + i's table in sym, its row in ring slot i % ring
  for (int i = 0;; ++i) {
    const int c = c0 + i;
    int32_t* o = out + static_cast<size_t>(c) * kAlpha;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[32 * j + lane] = sym[j];
    if (c + 1 >= c1) break;
    cp_async_wait<kStartAhead - 2>();
    __syncwarp();
    const int32_t* row = ring + (i % kStartAhead) * kAlpha;
    int32_t rc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) rc[j] = row[sym[j]];
    // the slot of chunk i - 1, read in the last round
    if (c + kStartAhead - 1 < c1)
      fetch_row(ring + ((i + kStartAhead - 1) % kStartAhead) * kAlpha, rec,
                c + kStartAhead - 1, vec, lane);
    cp_async_commit();
    int32_t* nt = tabs + (i & 1) * kTabEntries;
    // unseen: -1 where the symbol has no step in chunk c, else 0.  A seen
    // symbol writes itself at its step of the inverse map, an unseen one
    // at a dummy entry past C; the stores carry no predicate.
    int un[8], up[8], nun = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      un[j] = -static_cast<int>(static_cast<unsigned>(rc[j]) >=
                                static_cast<unsigned>(C));
      inv[rc[j] + (un[j] & (C + lane - rc[j]))] = static_cast<int16_t>(sym[j]);
      const unsigned ub = __ballot_sync(kFullMask, un[j]);
      up[j] = nun + __popc(ub & lt);
      nun += __popc(ub);
    }
    __syncwarp();
    // the seen symbols, newest step first, cleared behind; entries below
    // step 0 read C + 32 + lane, which stays -1
    int front = 0;
    for (int t0 = C - 1; t0 >= 0; t0 -= 128) {
      // 128 steps at once, their reads issued together
      int v[4], ta[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t0 - 32 * k - lane;
        ta[k] = t >= 0 ? t : C + 32 + lane;
        v[k] = inv[ta[k]];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) inv[ta[k]] = -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned fb = __ballot_sync(kFullMask, v[k] >= 0);
        const int at = front + __popc(fb & lt);
        nt[at + ((v[k] >> 31) & (kAlpha + lane - at))] = v[k];
        front += __popc(fb);
      }
      // every seen symbol found: the entries below were never written
      if (front == kAlpha - nun) break;
    }
    // the unseen keep their order behind them; a seen one writes a dummy
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int at = kAlpha - nun + up[j];
      nt[kAlpha + lane + (un[j] & (at - kAlpha - lane))] = sym[j];
    }
    __syncwarp();
    // (a symbol whatever the input: off the domain a place may stay
    // unwritten)
#pragma unroll
    for (int j = 0; j < 8; ++j) sym[j] = nt[32 * j + lane] & (kAlpha - 1);
  }
  cp_async_wait<0>();
}

}  // namespace

// tile: one of kStartTiles, or 0 for the start tables' pick
// (start_tile).  part == nullptr writes the rows alone; else also the
// tile maxima int32[256 * ceil(nchunks / tile)], symbol-major, which
// needs nchunks * C < 2^31.
extern "C" int tplc_mtf_recency(const void* syms, void* out, void* part,
                                int nchunks, int C, int tile, void* stream) {
  if (tile == 0) tile = start_tile(nchunks);
  if (!known_tile(tile) || C < 0 || nchunks < 0 ||
      (part != nullptr && static_cast<long long>(nchunks) * C > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks > 0) {
    const int ntiles = (nchunks + tile - 1) / tile;
    mtf_recency_kernel<<<ntiles, kRecThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(syms), static_cast<int32_t*>(out),
        static_cast<int32_t*>(part), nchunks, C, tile, ntiles);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tplc_mtf_encode_lockstep(const void* table0, const void* syms,
                                        void* ranks, void* table_out,
                                        int nchunks, int C, void* stream) {
  if (C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks > 0) {
    const auto* t0 = static_cast<const int32_t*>(table0);
    auto* to = static_cast<int32_t*>(table_out);
    const int per_block = kDecThreads / kEncLanes;
    const int blocks = (nchunks + per_block - 1) / per_block;
    mtf_encode_walk_kernel<<<blocks, kDecThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        t0, static_cast<const int32_t*>(syms), static_cast<int32_t*>(ranks),
        to, nchunks, C, aligned16(t0) && aligned16(to));
  }
  return static_cast<int>(cudaGetLastError());
}

// The start tables' chunks a tile for nchunks chunks: `tile` if it is one
// of kStartTiles (a hook for tests and chip_smoke.py), the
// shape's pick (start_tile) if 0, else -1 (also when the card does not
// answer).  The caller sizes K1's tile
// maxima and the scratch of tplc_mtf_start_tables by it.
extern "C" int tplc_mtf_start_tile(int nchunks, int tile) {
  if (tile == 0) return start_tile(nchunks);
  return known_tile(tile) ? tile : -1;
}

namespace {

// The start tables with `split` warps a tile (1, 2, 4 or 8); the
// arguments as tplc_mtf_start_tables's, checked there.
int start_tables(const int32_t* r, const int32_t* p, int32_t* out,
                 void* scratch, int nchunks, int C, int tile, int split,
                 cudaStream_t s) {
  const int ntiles = (nchunks + tile - 1) / tile;
  const int nblk = (ntiles * split + kStartWarps - 1) / kStartWarps;
  StartScratch st{};
  int nscan = 0;
  if (ntiles > 1) {
    st = start_scratch(scratch);
    if (p == nullptr) {
      int32_t* own = st.excl + static_cast<size_t>(kAlpha) * ntiles;
      mtf_tile_max_kernel<<<ntiles, kAlpha, 0, s>>>(r, own, nchunks, C,
                                                   tile, ntiles);
      p = own;
    }
    const cudaError_t e = cudaMemsetAsync(scratch, 0, 16, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    nscan = min(nblk, kScanBlocks);
  }
  const size_t smem = kStartWarps * start_warp_bytes(C);
  const cudaError_t e = cudaFuncSetAttribute(
      mtf_start_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  mtf_start_kernel<<<nblk, kStartThreads, smem, s>>>(
      r, p, out, st, nchunks, C, tile, ntiles, split, nscan,
      aligned16(r));
  return static_cast<int>(cudaGetLastError());
}

bool start_args_ok(int nchunks, int C, int tile) {
  return known_tile(tile) && C >= 1 && C <= kMaxStartChunk &&
         nchunks >= 0 && static_cast<long long>(nchunks) * C <= 0x7fffffffLL;
}

}  // namespace

// part: K1's tile maxima at this tile (read, not written), or nullptr
// to compute them here first; tile one of kStartTiles; 1 <= C <=
// kMaxStartChunk (the inverse map) and nchunks * C < 2^31.  scratch:
// none for one tile, else int32 words: 4 (the ticket and the scanners'
// count), 256 * ntiles (the prefix), and 256 * ntiles more when part ==
// nullptr (the maxima), 16-byte aligned.  A 16-byte memset and one
// kernel launch; a tile-max launch before them when part == nullptr.
extern "C" int tplc_mtf_start_tables(const void* rec, void* out,
                                     const void* part, void* scratch,
                                     int nchunks, int C, int tile,
                                     void* stream) {
  if (!start_args_ok(nchunks, C, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks == 0) return static_cast<int>(cudaGetLastError());
  const int ntiles = (nchunks + tile - 1) / tile;
  const int split = start_split(ntiles, tile);
  if (split < 0) return static_cast<int>(cudaGetLastError());
  return start_tables(static_cast<const int32_t*>(rec),
                      static_cast<const int32_t*>(part),
                      static_cast<int32_t*>(out), scratch, nchunks, C, tile,
                      split, static_cast<cudaStream_t>(stream));
}

// table0 == nullptr starts every chunk from the identity; syms or
// table_out == nullptr skips that output.  lanes = lanes a chunk (32, 16
// or 8; 0 picks kAutoLanes).
extern "C" int tplc_mtf_lockstep(const void* table0, const void* ranks,
                                 void* syms, void* table_out, int nchunks,
                                 int C, int lanes, void* stream) {
  if (lanes == 0) lanes = kAutoLanes;
  if ((lanes != 32 && lanes != 16 && lanes != 8) || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks > 0) {
    auto* s = static_cast<cudaStream_t>(stream);
    const auto* t0 = static_cast<const int32_t*>(table0);
    const auto* r = static_cast<const int32_t*>(ranks);
    auto* sy = static_cast<int32_t*>(syms);
    auto* to = static_cast<int32_t*>(table_out);
    if (lanes == 32)
      launch_decode<32>(t0, r, sy, to, nchunks, C, s);
    else if (lanes == 16)
      launch_decode<16>(t0, r, sy, to, nchunks, C, s);
    else
      launch_decode<8>(t0, r, sy, to, nchunks, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}
