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
// once (420 MB a 25 MiB block: 0.125 ms).  Design, three launches over
// tiles of T chunks, two where K1 wrote the tile maxima (the forward
// MTF's route):
// (a) tile max: a block a tile, a thread a symbol, the max key of each
//     symbol over the tile's T rows (coalesced 1 KB row loads); K1 with
//     `part` computes the same in its own pass and (a) is skipped;
// (b) an exclusive max-scan of those [ntiles] partials into the
//     scratch, a block a symbol: the symbol's partials are a contiguous
//     row (symbol-major), scanned by 1,024 threads with warp shuffles
//     and a carry between segments;
// (c) a walk of each tile's T chunks in order, a block a tile, a thread
//     a symbol and a table position.  The tile's first table: each
//     symbol's position is the count of keys above its own (ties to
//     the lower symbol, as the stable sort) over the 256 keys in shared
//     memory.  Chunk c+1's table from chunk c's and K1's row for c, with
//     no sort: the symbols seen in c go to the front newest first (a
//     symbol's place is the count of bits above its own step in the
//     chunk's step mask, built with shared-memory atomicOr), and every
//     other entry keeps its order, moved back by the seen entries before
//     it (a block-wide ballot prefix count).  That equals the stable
//     argsort: the keys of symbols seen in c lie in [c*C, c*C + C),
//     above every other key, and the other keys do not change.  A
//     chunk's step is short next to a load from device memory, so each
//     thread keeps the next kStartAhead rows in flight (one row in
//     flight took 0.39 ms at the soup shape, four 0.31: PERF.md).
// Domain (the plain version's on K1's output): each row holds values in
// [-1, C) and each step at most once, so every key is distinct.  Off
// it the kernel reads and writes only inside its arrays.
// ---------------------------------------------------------------------
constexpr int kScanThreads = 1024;
constexpr int kMaxStartChunk = 4096;  // the step mask: 128 words
constexpr int kStartTiles[] = {8, 16, 32, 64};
constexpr int kStartAhead = 4;  // K1 rows a thread of the walk keeps in flight

bool known_tile(int tile) {
  for (int t : kStartTiles)
    if (t == tile) return true;
  return false;
}

// The tile for nchunks chunks: the largest of kStartTiles that still
// leaves 3 tiles an SM, else the smallest.  It was the fastest at both of
// chip_smoke.py's shapes on the H100's 132 SMs (16 at 7,032 chunks, 64
// at 204,800: PERF.md).
int start_tile(int nchunks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int n = sizeof(kStartTiles) / sizeof(kStartTiles[0]);
  for (int i = n - 1; i > 0; --i)
    if ((nchunks + kStartTiles[i] - 1) / kStartTiles[i] >= 3 * sms)
      return kStartTiles[i];
  return kStartTiles[0];
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

// in and out may be one array: each element is read before it is
// written, by the same thread
__global__ void __launch_bounds__(kScanThreads)
    mtf_tile_scan_kernel(const int32_t* part, int32_t* excl, int ntiles) {
  __shared__ int32_t wtot[kScanThreads / 32];
  const int32_t* row = part + static_cast<size_t>(blockIdx.x) * ntiles;
  int32_t* xrow = excl + static_cast<size_t>(blockIdx.x) * ntiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t carry = -1;
  for (int i0 = 0; i0 < ntiles; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    int32_t v = i < ntiles ? row[i] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kFullMask, v, o);
      if (lane >= o) v = max(v, u);
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int32_t x = wtot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t u = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x = max(x, u);
      }
      wtot[lane] = x;
    }
    __syncthreads();
    int32_t ex = __shfl_up_sync(kFullMask, v, 1);
    if (lane == 0) ex = -1;
    if (warp > 0) ex = max(ex, wtot[warp - 1]);
    if (i < ntiles) xrow[i] = max(ex, carry);
    carry = max(carry, wtot[kScanThreads / 32 - 1]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kAlpha)
    mtf_start_walk_kernel(const int32_t* __restrict__ rec,
                          const int32_t* __restrict__ excl,
                          int32_t* __restrict__ out, int nchunks, int C,
                          int T, int ntiles) {
  // K1's row, the step mask and the seen counts are double-buffered, so
  // a chunk takes two barriers
  __shared__ int64_t keys[kAlpha];
  __shared__ int32_t recs[2][kAlpha];
  __shared__ unsigned steps[2][kMaxStartChunk / 32];
  __shared__ __align__(16) int seen_in[2][kAlpha / 32];
  __shared__ int32_t tab[kAlpha];
  const int p = threadIdx.x;  // a symbol, and a table position
  const int lane = p & 31, warp = p >> 5;
  const int nwords = (C + 31) >> 5;
  const int c0 = blockIdx.x * T;
  const int c1 = min(c0 + T, nchunks);
  // symbol p's step in chunk c0 + i is row[i * 256]; the rows of the
  // next kStartAhead chunks are in flight in `ahead`
  const int32_t* row = rec + static_cast<size_t>(c0) * kAlpha + p;
  int32_t r_own = c0 + 1 < c1 ? row[0] : -1;
  int32_t ahead[kStartAhead];
#pragma unroll
  for (int k = 0; k < kStartAhead; ++k)
    ahead[k] = c0 + k + 2 < c1 ? row[(k + 1) * kAlpha] : -1;
  // the tile's first table: (key, -symbol) as one 64-bit key, so that
  // ties go to the lower symbol as in the stable sort, and the
  // positions are a permutation whatever the input
  const int32_t b = excl[static_cast<size_t>(p) * ntiles + blockIdx.x];
  const int64_t key = static_cast<int64_t>(b >= 0 ? b : -2 - p) * kAlpha +
                      (kAlpha - 1 - p);
  keys[p] = key;
  recs[0][p] = r_own;
  if (p < nwords) steps[0][p] = 0u;
  __syncthreads();
  int above = 0;
#pragma unroll 16
  for (int j = 0; j < kAlpha; ++j) above += keys[j] > key;
  tab[above] = p;
  for (int c = c0;; c += kStartAhead) {
#pragma unroll
    for (int k = 0; k < kStartAhead; ++k) {
      const int cc = c + k;
      const int buf = k & 1;  // kStartAhead is even
      __syncthreads();
      const int32_t cur = tab[p];  // the symbol at position p of chunk cc
      out[static_cast<size_t>(cc) * kAlpha + p] = cur;
      if (cc + 1 >= c1) return;
      if (r_own >= 0 && r_own < C)
        atomicOr(&steps[buf][r_own >> 5], 1u << (r_own & 31));
      const int32_t rc = recs[buf][cur];
      const bool seen = rc >= 0;
      const unsigned bal = __ballot_sync(kFullMask, seen);
      if (lane == 0) seen_in[buf][warp] = __popc(bal);
      __syncthreads();
      const int4 lo = reinterpret_cast<const int4*>(seen_in[buf])[0];
      const int4 hi = reinterpret_cast<const int4*>(seen_in[buf])[1];
      const int n[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      int nseen = 0, before = __popc(bal & ((1u << lane) - 1u));
#pragma unroll
      for (int w = 0; w < kAlpha / 32; ++w) {
        nseen += n[w];
        before += w < warp ? n[w] : 0;
      }
      int np = nseen + p - before;  // an unseen entry, moved back
      if (seen) {                   // newest first: the seen steps above rc
        const int s = min(rc, C - 1);
        np = __popc(steps[buf][s >> 5] & ~((2u << (s & 31)) - 1u));
        for (int w = (s >> 5) + 1; w < nwords; ++w)
          np += __popc(steps[buf][w]);
        np = min(np, kAlpha - 1);
      }
      tab[np] = cur;
      recs[buf ^ 1][p] = ahead[k];
      if (p < nwords) steps[buf ^ 1][p] = 0u;
      r_own = ahead[k];
      ahead[k] = cc + kStartAhead + 2 < c1
                     ? row[static_cast<size_t>(cc - c0 + kStartAhead + 1) *
                           kAlpha]
                     : -1;
    }
  }
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
// of kStartTiles (a hook for tests and chip_smoke.py's sweep), the
// shape's pick (start_tile) if 0, else -1.  The caller sizes the scratch
// of tplc_mtf_start_tables by it.
extern "C" int tplc_mtf_start_tile(int nchunks, int tile) {
  if (tile == 0) return start_tile(nchunks);
  return known_tile(tile) ? tile : -1;
}

// part: K1's tile maxima at this tile (read, not written), or nullptr
// to compute them here; scratch: int32[256 * ceil(nchunks / tile)];
// tile one of kStartTiles; 1 <= C <= kMaxStartChunk (the walk's step
// mask) and nchunks * C < 2^31
extern "C" int tplc_mtf_start_tables(const void* rec, void* out,
                                     const void* part, void* scratch,
                                     int nchunks, int C, int tile,
                                     void* stream) {
  if (!known_tile(tile) || C < 1 || C > kMaxStartChunk || nchunks < 0 ||
      static_cast<long long>(nchunks) * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks > 0) {
    auto* s = static_cast<cudaStream_t>(stream);
    const auto* r = static_cast<const int32_t*>(rec);
    auto* excl = static_cast<int32_t*>(scratch);
    const auto* p = static_cast<const int32_t*>(part);
    const int ntiles = (nchunks + tile - 1) / tile;
    if (p == nullptr) {
      mtf_tile_max_kernel<<<ntiles, kAlpha, 0, s>>>(r, excl, nchunks, C, tile,
                                                   ntiles);
      p = excl;
    }
    mtf_tile_scan_kernel<<<kAlpha, kScanThreads, 0, s>>>(p, excl, ntiles);
    mtf_start_walk_kernel<<<ntiles, kAlpha, 0, s>>>(
        r, excl, static_cast<int32_t*>(out), nchunks, C, tile, ntiles);
  }
  return static_cast<int>(cudaGetLastError());
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
