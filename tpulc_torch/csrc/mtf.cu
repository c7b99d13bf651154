// MTF kernels for Hopper (sm_90a): K1 recency, K2 encode lockstep,
// K4 decode lockstep (a group of lanes a chunk, the table in registers).
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

// ---------------------------------------------------------------------
// K1 — replaces tpulc/primitives/mtf_pallas.py:mtf_recency_pallas
// (_recency_kernel): for each chunk, the last step index of every
// symbol, -1 where absent.  int32[nchunks, C] -> int32[nchunks, 256].
//
// Bound on the H100: the 256-int output row per chunk (1 KB written per
// 512 B of int32 input) and launch latency; there is almost no compute.
// Design: one block of 128 threads per chunk, a 256-entry shared
// array set to -1, one atomicMax of the step index per symbol.  This
// replaces the TPU's 128-step lane-masked loop (mtf_pallas.py:190-198)
// with a single parallel step.  Symbols outside [0, 256) are ignored.
// ---------------------------------------------------------------------
__global__ void mtf_recency_kernel(const int32_t* __restrict__ syms,
                                   int32_t* __restrict__ out, int C) {
  __shared__ int last[kAlpha];
  const size_t c = blockIdx.x;
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x) last[i] = -1;
  __syncthreads();
  const int32_t* row = syms + c * C;
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    const unsigned s = static_cast<unsigned>(row[t]);
    if (s < kAlpha) atomicMax(&last[s], t);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kAlpha; i += blockDim.x)
    out[c * kAlpha + i] = last[i];
}

// ---------------------------------------------------------------------
// K2 — replaces mtf_pallas.py:mtf_encode_lockstep_pallas
// (_mtf_encode_kernel): MTF by SYMBOL from each chunk's start table;
// emits ranks and the final table.  One thread per chunk.
//
// Bound on the H100: latency of the dependent shared-memory reads and
// shifts of a 128-step serial chain per chunk (about 7,000 chunks per
// 900 KB block = under two warps per SM), not bandwidth.  Design: each
// thread keeps its 256-entry table in shared memory as a column of a
// [256][32] int array, so thread `lane` always hits bank `lane` and the
// data-dependent find/shift never conflicts; the TPU's two 128-lane
// halves and masked reductions (mtf_pallas.py:9-17) are gone.
// A faster shape, left for later: K4's register table below (tab_load,
// tab_shift, tab_store), with the find as one __ballot_sync over the
// lanes' entries.
// ---------------------------------------------------------------------
constexpr int kWalkThreads = 32;

__global__ void mtf_encode_walk_kernel(const int32_t* __restrict__ table0,
                                       const int32_t* __restrict__ seq,
                                       int32_t* __restrict__ out,
                                       int32_t* __restrict__ table_out,
                                       int nchunks, int C) {
  __shared__ int tab[kAlpha][kWalkThreads];
  const int lane = threadIdx.x;
  const int c = blockIdx.x * kWalkThreads + lane;
  if (c >= nchunks) return;
  const size_t c64 = c;
  for (int j = 0; j < kAlpha; ++j) tab[j][lane] = table0[c64 * kAlpha + j];
  const int32_t* in = seq + c64 * C;
  int32_t* o = out + c64 * C;
  for (int t = 0; t < C; ++t) {
    // first position holding the symbol; 0 when absent (the plain
    // version's argmax-of-equality semantics)
    const int sym = in[t];
    int rank = 0;
    for (int j = 0; j < kAlpha; ++j) {
      if (tab[j][lane] == sym) { rank = j; break; }
    }
    o[t] = rank;
    for (int j = rank; j > 0; --j) tab[j][lane] = tab[j - 1][lane];
    tab[0][lane] = sym;
  }
  for (int j = 0; j < kAlpha; ++j) table_out[c64 * kAlpha + j] = tab[j][lane];
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
constexpr unsigned kFullMask = 0xffffffffu;

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

}  // namespace

extern "C" int tplc_mtf_recency(const void* syms, void* out, int nchunks,
                                int C, void* stream) {
  if (nchunks > 0)
    mtf_recency_kernel<<<nchunks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(syms), static_cast<int32_t*>(out), C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tplc_mtf_encode_lockstep(const void* table0, const void* syms,
                                        void* ranks, void* table_out,
                                        int nchunks, int C, void* stream) {
  if (nchunks > 0)
    mtf_encode_walk_kernel<<<(nchunks + kWalkThreads - 1) / kWalkThreads,
                             kWalkThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table0), static_cast<const int32_t*>(syms),
        static_cast<int32_t*>(ranks), static_cast<int32_t*>(table_out),
        nchunks, C);
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
