// The inclusive running max and min of a 1-D int32 or int64 tensor, on
// Hopper (sm_90a), forward or reverse.
// Plain C entry points, loaded with ctypes by tpulc_torch/cuda_lib.py;
// the wrappers and plain PyTorch versions live in
// tpulc_torch/primitives/scan_kernels.py.
//
// Replaces no pallas_call: tpulc runs these scans as
// `jax.lax.associative_scan(jnp.maximum / jnp.minimum, x, reverse=...)`
// under XLA (tpulc/codecs/bwt/rle.py:43,46,78,103,
// tpulc/codecs/bwt/rotsort.py:148, tpulc/codecs/bsclike/grc.py:165,299).
// The port first ran them as torch.cummax / torch.cummin, which an H100
// trace showed at ~3 ms a call on a 900,000-element bz block and ~77 ms
// on a 25 MiB bsc block, against a bytes bound of 2 x the input's bytes
// over 3.35 TB/s (~4.3 us and ~0.125 ms in int64).
//
// Bound on the H100: bytes.  A max or min a element is no work.  Design:
// three launches, tiles of kTile elements.
//   1. each block reduces one tile to one value (`tile_reduce`);
//   2. one block scans the tile values into each tile's carry-in, from
//      the left (forward) or the right (reverse) (`carry_scan`);
//   3. each block scans its tile again from its carry-in and writes it
//      (`tile_scan`).
// x is read twice and y written once: 3 passes over the bytes where the
// bound counts 2.  A tile is kRounds rounds of kThreads threads x one
// 16-byte vector (4 int32 or 2 int64): every load and store of a warp
// covers 512 contiguous bytes, and a thread's kRounds loads are all in
// flight before it computes.  A thread scans each of its vectors, a
// warp the thread totals (shuffles), the block the warp totals of every
// round through shared memory, in one pass for all rounds.  Reverse
// reads the same addresses and combines in descending order: no flip.
// An input of one tile runs launch 3 alone.  Inputs whose address is
// not 16-byte aligned take scalar loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kTile % (kThreads * 4) == 0, "a tile is whole rounds of int32");

template <typename T>
struct Lim;
template <>
struct Lim<int32_t> {
  static constexpr int32_t lo = INT32_MIN, hi = INT32_MAX;
};
template <>
struct Lim<int64_t> {
  static constexpr int64_t lo = INT64_MIN, hi = INT64_MAX;
};

template <typename T, bool kMax>
struct Op {
  __device__ __forceinline__ static T identity() {
    return kMax ? Lim<T>::lo : Lim<T>::hi;
  }
  __device__ __forceinline__ static T apply(T a, T b) {
    if constexpr (kMax)
      return a > b ? a : b;
    else
      return a < b ? a : b;
  }
};

// one 16-byte load or store a thread
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// the tile's values: round r, element e of thread tid is x[base + (r *
// kThreads + tid) * kN + e]; the identity past n
template <typename T, bool kMax, int kRounds>
__device__ __forceinline__ void load_tile(Vec<T> (&v)[kRounds],
                                          const T* __restrict__ x,
                                          long long base, long long n,
                                          bool aligned) {
  using O = Op<T, kMax>;
  constexpr int kN = Vec<T>::kN;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (static_cast<long long>(r) * kThreads +
                                threadIdx.x) * kN;
    if (aligned && i + kN <= n) {
      v[r] = *reinterpret_cast<const Vec<T>*>(x + i);
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        v[r].v[e] = i + e < n ? x[i + e] : O::identity();
    }
  }
}

// inclusive scan of a over the warp's lanes, ascending (forward) or
// descending (reverse)
template <typename T, bool kMax, bool kRev>
__device__ __forceinline__ T warp_scan(T a, int lane) {
  using O = Op<T, kMax>;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = kRev ? __shfl_down_sync(kFullMask, a, d)
                     : __shfl_up_sync(kFullMask, a, d);
    if (kRev ? lane + d < 32 : lane >= d) a = O::apply(a, o);
  }
  return a;
}

// 1. one value a tile
template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
    tile_reduce(const T* __restrict__ x, T* __restrict__ agg, long long n,
                bool aligned) {
  using O = Op<T, kMax>;
  constexpr int kN = Vec<T>::kN;
  constexpr int kRounds = kTile / (kThreads * kN);
  __shared__ T warp_red[kWarps];
  Vec<T> v[kRounds];
  load_tile<T, kMax, kRounds>(v, x, static_cast<long long>(blockIdx.x) * kTile,
                              n, aligned);
  T a = O::identity();
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
#pragma unroll
    for (int e = 0; e < kN; ++e) a = O::apply(a, v[r].v[e]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    a = O::apply(a, __shfl_xor_sync(kFullMask, a, d));
  if ((threadIdx.x & 31) == 0) warp_red[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = warp_red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = O::apply(t, warp_red[w]);
    agg[blockIdx.x] = t;
  }
}

// 2. carry[b] = the op over the tiles before b (forward: b' < b; reverse:
// b' > b), the identity for the first; one block of kCarryThreads
template <typename T, bool kMax, bool kRev>
__global__ void __launch_bounds__(kCarryThreads)
    carry_scan(const T* __restrict__ agg, T* __restrict__ carry, int ntiles) {
  using O = Op<T, kMax>;
  constexpr int kW = kCarryThreads / 32;
  __shared__ T warp_tot[kW];
  __shared__ T run;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) run = O::identity();
  for (int c = 0; c < ntiles; c += kCarryThreads) {
    // logical index k = c + tid; tile kRev ? ntiles - 1 - k : k
    const int k = c + threadIdx.x;
    const int b = kRev ? ntiles - 1 - k : k;
    const T a = k < ntiles ? agg[b] : O::identity();
    const T inc = warp_scan<T, kMax, false>(a, lane);
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    T pre = run;
    for (int w = 0; w < warp; ++w) pre = O::apply(pre, warp_tot[w]);
    const T up = __shfl_up_sync(kFullMask, inc, 1);
    const T excl = lane == 0 ? pre : O::apply(pre, up);
    if (k < ntiles) carry[b] = excl;
    __syncthreads();
    if (threadIdx.x == kCarryThreads - 1) run = O::apply(excl, a);
    __syncthreads();
  }
}

// 3. the tile scanned from its carry-in (carry == nullptr: the identity)
template <typename T, bool kMax, bool kRev>
__global__ void __launch_bounds__(kThreads)
    tile_scan(const T* __restrict__ x, T* __restrict__ y,
              const T* __restrict__ carry, long long n, bool aligned) {
  using O = Op<T, kMax>;
  constexpr int kN = Vec<T>::kN;
  constexpr int kRounds = kTile / (kThreads * kN);
  __shared__ T warp_tot[kRounds][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  Vec<T> v[kRounds];
  load_tile<T, kMax, kRounds>(v, x, base, n, aligned);
  // each vector scanned in place; its total, then the warp's inclusive
  // scan of the totals
  T inc[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if constexpr (kRev) {
#pragma unroll
      for (int e = kN - 2; e >= 0; --e)
        v[r].v[e] = O::apply(v[r].v[e + 1], v[r].v[e]);
      inc[r] = warp_scan<T, kMax, true>(v[r].v[0], lane);
    } else {
#pragma unroll
      for (int e = 1; e < kN; ++e)
        v[r].v[e] = O::apply(v[r].v[e - 1], v[r].v[e]);
      inc[r] = warp_scan<T, kMax, false>(v[r].v[kN - 1], lane);
    }
    if (lane == (kRev ? 0 : 31)) warp_tot[r][warp] = inc[r];
  }
  __syncthreads();
  // the carry into each round of this thread: the tile's carry-in, the
  // rounds before (all warps), the warps before in this round, the
  // lanes before in this warp
  T pre = carry != nullptr ? carry[blockIdx.x] : O::identity();
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int r = kRev ? kRounds - 1 - q : q;
    T in_round = pre;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (kRev ? w > warp : w < warp) in_round = O::apply(in_round,
                                                          warp_tot[r][w]);
    const T nb = kRev ? __shfl_down_sync(kFullMask, inc[r], 1)
                      : __shfl_up_sync(kFullMask, inc[r], 1);
    const T c = lane == (kRev ? 31 : 0) ? in_round
                                         : O::apply(in_round, nb);
#pragma unroll
    for (int e = 0; e < kN; ++e) v[r].v[e] = O::apply(c, v[r].v[e]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) pre = O::apply(pre, warp_tot[r][w]);
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (static_cast<long long>(r) * kThreads +
                                threadIdx.x) * kN;
    if (aligned && i + kN <= n) {
      *reinterpret_cast<Vec<T>*>(y + i) = v[r];
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        if (i + e < n) y[i + e] = v[r].v[e];
    }
  }
}

template <typename T, bool kMax, bool kRev>
cudaError_t run(const void* xv, void* yv, void* scratch, long long n,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int ntiles = static_cast<int>((n + kTile - 1) / kTile);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const T* carry = nullptr;
  if (ntiles > 1) {
    T* agg = static_cast<T*>(scratch);
    T* c = agg + ntiles;
    tile_reduce<T, kMax><<<ntiles, kThreads, 0, s>>>(x, agg, n, aligned);
    carry_scan<T, kMax, kRev><<<1, kCarryThreads, 0, s>>>(agg, c, ntiles);
    carry = c;
  }
  tile_scan<T, kMax, kRev><<<ntiles, kThreads, 0, s>>>(x, y, carry, n,
                                                       aligned);
  return cudaGetLastError();
}

}  // namespace

// Elements of scratch (of x's type) that tplc_running_scan needs for n
// elements: two a tile, none for one tile.
extern "C" int tplc_running_scan_scratch(int n) {
  const int ntiles = (n + kTile - 1) / kTile;
  return ntiles > 1 ? 2 * ntiles : 0;
}

// y = the inclusive running max (is_max) or min of x[0..n), from the left
// or (reverse) from the right; elem_bytes 4 (int32) or 8 (int64); x and y
// of n elements, scratch of tplc_running_scan_scratch(n)
extern "C" int tplc_running_scan(const void* x, void* y, void* scratch, int n,
                                 int elem_bytes, int is_max, int reverse,
                                 void* stream) {
  if (n < 0 || (elem_bytes != 4 && elem_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* s = static_cast<cudaStream_t>(stream);
  const int key = (elem_bytes == 8) * 4 + (is_max != 0) * 2 + (reverse != 0);
  cudaError_t e;
  switch (key) {
    case 0: e = run<int32_t, false, false>(x, y, scratch, n, s); break;
    case 1: e = run<int32_t, false, true>(x, y, scratch, n, s); break;
    case 2: e = run<int32_t, true, false>(x, y, scratch, n, s); break;
    case 3: e = run<int32_t, true, true>(x, y, scratch, n, s); break;
    case 4: e = run<int64_t, false, false>(x, y, scratch, n, s); break;
    case 5: e = run<int64_t, false, true>(x, y, scratch, n, s); break;
    case 6: e = run<int64_t, true, false>(x, y, scratch, n, s); break;
    default: e = run<int64_t, true, true>(x, y, scratch, n, s); break;
  }
  return static_cast<int>(e);
}
