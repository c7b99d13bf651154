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
// Bound on the H100: bytes.  A max or min a element is no work.
// Design: one launch, a single pass with decoupled look-back (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA, 2016); x is read once and y written once.
// - A block takes the next tile from an atomic counter, so every tile
//   before it (in scan order: from the left, or for reverse from the
//   right) has started and none waits on a later one.
// - It loads its tile (kRounds rounds of kThreads threads x one 16-byte
//   vector: 4 int32 or 2 int64; every load and store of a warp covers
//   512 contiguous bytes, and a thread's loads are all in flight before
//   it computes), scans each vector, a warp the thread totals
//   (shuffles), and the block the warp totals of every round through
//   shared memory.
// - One thread publishes the tile's aggregate, flag PARTIAL; one warp
//   then looks back over the status words of the kWindow tiles before
//   it (kLookPerLane a lane), waits until all are published, folds in
//   their values, and stops at a window that holds an INCLUSIVE one,
//   else slides kWindow tiles back.  Max and min are commutative and
//   idempotent, so the order of the fold, and folding a tile that an
//   inclusive value already covers, change nothing.  The thread
//   publishes the tile's inclusive value, flag INCLUSIVE, and the block
//   adds the prefix to its values and writes them.
// - No torn reads: a tile's status is one 16-byte word, its value
//   (widened to int64) and its flag, written by one 16-byte store and
//   read by one 16-byte load (both relaxed, device scope), so a flag is
//   never seen without its own value and a window costs one round trip
//   to L2.  The first design read a flag and then its value: two round
//   trips a window of 32, which at a bz block's 220 tiles cost more
//   than the three launches it replaced.  The counter and the status
//   words are cleared by one cudaMemsetAsync on the same stream.
// - An input of one tile takes no counter, no status words and no
//   memset.  Reverse reads the same addresses and combines in
//   descending order: no flip.  Inputs whose address is not 16-byte
//   aligned take scalar loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// elements a tile: the larger of these where it still gives kTilesPerSm
// tiles an SM, else the smaller.  On an H100, int64, device ms over four
// runs (PERF.md section 6): 2,048 best at a bz block's 900,096
// elements (440 tiles), 0.0107-0.0120 against 0.0127-0.0144 at 4,096
// and 0.0131-0.0150 at 8,192; level with 4,096 (two turns) on the
// arrays of pg1661 x 6's one 4 MiB bsc block, 594,046 B after LZP
// (0.0124-0.0129 against 0.0120-0.0139); 8,192 best
// at a 25 MiB block's 26,214,400, 0.1912-0.1960 against 0.1975-0.2029
// at 4,096 and 0.2207-0.2275 at 2,048.  4,096 and 16,384 won at no
// shape a path gives.
constexpr int kTiles[] = {2048, 8192};
constexpr int kTilesPerSm = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint64_t kPartial = 1, kInclusive = 2;   // 0: not yet published
constexpr int kLookPerLane = 4;
constexpr int kWindow = 32 * kLookPerLane;   // tiles a look-back round

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

// ---- the status word: {value, flag}, one 16-byte access (device scope)
struct alignas(16) Word {
  int64_t value;
  uint64_t flag;
};
__device__ __forceinline__ void store_word(Word* p, int64_t v, uint64_t f) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p),
               "l"(v), "l"(f)
               : "memory");
}
__device__ __forceinline__ Word load_word(const Word* p) {
  Word w;
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(w.value), "=l"(w.flag)
               : "l"(p)
               : "memory");
  return w;
}
// ----

// the look-back's state in the scratch: the tile counter (16 bytes),
// then a status word a tile, all cleared by the memset
struct Status {
  uint32_t* counter;
  Word* word;
};

long long scratch_bytes(long long ntiles) {
  return ntiles > 1 ? 16 + 16 * ntiles : 0;
}

Status status_of(void* scratch) {
  auto* b = static_cast<uint8_t*>(scratch);
  return {reinterpret_cast<uint32_t*>(b), reinterpret_cast<Word*>(b + 16)};
}

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

template <typename T, bool kMax>
__device__ __forceinline__ T warp_reduce(T a) {
  using O = Op<T, kMax>;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    a = O::apply(a, __shfl_xor_sync(kFullMask, a, d));
  return a;
}

// the op over every tile before `tile` (tile >= 1), by the calling
// warp: windows of kWindow tiles, back to the first that holds an
// inclusive value
template <typename T, bool kMax>
__device__ __forceinline__ T look_back(const Status& st, long long tile,
                                      int lane) {
  using O = Op<T, kMax>;
  T run = O::identity();
  for (long long top = tile - 1;; top -= kWindow) {
    Word w[kLookPerLane];
    bool wait;
    do {
      wait = false;
#pragma unroll
      for (int k = 0; k < kLookPerLane; ++k) {
        const long long t = top - lane - 32 * k;
        w[k] = t >= 0 ? load_word(st.word + t)
                      : Word{static_cast<int64_t>(O::identity()), kInclusive};
        wait |= w[k].flag == 0;
      }
    } while (__any_sync(kFullMask, wait));
    bool inclusive = false;
#pragma unroll
    for (int k = 0; k < kLookPerLane; ++k) {
      run = O::apply(run, static_cast<T>(w[k].value));
      inclusive |= w[k].flag == kInclusive;
    }
    if (__any_sync(kFullMask, inclusive)) break;
  }
  return warp_reduce<T, kMax>(run);
}

template <typename T, bool kMax, bool kRev, int kTileN>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                long long ntiles, Status st, bool aligned) {
  using O = Op<T, kMax>;
  constexpr int kN = Vec<T>::kN;
  constexpr int kRounds = kTileN / (kThreads * kN);
  static_assert(kTileN % (kThreads * 4) == 0, "whole rounds of int32");
  __shared__ T warp_tot[kRounds][kWarps];
  __shared__ T s_prefix;
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long tile = 0;
  if (ntiles > 1) {
    if (threadIdx.x == 0) s_tile = atomicAdd(st.counter, 1u);
    __syncthreads();
    tile = s_tile;
  }
  const long long base = (kRev ? ntiles - 1 - tile : tile) * kTileN;
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
  T pre = O::identity();
  if (ntiles > 1) {
    if (warp == 0) {
      // the tile's aggregate: the op over every warp total of every round
      T agg = O::identity();
      for (int k = lane; k < kRounds * kWarps; k += 32)
        agg = O::apply(agg, (&warp_tot[0][0])[k]);
      agg = warp_reduce<T, kMax>(agg);
      if (tile == 0) {
        if (lane == 0) {
          store_word(st.word, agg, kInclusive);
          s_prefix = O::identity();
        }
      } else {
        if (lane == 0) store_word(st.word + tile, agg, kPartial);
        const T prefix = look_back<T, kMax>(st, tile, lane);
        if (lane == 0) {
          store_word(st.word + tile, O::apply(prefix, agg), kInclusive);
          s_prefix = prefix;
        }
      }
    }
    __syncthreads();
    pre = s_prefix;
  }
  // the carry into each round of this thread: the tiles before, the
  // rounds before (all warps), the warps before in this round, the
  // lanes before in this warp
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

template <typename T, bool kMax, bool kRev, int kTileN>
cudaError_t run(const void* xv, void* yv, void* scratch, long long n,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const long long ntiles = (n + kTileN - 1) / kTileN;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  Status st{};
  if (ntiles > 1) {
    st = status_of(scratch);
    const cudaError_t e =
        cudaMemsetAsync(scratch, 0, scratch_bytes(ntiles), s);
    if (e != cudaSuccess) return e;
  }
  scan_kernel<T, kMax, kRev, kTileN>
      <<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(x, y, n, ntiles, st,
                                                          aligned);
  return cudaGetLastError();
}

template <int kTileN>
int dispatch(const void* x, void* y, void* scratch, int n, int elem_bytes,
             int is_max, int reverse, void* stream) {
  if (n < 0 || (elem_bytes != 4 && elem_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* s = static_cast<cudaStream_t>(stream);
  const int key = (elem_bytes == 8) * 4 + (is_max != 0) * 2 + (reverse != 0);
  cudaError_t e;
  switch (key) {
    case 0: e = run<int32_t, false, false, kTileN>(x, y, scratch, n, s); break;
    case 1: e = run<int32_t, false, true, kTileN>(x, y, scratch, n, s); break;
    case 2: e = run<int32_t, true, false, kTileN>(x, y, scratch, n, s); break;
    case 3: e = run<int32_t, true, true, kTileN>(x, y, scratch, n, s); break;
    case 4: e = run<int64_t, false, false, kTileN>(x, y, scratch, n, s); break;
    case 5: e = run<int64_t, false, true, kTileN>(x, y, scratch, n, s); break;
    case 6: e = run<int64_t, true, false, kTileN>(x, y, scratch, n, s); break;
    default: e = run<int64_t, true, true, kTileN>(x, y, scratch, n, s); break;
  }
  return static_cast<int>(e);
}

// the scan at `tile` elements a tile, one of kTiles
int scan_at(int tile, const void* x, void* y, void* scratch, int n,
            int elem_bytes, int is_max, int reverse, void* stream) {
  switch (tile) {
    case kTiles[0]:
      return dispatch<kTiles[0]>(x, y, scratch, n, elem_bytes, is_max,
                                 reverse, stream);
    case kTiles[1]:
      return dispatch<kTiles[1]>(x, y, scratch, n, elem_bytes, is_max,
                                 reverse, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of scratch that tplc_running_scan needs for n elements (enough
// for the smallest tile, so for every tile): none for one tile.
extern "C" int tplc_running_scan_scratch(int n) {
  return static_cast<int>(scratch_bytes((n + kTiles[0] - 1LL) / kTiles[0]));
}

// The elements a tile that tplc_running_scan takes for n elements on the
// current card (a negative cudaError if the card does not answer).
extern "C" int tplc_running_scan_tile(int n) {
  const int sms = sm_count();
  if (sms < 0) return -static_cast<int>(cudaGetLastError());
  int tile = kTiles[0];
  for (int t : kTiles)
    if (static_cast<long long>(n) / t >=
        static_cast<long long>(kTilesPerSm) * sms)
      tile = t;
  return tile;
}

// y = the inclusive running max (is_max) or min of x[0..n), from the left
// or (reverse) from the right; elem_bytes 4 (int32) or 8 (int64); x and y
// of n elements, scratch of tplc_running_scan_scratch(n) bytes, 16-byte
// aligned.  One kernel launch, and one cudaMemsetAsync past one tile.
extern "C" int tplc_running_scan(const void* x, void* y, void* scratch, int n,
                                 int elem_bytes, int is_max, int reverse,
                                 void* stream) {
  const int tile = tplc_running_scan_tile(n);
  return tile < 0 ? -tile
                  : scan_at(tile, x, y, scratch, n, elem_bytes, is_max,
                            reverse, stream);
}
