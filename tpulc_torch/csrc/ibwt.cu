// The anchored inverse-BWT lane walk on Hopper (sm_90a).
// Plain C entry points, loaded with ctypes by tpulc_torch/cuda_lib.py;
// the wrapper and plain PyTorch version live in
// tpulc_torch/codecs/bwt/ibwt_kernels.py.
//
// Replaces no pallas_call: tpulc runs the walk as one
// `jax.lax.fori_loop` of S steps over all lanes under XLA
// (tpulc/codecs/bwt/rotsort.py:375, tpulc/codecs/bwt/masked.py:235),
// writing an [S, R] step-major matrix that it transposes, flips and
// slices.  The port first ran it as a Python loop of S gathers and row
// copies (2,052 `index` and 2,164 copy launches a bz decompress of
// pg1661 x 6 on the H100) and an [S, R] int64 matrix (210 MB at a
// 25 MiB block).
//
// The function: lane j (j*S < n) starts at row anchors[j] and takes
// min(S, n - j*S) LF steps; step t reads the packed entry TL[p] =
// T[p] | last[p] << 32, writes the byte last[p] to out[n-1-j*S-t] and
// moves to p = T[p].  So each lane fills a contiguous run of out,
// going downwards.
//
// Bound on the H100: the chain of S dependent loads of a lane, one
// load's latency each (L2 for a bz block's 7.2 MB table, device memory
// for a 25 MiB block's 210 MB one); the n reads move n 32-byte sectors.
// Design: one thread a lane, and few lanes a warp: a warp's step waits
// for the slowest of its lanes' loads, so a warp carries the fewest
// lanes (a power of two, 1 to 32) that still fit every lane's warp in
// kWalkWarpsPerSm warps an SM (1 lane a warp at bz's 1,758 lanes, 8 at a
// 25 MiB block's 25,600 on 132 SMs); the other threads of the warp
// exit.  A step is one 8-byte load of the packed entry (the byte rides
// with the successor), which a first launch (`pack_kernel`) writes from
// T and last in one pass: 17 bytes an entry, where three torch
// elementwise ops moved ~45.  The bytes gather in a register, 8 at a time,
// and leave as one aligned 8-byte store; the partial words at the ends
// of a lane's run, which it may share with its neighbour lane, leave
// byte by byte.  No [S, R] matrix, no
// transpose, flip or slice.  A lane whose anchor is not a row of the
// table (a corrupt payload) writes zeros and reads nothing.
//
// `pointer_chase_kernel` is the measurement that prices one step: one
// thread follows `steps` dependent loads of a table of 8-byte entries
// (chip_smoke.py gives it a random cycle of the walk's table size).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWalkWarps = 4;   // a block
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kWalkWarpsPerSm = 32;

bool known_lanes_per_warp(int lpw) {
  return lpw >= 1 && lpw <= 32 && (lpw & (lpw - 1)) == 0;
}

// the fewest lanes a warp (a power of two) whose warps fit in
// kWalkWarpsPerSm an SM, else 32; -1 if the card does not answer
int walk_lanes_per_warp(int nlanes) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  int lpw = 1;
  while (lpw < 32 && (nlanes + lpw - 1) / lpw >
                         static_cast<long long>(sms) * kWalkWarpsPerSm)
    lpw *= 2;
  return lpw;
}

__device__ __forceinline__ void flush(uint8_t* __restrict__ out,
                                      uint64_t word, long long pos,
                                      long long lo, long long hi) {
  // word holds the bytes of out[w, w + 8), w = pos & ~7, from pos up to
  // the lane's end hi; [lo, hi) is the lane's run
  const long long w = pos & ~7LL;
  if (w >= lo && w + 8 <= hi) {
    *reinterpret_cast<uint64_t*>(out + w) = word;
  } else {
    const long long end = hi < w + 8 ? hi : w + 8;
    for (long long q = pos; q < end; ++q)
      out[q] = static_cast<uint8_t>(word >> (8 * (q - w)));
  }
}

// tl[i] = T[i] | last[i] << 32, a thread 8 entries a round (16-byte
// loads of T, an 8-byte load of last) while whole groups of 8 remain
constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
    pack_kernel(const uint64_t* __restrict__ T,
                const uint8_t* __restrict__ last, uint64_t* __restrict__ tl,
                long long cap, bool aligned) {
  const long long stride =
      static_cast<long long>(gridDim.x) * kPackThreads * 8;
  for (long long i = (static_cast<long long>(blockIdx.x) * kPackThreads +
                      threadIdx.x) * 8;
       i < cap; i += stride) {
    if (aligned && i + 8 <= cap) {
      const uint64_t b = *reinterpret_cast<const uint64_t*>(last + i);
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        ulonglong2 t = *reinterpret_cast<const ulonglong2*>(T + i + k);
        t.x |= ((b >> (8 * k)) & 0xff) << 32;
        t.y |= ((b >> (8 * (k + 1))) & 0xff) << 32;
        *reinterpret_cast<ulonglong2*>(tl + i + k) = t;
      }
    } else {
      for (long long q = i; q < cap && q < i + 8; ++q)
        tl[q] = T[q] | static_cast<uint64_t>(last[q]) << 32;
    }
  }
}

__global__ void __launch_bounds__(kWalkThreads)
    anchored_walk_kernel(const uint64_t* __restrict__ tl,
                         const int32_t* __restrict__ anchors,
                         uint8_t* __restrict__ out, int n, int S, int cap,
                         int nlanes, int lpw) {
  const int l = threadIdx.x & 31;
  const long long lane = (static_cast<long long>(blockIdx.x) * kWalkWarps +
                          (threadIdx.x >> 5)) * lpw + l;
  if (l >= lpw || lane >= nlanes) return;
  const int j = static_cast<int>(lane);
  const long long hi = static_cast<long long>(n) -
                       static_cast<long long>(j) * S;
  const int steps = hi < S ? static_cast<int>(hi) : S;
  const long long lo = hi - steps;
  uint32_t p = static_cast<uint32_t>(anchors[j]);
  const bool bad = p >= static_cast<uint32_t>(cap);
  uint64_t word = 0;
  for (int t = 0; t < steps; ++t) {
    const long long pos = hi - 1 - t;
    uint64_t b = 0;
    if (!bad) {
      const uint64_t e = __ldg(tl + p);
      p = static_cast<uint32_t>(e);
      b = (e >> 32) & 0xff;
    }
    word |= b << (8 * (pos & 7));
    if ((pos & 7) == 0 || t == steps - 1) {
      flush(out, word, pos, lo, hi);
      word = 0;
    }
  }
}

__global__ void pointer_chase_kernel(const uint64_t* __restrict__ table,
                                     int start, int steps,
                                     uint64_t* __restrict__ sink) {
  uint32_t p = static_cast<uint32_t>(start);
  uint64_t acc = 0;
  for (int t = 0; t < steps; ++t) {
    const uint64_t e = __ldg(table + p);
    p = static_cast<uint32_t>(e);
    acc += e >> 32;
  }
  *sink = acc + p;
}

}  // namespace

// The lanes a warp the walk picks for nlanes lanes on the current card
// (a negative cudaError if the card does not answer).
extern "C" int tplc_anchored_walk_lanes(int nlanes) {
  const int lpw = walk_lanes_per_warp(nlanes);
  return lpw > 0 ? lpw : -static_cast<int>(cudaGetLastError());
}

// T: int64[cap], the LF map (T < cap); last: uint8[cap]; tl: int64[cap]
// scratch for the packed entries T | last << 32, written here, or, if T
// is nullptr, already packed; anchors: int32[>= nlanes]; out: uint8[cap],
// of which this writes [0, n) (the caller zeroes the rest); nlanes =
// ceil(n / S); out 8-byte aligned; lanes_per_warp a power of two up to
// 32, or 0 for the walk's own pick
extern "C" int tplc_anchored_walk(const void* T, const void* last, void* tl,
                                  const void* anchors, void* out, int n,
                                  int S, int cap, int nlanes,
                                  int lanes_per_warp, void* stream) {
  if (n < 0 || S < 1 || cap < n || nlanes < 0 ||
      static_cast<long long>(nlanes) * S < n ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      (lanes_per_warp != 0 && !known_lanes_per_warp(lanes_per_warp)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nlanes > 0) {
    const int lpw =
        lanes_per_warp ? lanes_per_warp : walk_lanes_per_warp(nlanes);
    if (lpw < 0) return static_cast<int>(cudaGetLastError());
    auto* s = static_cast<cudaStream_t>(stream);
    if (T != nullptr) {
      const bool aligned = reinterpret_cast<uintptr_t>(T) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(last) % 8 == 0 &&
                           reinterpret_cast<uintptr_t>(tl) % 16 == 0;
      const long long groups = (static_cast<long long>(cap) + 7) / 8;
      const int blocks = static_cast<int>(
          (groups + kPackThreads - 1) / kPackThreads < 4096
              ? (groups + kPackThreads - 1) / kPackThreads
              : 4096);
      pack_kernel<<<blocks, kPackThreads, 0, s>>>(
          static_cast<const uint64_t*>(T), static_cast<const uint8_t*>(last),
          static_cast<uint64_t*>(tl), cap, aligned);
    }
    const long long warps = (static_cast<long long>(nlanes) + lpw - 1) / lpw;
    const int blocks = static_cast<int>((warps + kWalkWarps - 1) / kWalkWarps);
    anchored_walk_kernel<<<blocks, kWalkThreads, 0, s>>>(
        static_cast<const uint64_t*>(tl), static_cast<const int32_t*>(anchors),
        static_cast<uint8_t*>(out), n, S, cap, nlanes, lpw);
  }
  return static_cast<int>(cudaGetLastError());
}

// one thread, `steps` dependent loads of table (8-byte entries whose low
// 32 bits are the next index) from `start`; sink: one int64
extern "C" int tplc_pointer_chase(const void* table, int start, int steps,
                                  void* sink, void* stream) {
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(table), start, steps,
      static_cast<uint64_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
