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
// min(S, n - j*S) LF steps; step t writes the byte last[p] to
// out[n-1-j*S-t] and moves to p = T[p].  So each lane fills a
// contiguous run of out, going downwards.  A lane whose anchor is not
// a row of [0, n) (a corrupt payload) reads nothing and writes zeros.
//
// Bound on the H100: the chain of S dependent loads of a lane, one
// load's latency each (L2 for a bz block's table, device memory for
// most of a 25 MiB block's); the n reads move n 32-byte sectors.
//
// Design.
// - A table entry is the successor row alone, T[p] as a uint32 (3.6 MB
//   at bz, 105 MB at a 25 MiB block, half the 8-byte T | last << 32 of
//   the first design; the 50 MB L2 holds about half of the larger).
//   The byte is recovered from the successor: T is a stable LF map,
//   T[p] = C[L[p]] + occ(L[p], p) with C the cumulative byte counts of
//   last[:n], so L[p] is the c with C[c] <= T[p] < C[c+1].  The search
//   runs over C in shared memory: 15 compares against C[16], ..., C[240]
//   held in registers pick 16 candidates, 4 halving steps over shared
//   memory pick one.  Every row in [0, n) maps into [0, n), so the
//   search never sees a padding row.
// - The next load first: a step issues the load of the next entry,
//   T[e], as soon as e arrives, then searches e's byte, shifts it into
//   the word and stores; so the search rides under the load and stays
//   off the dependent chain.  Each lane makes one load past its last
//   step (a row of [0, n), never outside the table).  In the compiled
//   word loop (cuobjdump -sass, CUDA 12.8) the first step's load issues
//   at 0x0fe0 (int32 anchors; 0x1050 with int64); compares of its
//   search, which need only e, fill the wait; the next step's load,
//   which waits only on the first, issues at 0x10b0 (0x1140), before
//   the rest of the search; each later load of the eight sits among
//   the earlier steps' compares and shared-memory reads.
// - The bytes gather in a register, 8 at a time, and leave as one
//   aligned 8-byte store; the partial words at the ends of a lane's
//   run, which it may share with its neighbour lane, leave byte by
//   byte.
// - The counts: a first launch (`count_kernel`) reads last[:n] once
//   (16 bytes a thread a round, a shared histogram a warp) into 256
//   global counts that one cudaMemsetAsync cleared; it also writes the
//   zeros of out[n, cap).  Each walk block turns the counts into C in
//   shared memory (one warp's scan).  1 byte read an entry, where the
//   first design's packing read 9 and wrote 8.
// - Lanes: one thread a lane, and few lanes a warp: a warp's step waits
//   for the slowest of its lanes' loads, so a warp carries the fewest
//   lanes (a power of two, 2 to 32) that still fit every lane's warp in
//   kWalkWarpsPerSm warps an SM; the other threads of the warp exit
//   after the block has built C.  Every choice measured at both shapes
//   on an H100 (PERF.md section 6): at bz (1,758 lanes, the
//   table in L2) 2 lanes a warp beat 1 by ~16 % (a step's ~55 issued
//   instructions, not its load, set the pace of 13 one-lane warps an
//   SM), and at a 25 MiB block (25,596 lanes) 8 was best, as in the
//   first design.  At pg1661 x 6's 4 MiB bsc block (581 lanes, 4 warps
//   an SM) 1 beats the pick of 2 by ~2 %, not worth a second rule.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWalkWarps = 4;   // a block
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kWalkWarpsPerSm = 32;
constexpr int kCountThreads = 256;
constexpr int kCountWarps = kCountThreads / 32;

bool known_lanes_per_warp(int lpw) {
  return lpw >= 1 && lpw <= 32 && (lpw & (lpw - 1)) == 0;
}

// the current card's SM count, read once a device (-1 if the card does
// not answer): the count launch's grid and the lanes a warp use it on
// every call
int sm_count() {
  static std::atomic<int> cached[64];   // 0: not read yet
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < 64 && (sms = cached[dev].load(std::memory_order_relaxed)) > 0)
    return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  if (dev < 64) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// the fewest lanes a warp (a power of two, at least 2) whose warps fit
// in kWalkWarpsPerSm an SM, else 32; -1 if the card does not answer
int walk_lanes_per_warp(int nlanes) {
  const int sms = sm_count();
  if (sms < 0) return -1;
  int lpw = 2;
  while (lpw < 32 && (nlanes + lpw - 1) / lpw >
                         static_cast<long long>(sms) * kWalkWarpsPerSm)
    lpw *= 2;
  return lpw;
}

// counts[c] += the c bytes of last[0, n) (a shared histogram a warp,
// 16-byte loads a thread where whole aligned groups remain); zeros over
// out[n, cap)
__global__ void __launch_bounds__(kCountThreads)
    count_kernel(const uint8_t* __restrict__ last, int n,
                 uint32_t* __restrict__ counts, uint8_t* __restrict__ out,
                 int cap, bool aligned) {
  __shared__ uint32_t hist[kCountWarps][256];
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kCountWarps * 256; i += kCountThreads)
    (&hist[0][0])[i] = 0;
  __syncthreads();
  const long long tid =
      static_cast<long long>(blockIdx.x) * kCountThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kCountThreads;
  uint32_t* h = hist[warp];
  for (long long i = tid * 16; i < n; i += stride * 16) {
    if (aligned && i + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(last + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          atomicAdd(&h[(w[k] >> (8 * b)) & 0xff], 1u);
    } else {
      for (long long q = i; q < n && q < i + 16; ++q)
        atomicAdd(&h[last[q]], 1u);
    }
  }
  for (long long q = n + tid; q < cap; q += stride) out[q] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < 256; c += kCountThreads) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kCountWarps; ++w) s += hist[w][c];
    if (s) atomicAdd(&counts[c], s);
  }
}

// the byte of the row whose successor is e: the c with C[c] <= e <
// C[c+1]; c16[i] = C[16 (i + 1)]
__device__ __forceinline__ uint32_t byte_of(uint32_t e,
                                            const uint32_t (&c16)[15],
                                            const uint32_t* __restrict__ C) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 15; ++i) c += c16[i] <= e ? 16u : 0u;
#pragma unroll
  for (uint32_t s = 8; s >= 1; s >>= 1)
    if (C[c + s] <= e) c += s;
  return c;
}

template <typename A>   // the anchors' type: int32_t or int64_t
__global__ void __launch_bounds__(kWalkThreads)
    anchored_walk_kernel(const uint32_t* __restrict__ T,
                         const uint32_t* __restrict__ counts,
                         const A* __restrict__ anchors,
                         uint8_t* __restrict__ out, int n, int S,
                         int nlanes, int lpw) {
  __shared__ uint32_t C[257];
  if (threadIdx.x < 32) {
    // C[c] = counts[0, c): lane l sums counts[8l, 8l + 8), the warp
    // scans the sums
    const int l = threadIdx.x;
    uint32_t v[8], s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = counts[8 * l + k];
      s += v[k];
    }
    uint32_t inc = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(0xffffffffu, inc, d);
      if (l >= d) inc += o;
    }
    uint32_t run = inc - s;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      C[8 * l + k] = run;
      run += v[k];
    }
    if (l == 31) C[256] = run;
  }
  __syncthreads();
  const int l = threadIdx.x & 31;
  const long long lane = (static_cast<long long>(blockIdx.x) * kWalkWarps +
                          (threadIdx.x >> 5)) * lpw + l;
  if (l >= lpw || lane >= nlanes) return;
  const int j = static_cast<int>(lane);
  const long long hi = static_cast<long long>(n) -
                       static_cast<long long>(j) * S;
  const long long lo = hi - (hi < S ? hi : S);
  const long long a = anchors[j];
  long long pos = hi;   // the next byte goes to out[pos - 1]
  if (a < 0 || a >= n) {
    for (; pos > lo; --pos) out[pos - 1] = 0;
    return;
  }
  const uint32_t p = static_cast<uint32_t>(a);
  uint32_t c16[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) c16[i] = C[16 * (i + 1)];
  uint32_t e = __ldg(T + p);
  // the head: byte by byte up to an 8-byte boundary
  for (; pos > lo && (pos & 7) != 0; --pos) {
    const uint32_t nx = __ldg(T + e);
    out[pos - 1] = static_cast<uint8_t>(byte_of(e, c16, C));
    e = nx;
  }
  // whole words, the step writing out[pos - 1] first (the word's top byte)
  for (; pos - 8 >= lo; pos -= 8) {
    uint64_t word = 0;
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      const uint32_t nx = __ldg(T + e);
      word |= static_cast<uint64_t>(byte_of(e, c16, C)) << (8 * k);
      e = nx;
    }
    *reinterpret_cast<uint64_t*>(out + pos - 8) = word;
  }
  // the tail, byte by byte
  for (; pos > lo; --pos) {
    const uint32_t nx = __ldg(T + e);
    out[pos - 1] = static_cast<uint8_t>(byte_of(e, c16, C));
    e = nx;
  }
}

}  // namespace

// The lanes a warp the walk picks for nlanes lanes on the current card
// (a negative cudaError if the card does not answer).
extern "C" int tplc_anchored_walk_lanes(int nlanes) {
  const int lpw = walk_lanes_per_warp(nlanes);
  return lpw > 0 ? lpw : -static_cast<int>(cudaGetLastError());
}

// T: int32[cap], the LF map (T[:n] a permutation of [0, n)); last:
// uint8[cap]; counts: int32[256] scratch for the byte counts of
// last[:n], cleared and counted here; anchors: >= nlanes entries of
// anchor_bytes (4: int32, 8: int64); out: uint8[cap], 8-byte aligned;
// nlanes = ceil(n / S); lanes_per_warp a power of two up to 32, or 0
// for the walk's own pick.  One cudaMemsetAsync and two kernel launches.
extern "C" int tplc_anchored_walk(const void* T, const void* last,
                                  void* counts, const void* anchors,
                                  int anchor_bytes, void* out, int n, int S,
                                  int cap, int nlanes, int lanes_per_warp,
                                  void* stream) {
  if (n < 0 || S < 1 || cap < n || nlanes < 0 ||
      static_cast<long long>(nlanes) * S < n ||
      (anchor_bytes != 4 && anchor_bytes != 8) ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      (lanes_per_warp != 0 && !known_lanes_per_warp(lanes_per_warp)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  if (sms < 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(counts, 0, 256 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (static_cast<long long>(cap) + 15) / 16;
  const long long want = (work + kCountThreads - 1) / kCountThreads;
  const int blocks = static_cast<int>(
      want < 2LL * sms ? (want > 0 ? want : 1) : 2LL * sms);
  count_kernel<<<blocks, kCountThreads, 0, s>>>(
      static_cast<const uint8_t*>(last), n, static_cast<uint32_t*>(counts),
      static_cast<uint8_t*>(out), cap,
      reinterpret_cast<uintptr_t>(last) % 16 == 0);
  if (nlanes > 0) {
    const int lpw =
        lanes_per_warp ? lanes_per_warp : walk_lanes_per_warp(nlanes);
    if (lpw < 0) return static_cast<int>(cudaGetLastError());
    const long long warps = (static_cast<long long>(nlanes) + lpw - 1) / lpw;
    const int grid = static_cast<int>((warps + kWalkWarps - 1) / kWalkWarps);
    const auto* t = static_cast<const uint32_t*>(T);
    const auto* c = static_cast<const uint32_t*>(counts);
    auto* o = static_cast<uint8_t*>(out);
    if (anchor_bytes == 8)
      anchored_walk_kernel<<<grid, kWalkThreads, 0, s>>>(
          t, c, static_cast<const int64_t*>(anchors), o, n, S, nlanes, lpw);
    else
      anchored_walk_kernel<<<grid, kWalkThreads, 0, s>>>(
          t, c, static_cast<const int32_t*>(anchors), o, n, S, nlanes, lpw);
  }
  return static_cast<int>(cudaGetLastError());
}
