// The culzss encode's match search on Hopper (sm_90a): for each byte of
// each 4,096-byte packet, the longest run (capped at 32) against the
// 128 earlier bytes, and the nearest distance that gives it.
// Plain C entry point, loaded with ctypes by tpulc_torch/cuda_lib.py;
// the wrapper and plain PyTorch version live in
// tpulc_torch/codecs/lzss/culzss.py (`culzss_match`,
// `culzss_match_plain`).
//
// Replaces no pallas_call: tpulc's `_encode_packet`
// (tpulc/codecs/lzss/culzss.py:38-79) is XLA code that builds, for every
// packet, its equality rows against 128 shifted copies of itself and
// turns them into runs by five int8 doubling steps.  The port ran that
// as plain tensor ops: a [1,024, 128, 4,128] int8 tensor (0.54 GB) a
// group of packets, flipped, read and written several times a doubling
// step, ~20 GB of device traffic a group and ~0.69 s of a 100 MB
// compress on an H100.
//
// The function, for packet row x (after 128 spaces, followed by zeros):
//   best_len[i] = max over d = 1..128 of min(run_d(i), 32, d),
//   best_i[i]   = d - 1 of the first d that reaches it (0 if none does),
// where run_d(i) counts the k from 0 with x[i+k] == x[i+k-d].  A run may
// continue into the zero tail past the packet, as the plain version's
// does; the caller clamps the pick to the packet's end afterwards.
//
// Bound on the H100: operations.  A packet needs 4,096 x 128 byte
// compares and moves 4,096 bytes in and 8,192 out; at 100 MB that is
// ~12.8 G compares (0.19 ms at 67 T op/s) against 0.3 GB (0.09 ms at
// 3.35 TB/s).
//
// Design.
// - One block a packet, 256 threads.  The block stages the 128 spaces,
//   the packet (16-byte loads where the row is 16-byte aligned) and 32
//   zero bytes in shared memory, and nothing of the rows or runs ever
//   reaches device memory.
// - A warp takes the positions of one residue mod 4, so all its lanes
//   share one byte alignment: a thread's own 32 bytes are read once
//   into eight registers, and the bytes x[i-d .. i-d+3] for four
//   distances in a row come from a window of three shared words that
//   slides by one load each four distances, cut out by funnel shifts
//   whose amounts the compiler knows (the alignment is a template
//   argument).  Lanes read neighbouring words: no bank conflicts.
// - A distance is one XOR of four bytes.  It is looked at further only
//   when its first best + 1 bytes agree (best the position's longest
//   run so far, a mask kept beside it), since only then can it beat
//   best; on text almost every distance stops there.  A 4-byte match
//   extends word by word while the distance's cap min(d, 32) exceeds
//   both 4 and best, up to 32 bytes.  The distances go from nearest to
//   farthest and only a longer run replaces the pick, which gives the
//   nearest of the ties; a position stops once its run is 32.
// - The picks collect in shared memory and leave as 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPckt = 4096;
constexpr int kWin = 128;
constexpr int kCap = 32;                                  // longest run
constexpr int kThreads = 256;
constexpr int kStageWords = (kWin + kPckt + kCap) / 4;    // 1,064
constexpr int kRounds = kPckt / 4 / 32 / (kThreads / 128);  // 16 a thread

// the count of equal low bytes of x != 0 (x the XOR of two words)
__device__ __forceinline__ int equal_bytes(uint32_t x) {
  return (__ffs(static_cast<int>(x)) - 1) >> 3;
}

// mask of the low best + 1 bytes: a distance whose XOR has a bit there
// cannot beat best (all 32 bits once best >= 3: only a 4-byte match can)
__device__ __forceinline__ uint32_t need_mask(int best) {
  return best >= 3 ? 0xffffffffu : 0xffffffffu >> (24 - 8 * best);
}

// the run from byte r of sw's bytes against the thread's own words a[],
// given that their first 4 bytes agree: 4 to 32
__device__ __forceinline__ int extend(const uint32_t* sw, const uint32_t* a,
                                      int r) {
  const int rb = r >> 2;
  const int sh = 8 * (r & 3);
  int run = 4;
#pragma unroll
  for (int k = 1; k < kCap / 4; ++k) {
    const uint32_t x = a[k] ^ __funnelshift_r(sw[rb + k], sw[rb + k + 1], sh);
    if (x) return run + equal_bytes(x);
    run += 4;
  }
  return run;
}

// the pick of packet position p (p % 4 == C), from the staged bytes sw:
// byte q = kWin + p of the stage is x[p]
template <int C>
__device__ __forceinline__ void best_match(const uint32_t* sw, int p,
                                           int& best_out, int& bi_out) {
  const int b = (kWin + p - C) >> 2;   // the word holding x[p]
  uint32_t a[kCap / 4];                // x[p .. p+31]
#pragma unroll
  for (int k = 0; k < kCap / 4; ++k)
    a[k] = __funnelshift_r(sw[b + k], sw[b + k + 1], 8 * C);
  int best = 0, bi = 0;
  uint32_t need = need_mask(0);
  // the window: words b-m-1, b-m, b-m+1 at distances 4m+1 .. 4m+4
  uint32_t w1 = sw[b], w2 = sw[b + 1];
  for (int m = 0; m < kWin / 4 && best < kCap; ++m) {
    const uint32_t w0 = sw[b - m - 1];
#pragma unroll
    for (int j = 1; j <= 4; ++j) {
      // x[p-d .. p-d+3] is byte 4(b-m) + C - j of the stage on
      const uint32_t src = C >= j ? __funnelshift_r(w1, w2, 8 * (C - j))
                                  : __funnelshift_r(w0, w1, 8 * (C - j + 4));
      const uint32_t x = a[0] ^ src;
      if ((x & need) == 0) {
        const int d = 4 * m + j;
        const int cap = d < kCap ? d : kCap;
        int run = x ? equal_bytes(x)
                    : (cap > 4 && cap > best
                           ? extend(sw, a, 4 * (b - m) + C - j) : 4);
        run = run < cap ? run : cap;
        if (run > best) {
          best = run;
          bi = d - 1;
          need = need_mask(best);
        }
      }
    }
    w2 = w1;
    w1 = w0;
  }
  best_out = best;
  bi_out = bi;
}

// this thread's positions: warp w takes residue w % 4 and every other
// column of 32 lanes (w / 4 picks which), so p = 4 (32 j + lane) + C
template <int C>
__device__ __forceinline__ void match_positions(const uint32_t* sw,
                                                uint8_t* olen, uint8_t* oidx,
                                                int half, int lane) {
  for (int k = 0; k < kRounds; ++k) {
    const int p = 4 * (32 * (2 * k + half) + lane) + C;
    int best, bi;
    best_match<C>(sw, p, best, bi);
    olen[p] = static_cast<uint8_t>(best);
    oidx[p] = static_cast<uint8_t>(bi);
  }
}

__global__ void __launch_bounds__(kThreads)
    culzss_match_kernel(const uint8_t* __restrict__ packets,
                        uint8_t* __restrict__ best_len,
                        uint8_t* __restrict__ best_i, bool aligned) {
  __shared__ __align__(16) uint32_t sw[kStageWords];
  __shared__ __align__(16) uint8_t olen[kPckt];
  __shared__ __align__(16) uint8_t oidx[kPckt];
  const int t = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * kPckt;
  const uint8_t* in = packets + row;
  // spaces, the packet, zeros
  for (int k = t; k < kWin / 4; k += kThreads) sw[k] = 0x20202020u;
  for (int k = (kWin + kPckt) / 4 + t; k < kStageWords; k += kThreads)
    sw[k] = 0;
  auto* body = reinterpret_cast<uint4*>(sw + kWin / 4);
  if (aligned) {
    for (int k = t; k < kPckt / 16; k += kThreads)
      body[k] = reinterpret_cast<const uint4*>(in)[k];
  } else {
    auto* bytes = reinterpret_cast<uint8_t*>(sw + kWin / 4);
    for (int k = t; k < kPckt; k += kThreads) bytes[k] = in[k];
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  const int half = warp >> 2;
  switch (warp & 3) {
    case 0: match_positions<0>(sw, olen, oidx, half, lane); break;
    case 1: match_positions<1>(sw, olen, oidx, half, lane); break;
    case 2: match_positions<2>(sw, olen, oidx, half, lane); break;
    default: match_positions<3>(sw, olen, oidx, half, lane); break;
  }
  __syncthreads();
  for (int k = t; k < kPckt / 16; k += kThreads) {
    reinterpret_cast<uint4*>(best_len + row)[k] =
        reinterpret_cast<const uint4*>(olen)[k];
    reinterpret_cast<uint4*>(best_i + row)[k] =
        reinterpret_cast<const uint4*>(oidx)[k];
  }
}

}  // namespace

// packets: uint8[npackets, 4096]; best_len, best_i: uint8[npackets,
// 4096], 16-byte aligned.  One kernel launch, a block a packet.
extern "C" int tplc_culzss_match(const void* packets, void* best_len,
                                 void* best_i, int npackets, void* stream) {
  if (npackets < 0 || reinterpret_cast<uintptr_t>(best_len) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(best_i) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npackets == 0) return static_cast<int>(cudaGetLastError());
  culzss_match_kernel<<<npackets, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packets), static_cast<uint8_t*>(best_len),
      static_cast<uint8_t*>(best_i),
      reinterpret_cast<uintptr_t>(packets) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
