// bsc coder 1's two serial walks, the order-2 context rANS encode and
// decode, for Hopper (sm_90a).  tpulc leaves both to XLA
// (tpulc/codecs/bsclike/rans.py: rans_encode_ctx_batch and
// rans_decode_ctx_batch, fori_loops over the 512 steps of a lane).
// Wrappers and plain PyTorch versions: tpulc_torch/codecs/bsclike/
// rans.py (rans_encode_walk, rans_decode_walk, rcp_table).
//
// Lanes are block-major: lane l belongs to bsc block b = l / nlanes,
// whose NCTX = 32 contexts are the table rows [32 b, 32 b + 32) of S
// symbols each (packed entries cum | freq << 14).
//
// Encode: idx int32[C, L] step-major (table entry ctx * S + sym of step
// j of lane l, inside its block's rows), nsym int32[L], fc int32 packed
// table, rcp uint32[2^14 + 1] (floor((2^32 - 1) / max(f, 1))) -> words
// int16[L, C+2] (uint16 values, every entry written: the lane's words
// in stream order, then zeros), counts int64[L], states int64[L]
// (uint32 values).  Lane l starts at x = 2^16 and walks j = nsym-1 down
// to 0: when f < 2^14 and x >= f << 18 it emits x's low 16 bits and
// shifts x right by 16; then x = (x / f) << 14 + x % f + c, mod 2^32
// (divisor max(f, 1)).  The decoder reads the words last emitted first.
//
// Decode: words int16[L, C+2], states int64[L] (uint32 values), fctx
// int64[L] (the context entering the lane, in its block's [32 b, 32 b +
// 32); the kernel takes it modulo 32 within the block), nsym int32[L],
// fc as above, whose tables each sum to 2^14 -> out int32[L, C].  Step
// j < nsym: slot = x & (2^14 - 1), s = the symbol of slot (the first s
// with cum + freq > slot, slot_table's rule), x = f * (x >> 14) + slot -
// c mod 2^32, and when x < 2^16 it takes the next word (read at
// min(rpos, C+1)); out = s and the context becomes class(s) * 4 +
// min(k >> 2, 3).  Steps at or past nsym write 0.
//
// Bound on the H100: each lane is a chain of dependent steps; the bytes
// (the valid steps' entries, the words, the outputs) take 0.0005-0.13
// ms at the -e1 path's shapes, the chain of a 512-step lane ~0.006 ms.
// The first kernels lost 20-40 times that to the step itself: decode
// waited on two dependent reads in L2 (the 1 MiB slot table of a bsc
// block, then the packed entry) and wrote the zero rows of the lanes
// with nsym 0 one row a thread (1.21 of its 1.26 ms at the soup shape);
// encode ran a 32-bit divide a step, reversed the row it had written
// and needed a zero-filled words tensor.  This design:
// - a CUDA block's lanes all belong to one bsc block (the grid is bsc
//   blocks x ceil(nlanes / lanes)), and the block stages that bsc
//   block's 32 contexts in shared memory with at least 256 (encode) or
//   512 (decode) threads, the walk then left to its lanes; a block
//   whose lanes all have nsym 0 stages nothing and only writes zeros;
// - decode: each context's present symbols (f > 0) in symbol order as
//   8 bytes (f - 2^14, and c | s << 14 | class(s) * 4 << 23, so that x'
//   = (f - 2^14) (x >> 14) + x - c is one multiply-add and a subtract),
//   and per 32-slot bucket a mask of the slots where a present symbol
//   starts and the count of starts before the bucket (plus the
//   context's base).  The symbol of a slot is entry count + popc(mask &
//   the bucket's slots up to it) - 1: two shared-memory reads a step
//   and no search.  Built from fc alone (the slot table is not read): a
//   warp a context, its row's reads in flight, a ballot a 32 symbols
//   listing the present ones and setting their start bits, a warp scan
//   for the counts;
// - decode: the next word is one 2-byte read ahead in registers (L1
//   holds the row's line); symbols leave 8 at a time as two 16-byte
//   stores; the rows of lanes with nsym 0 are zeroed by the block with
//   16-byte stores along the rows;
// - encode: each staged entry carries its reciprocal (rcp_table), so x
//   / f is a multiply-high and one correction (x = y + c + q (2^14 -
//   f), plus 2^14 - f when the estimate was one short); a batch's only
//   global read is the coalesced idx row, two register batches in turn,
//   and a missing step codes f = 2^14, c = 0, which never emits and
//   leaves x;
// - encode: words go to the lane's row in shared memory from its end
//   down, so they land in stream order; the block then writes every
//   row of its lanes once, the words moved to the front and zeros
//   after, with 4-byte stores along the rows, 8 in flight a thread (no
//   reversal, no fill).
// Lanes a block (tplc_rans_encode_lanes, tplc_rans_decode_lanes): the
// largest of 128 / 512 down to 32 that still gives every SM a block;
// encode's register batches are 16 steps at 32 and 64 lanes, 32 at
// 128.  They won against encode at 32, 64 and 128 lanes with batches of
// 16 and 32, and decode at 32-512 lanes, with 16-byte word chunks, and
// reading one fused 8-byte global entry a context and slot in place of
// the staged tables.  Reached on an H100 (device ms at pg1661 x 6 / the
// 100 MB soup; the first kernels' in brackets; PERF.md section 6):
// encode 0.0309 / 0.1740 (0.1327 / 0.3460), decode 0.0680 / 0.2853
// (0.1967 / 1.2639).  A decode step still costs ~220 cycles at one warp
// an SM (two dependent shared-memory reads, a popc and ~10 dependent
// integer operations), and 512 lanes an SM walk at ~50 cycles a
// warp-step; an encode step ~95.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbBits = 14;
constexpr uint32_t kScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kNctx = 32;
constexpr int kBuckets = kScale >> 5;       // 32-slot buckets a context
constexpr int kMaxSyms = 512;               // S the kernels take
// the reciprocal of f = 2^14, a missing step's
constexpr uint32_t kRcpScale = 0xFFFFFFFFu / kScale;

// Keeps v in a register: the compiler would rebuild it from the
// kernel's arguments at each use inside the walk.
template <typename T>
__device__ __forceinline__ T* opaque(T* v) {
  uint64_t u = reinterpret_cast<uint64_t>(v);
  asm volatile("" : "+l"(u));
  return reinterpret_cast<T*>(u);
}

__device__ __forceinline__ int ctx_class(int s) {
  return (s >= 1) + (s >= 2) + (s >= 3) + (s >= 4) + (s >= 6) + (s >= 10) +
         (s >= 18);
}

// The CUDA block's place: bsc block b, its lanes [first, first + rows)
// of L, lane lt at first + lt when lt < rows.
struct Place {
  int b, rows;
  long long first;

  __device__ __forceinline__ Place(int L, int nlanes, int lanes) {
    const int chunks = (nlanes + lanes - 1) / lanes;
    b = static_cast<int>(blockIdx.x) / chunks;
    const int c0 = (static_cast<int>(blockIdx.x) - b * chunks) * lanes;
    first = static_cast<long long>(b) * nlanes + c0;
    rows = static_cast<int>(min(static_cast<long long>(min(lanes,
                                                           nlanes - c0)),
                                static_cast<long long>(L) - first));
  }
};

// Zeroes p[0, n) (4-byte words) with the block's threads: 4-byte stores
// up to the first 16-byte boundary and after the last, 16-byte between.
__device__ __forceinline__ void zero_words32(uint32_t* p, long long n,
                                             int lt, int threads) {
  const long long head = min(
      n, static_cast<long long>(
             ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
  if (lt < head) p[lt] = 0;
  const long long m = (n - head) >> 2;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (long long i = lt; i < m; i += threads) v[i] = make_uint4(0, 0, 0, 0);
  if (lt < ((n - head) & 3)) p[head + 4 * m + lt] = 0;
}

// ------------------------------------------------------------- encode

// Threads a block: the walking lanes, and at least 256 (encode) or 512
// (decode) to stage the tables, the others leaving the walk to the
// lanes.
template <int kLanes>
__host__ __device__ constexpr int encode_threads() {
  return kLanes > 256 ? kLanes : 256;
}

template <int kLanes>
__host__ __device__ constexpr int decode_threads() {
  return kLanes > 512 ? kLanes : 512;
}

size_t encode_smem(int lanes, int C, int S) {
  return sizeof(uint2) * kNctx * S + 2 * static_cast<size_t>(lanes) *
         (C + 2) + sizeof(int) * lanes;
}

// idx of steps j0, j0 - 1, ..., j0 - kBatch + 1 from p (the lane's
// column at j0), -1 below step 0.
template <int kBatch>
__device__ __forceinline__ void load_idx(int (&t)[kBatch], const int32_t* p,
                                         int L, int j0) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    t[i] = j0 - i >= 0 ? __ldg(p - i * L) : -1;
}

// One step on a staged entry (packed, reciprocal); an emitted word goes
// to row[--pos].
__device__ __forceinline__ void code_step(uint2 en, uint32_t& x, int& pos,
                                          uint16_t* row) {
  const uint32_t f = en.x >> kProbBits;
  const uint32_t c = en.x & (kScale - 1);
  const uint32_t fx = max(f, 1u);
  const uint32_t g = kScale - fx;
  const bool emit = f < kScale && x >= (f << (32 - kProbBits));
  pos -= emit;
  if (emit) row[pos] = static_cast<uint16_t>(x);
  const uint32_t y = emit ? x >> 16 : x;
  // q = y / fx or one less; x = (q << 14) + y % fx + c = y + c + q g
  const uint32_t q = __umulhi(y, en.y);
  const uint32_t xe = y + c + q * g;
  x = y - q * fx >= fx ? xe + g : xe;
}

// The steps of a batch's idx t (the block's entries at ent, span of
// them), -1 for a missing step.
template <int kBatch>
__device__ __forceinline__ void code_batch(const int (&t)[kBatch],
                                           const uint2* ent, int lo,
                                           uint32_t span, uint32_t& x,
                                           int& pos, uint16_t* row) {
  uint2 e[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const uint32_t loc = min(static_cast<uint32_t>(t[i] - lo), span - 1);
    e[i] = t[i] >= 0 ? ent[loc] : make_uint2(kScale << kProbBits, kRcpScale);
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) code_step(e[i], x, pos, row);
}

template <int kLanes, int kBatch>
__global__ void __launch_bounds__(encode_threads<kLanes>())
rans_encode_kernel(const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ nsym,
                   const int32_t* __restrict__ fc,
                   const uint32_t* __restrict__ rcp,
                   uint16_t* __restrict__ words,
                   long long* __restrict__ counts,
                   long long* __restrict__ states, int C, int L, int S,
                   int nlanes) {
  constexpr int kThreads = encode_threads<kLanes>();
  extern __shared__ uint2 smem[];
  const int span = kNctx * S;
  uint2* ent = smem;
  uint16_t* rows_sm = reinterpret_cast<uint16_t*>(smem + span);
  int* tails = reinterpret_cast<int*>(rows_sm + kLanes * (C + 2));
  const Place at(L, nlanes, kLanes);
  const int lt = threadIdx.x;
  const bool live = lt < at.rows;
  const long long l = at.first + lt;
  const int n = live ? min(max(nsym[l], 0), C) : 0;
  const int W = C + 2;

  if (!__syncthreads_or(n > 0)) {
    if (live) {
      counts[l] = 0;
      states[l] = kRansL;
    }
    zero_words32(reinterpret_cast<uint32_t*>(words + at.first * W),
                 static_cast<long long>(at.rows) * W / 2, lt, kThreads);
    return;
  }
  // the bsc block's entries, each with its reciprocal: 32 of each read
  // in flight a thread
  const int32_t* fcb = fc + static_cast<size_t>(at.b) * span;
  for (int i0 = lt; i0 < span; i0 += 32 * kThreads) {
    uint32_t e[32], r[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int i = i0 + u * kThreads;
      e[u] = i < span ? static_cast<uint32_t>(__ldg(fcb + i)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 32; ++u)
      r[u] = __ldg(rcp + min(e[u] >> kProbBits, kScale));
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int i = i0 + u * kThreads;
      if (i < span) ent[i] = make_uint2(e[u], r[u]);
    }
  }
  __syncthreads();

  uint32_t x = kRansL;
  int pos = W;   // words land last emitted first, from the row's end
  if (n > 0) {
    uint16_t* row = rows_sm + lt * W;
    const int32_t* p = opaque(idx + static_cast<size_t>(n - 1) * L + l);
    const int lo = at.b * span;
    const size_t batch = static_cast<size_t>(L) * kBatch;
    int ta[kBatch], tb[kBatch];
    load_idx<kBatch>(ta, p, L, n - 1);
    for (int j0 = n - 1; j0 >= 0; j0 -= 2 * kBatch) {
      load_idx<kBatch>(tb, p - batch, L, j0 - kBatch);
      code_batch<kBatch>(ta, ent, lo, span, x, pos, row);
      if (j0 - kBatch < 0) break;
      load_idx<kBatch>(ta, p - 2 * batch, L, j0 - 2 * kBatch);
      code_batch<kBatch>(tb, ent, lo, span, x, pos, row);
      p -= 2 * batch;
    }
  }
  const int count = W - pos;
  if (live) {
    counts[l] = count;
    states[l] = x;
  }
  if (lt < kLanes) tails[lt] = count;
  __syncthreads();
  // every row once, its words moved to the front and zeros after: the
  // rows' 4-byte pairs in order, 8 a thread in flight (row r = pair i /
  // (W / 2) as a multiply-high, exact for i < 2^32 / W)
  const int W2 = W / 2;
  const int total = at.rows * W2;
  const uint32_t magic = 0xFFFFFFFFu / W2 + 1;
  uint32_t* dst = reinterpret_cast<uint32_t*>(words + at.first * W);
  for (int i0 = lt; i0 < total; i0 += 8 * kThreads) {
    uint32_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = min(i0 + u * kThreads, total - 1);
      const int r = static_cast<int>(__umulhi(static_cast<uint32_t>(i),
                                              magic));
      const int col = 2 * (i - r * W2);
      const int cnt = tails[r];
      const uint16_t* src = rows_sm + r * W + (W - cnt);
      v[u] = (col < cnt ? static_cast<uint32_t>(src[col]) : 0u) |
             (col + 1 < cnt ? static_cast<uint32_t>(src[col + 1]) : 0u)
                 << 16;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * kThreads < total) dst[i0 + u * kThreads] = v[u];
  }
}

// ------------------------------------------------------------- decode

size_t decode_smem(int lanes, int S) {
  return (sizeof(uint32_t) + sizeof(uint16_t)) * kNctx * kBuckets +
         sizeof(uint2) * kNctx * S + sizeof(int) * (lanes + kNctx);
}

// The bsc block's staged tables: per context k and bucket u, mask[k *
// kBuckets + u] (bit r: a present symbol starts at slot 32 u + r) and
// first[k * kBuckets + u] (k * S + the starts before the bucket); per
// present symbol i of context k in symbol order, ent[k * S + i] = (f -
// 2^14 mod 2^32, c | s << 14 | class(s) * 4 << 23).  Symbol of slot:
// ent[first + popc(mask & bits 0..r) - 1], and x' = (f - 2^14) (x >>
// 14) + x - c = f (x >> 14) + slot - c.
struct DecodeTables {
  uint32_t* mask;
  uint16_t* first;
  uint2* ent;
  int* present;   // each context's count of present symbols

  __device__ __forceinline__ DecodeTables(void* smem, int S, int lanes) {
    mask = static_cast<uint32_t*>(smem);
    first = reinterpret_cast<uint16_t*>(mask + kNctx * kBuckets);
    ent = reinterpret_cast<uint2*>(first + kNctx * kBuckets);
    present = reinterpret_cast<int*>(ent + kNctx * S) + lanes;
  }

  // Zeroes the masks: before the block's first barrier, so that build
  // can set their bits at once.
  template <int kThreads>
  __device__ __forceinline__ void clear() {
    uint4* m4 = reinterpret_cast<uint4*>(mask);
    for (int i = threadIdx.x; i < kNctx * kBuckets / 4; i += kThreads)
      m4[i] = make_uint4(0, 0, 0, 0);
  }

  // Built by the block's kThreads threads from the bsc block's rows of
  // fc (contexts from R on stay empty), the masks cleared: a warp a
  // context, its row's reads in flight and the next context's under
  // them; a ballot a 32 symbols lists the present ones and sets their
  // start bits; then a scan a context gives the starts before each
  // bucket.
  template <int kThreads>
  __device__ __forceinline__ void build(const int32_t* fc, int S, int R,
                                        int b) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int kWarps = kThreads / 32;
    constexpr int kRounds = kMaxSyms / 32;
    const int rows = max(min(kNctx, R - b * kNctx), 0);
    const int rounds = (S + 31) >> 5;
    const int32_t* fcb = fc + static_cast<size_t>(b) * kNctx * S;
    uint32_t e[kRounds], en[kRounds];
    auto load = [&](uint32_t(&v)[kRounds], int k) {
#pragma unroll
      for (int t = 0; t < kRounds; ++t)
        v[t] = k < rows && t < rounds && t * 32 + lane < S
                   ? static_cast<uint32_t>(__ldg(fcb + k * S + t * 32 + lane))
                   : 0u;
    };
    load(e, warp);
    for (int k = warp; k < kNctx; k += kWarps) {
      load(en, k + kWarps);
      int count = 0;
#pragma unroll
      for (int t = 0; t < kRounds; ++t) {
        if (t >= rounds) break;
        const uint32_t f = e[t] >> kProbBits;
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, f != 0);
        if (f != 0) {
          const int s = t * 32 + lane;
          const uint32_t c = e[t] & (kScale - 1);
          ent[k * S + count + __popc(bal & ((1u << lane) - 1))] = make_uint2(
              f - kScale, c | static_cast<uint32_t>(s) << 14 |
                              static_cast<uint32_t>(ctx_class(s) * 4) << 23);
          atomicOr(mask + k * kBuckets + (c >> 5), 1u << (c & 31));
        }
        count += __popc(bal);
      }
      if (lane == 0) present[k] = count;
#pragma unroll
      for (int t = 0; t < kRounds; ++t) e[t] = en[t];
    }
    __syncthreads();
    // the starts before each bucket: a warp a context, 64 buckets a
    // round (two a lane), the rounds' scans interleaved
    for (int k = warp; k < kNctx; k += kWarps) {
      const uint2* m2 = reinterpret_cast<const uint2*>(mask + k * kBuckets);
      uint32_t* f2 = reinterpret_cast<uint32_t*>(first + k * kBuckets);
      int a[kBuckets / 64], v[kBuckets / 64];
#pragma unroll
      for (int t = 0; t < kBuckets / 64; ++t) {
        const uint2 m = m2[t * 32 + lane];
        a[t] = __popc(m.x);
        v[t] = a[t] + __popc(m.y);
      }
      int run = k * S;
#pragma unroll
      for (int t = 0; t < kBuckets / 64; ++t) {
        int incl = v[t];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          incl += lane >= d ? o : 0;
        }
        const uint32_t lo = static_cast<uint32_t>(run + incl - v[t]);
        f2[t * 32 + lane] = lo | (lo + a[t]) << 16;
        run += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
    }
    __syncthreads();
  }
};

// A lane's word stream: the next word one 2-byte read ahead (L1 holds
// the row's line).  A read past the row takes word C + 1.
struct WordOne {
  const uint16_t* w;
  int last, rpos;
  uint32_t wn;

  __device__ __forceinline__ void open(const uint16_t* row, int C) {
    w = opaque(row);
    last = C + 1;
    rpos = 0;
    wn = w[0];
  }
  __device__ __forceinline__ uint32_t peek() const { return wn; }
  __device__ __forceinline__ void advance(bool take) {
    if (take) {
      ++rpos;
      wn = __ldg(w + min(rpos, last));
    }
  }
};

// A lane of the decode walk in registers.
struct DecodeLane {
  WordOne in;
  uint32_t x;
  int k;               // the context, 0..31 within the bsc block

  __device__ __forceinline__ void open(const uint16_t* row, int C,
                                       uint32_t state, int ctx) {
    in.open(row, C);
    x = state;
    k = ctx;
  }

  // One step from the staged tables -> the symbol.
  __device__ __forceinline__ int step(const uint32_t* mask,
                                     const uint16_t* first,
                                     const uint2* ent1) {
    const uint32_t slot = x & (kScale - 1);
    const int u = k * kBuckets + static_cast<int>(slot >> 5);
    const uint32_t m = mask[u];
    const uint2* e = ent1 + first[u];
    const uint2 en = e[__popc(m & (0xFFFFFFFFu >> (~slot & 31)))];
    x = en.x * (x >> kProbBits) + x - (en.y & (kScale - 1));
    const bool need = x < kRansL;
    x = need ? (x << 16) | in.peek() : x;
    in.advance(need);
    k = (static_cast<int>(en.y >> 23) + min(k >> 2, 3)) & (kNctx - 1);
    return static_cast<int>((en.y >> 14) & (kMaxSyms - 1));
  }
};

// Lane l's walk into its row o: groups of 8 symbols while all 8 are
// valid, then one predicated group, then the row's zeros.  step(d) ->
// the next symbol.
template <class Step>
__device__ __forceinline__ void walk_lane(DecodeLane& d, int4* o, int n,
                                          int C, Step step) {
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    int s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = step(d);
    o[j >> 2] = make_int4(s[0], s[1], s[2], s[3]);
    o[(j >> 2) + 1] = make_int4(s[4], s[5], s[6], s[7]);
  }
  if (j < n) {   // the steps past n run too but write 0 (j < n <= C - 4)
    int s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = step(d);
      s[i] = j + i < n ? v : 0;
    }
    o[j >> 2] = make_int4(s[0], s[1], s[2], s[3]);
    if (j + 8 <= C) o[(j >> 2) + 1] = make_int4(s[4], s[5], s[6], s[7]);
    j += 8;
  }
  for (; j < C; j += 4) o[j >> 2] = make_int4(0, 0, 0, 0);
}

// Zeroes the rows of the block's lanes with nsym 0 (nsh: each lane's
// nsym), 16-byte stores along each row by the whole block.
template <int kThreads>
__device__ __forceinline__ void zero_rows(const Place& at, const int* nsh,
                                          int32_t* out, int C) {
  const int lt = threadIdx.x;
  for (int r = 0; r < at.rows; ++r) {
    if (nsh[r] > 0) continue;
    int4* o = reinterpret_cast<int4*>(out + (at.first + r) * C);
    for (int q = lt; q < C / 4; q += kThreads) o[q] = make_int4(0, 0, 0, 0);
  }
}

template <int kLanes>
__global__ void __launch_bounds__(decode_threads<kLanes>())
rans_decode_kernel(const uint16_t* __restrict__ words,
                   const long long* __restrict__ states,
                   const long long* __restrict__ fctx,
                   const int32_t* __restrict__ nsym,
                   const int32_t* __restrict__ fc, int32_t* __restrict__ out,
                   int C, int L, int S, int R, int nlanes) {
  constexpr int kThreads = decode_threads<kLanes>();
  extern __shared__ uint2 smem[];
  DecodeTables tab(smem, S, kLanes);
  int* nsh = reinterpret_cast<int*>(tab.ent + kNctx * S);
  const Place at(L, nlanes, kLanes);
  const int lt = threadIdx.x;
  const long long l = at.first + lt;
  const int n = lt < at.rows ? min(max(nsym[l], 0), C) : 0;
  if (lt < kLanes) nsh[lt] = n;
  tab.clear<kThreads>();
  const int walking = __syncthreads_count(n > 0);
  if (walking == 0) {   // no table: the rows are zeros
    zero_words32(reinterpret_cast<uint32_t*>(out + at.first * C),
                 static_cast<long long>(at.rows) * C, lt, kThreads);
    return;
  }
  if (walking < at.rows) zero_rows<kThreads>(at, nsh, out, C);
  tab.build<kThreads>(fc, S, R, at.b);
  if (n > 0) {
    DecodeLane d;
    d.open(words + l * (C + 2), C, static_cast<uint32_t>(states[l]),
           static_cast<int>((fctx[l] - static_cast<long long>(at.b) * kNctx)
                            & (kNctx - 1)));
    const uint32_t* mask = tab.mask;
    const uint16_t* first = tab.first;
    const uint2* ent1 = tab.ent - 1;
    walk_lane(d, reinterpret_cast<int4*>(out + l * C), n, C,
              [&](DecodeLane& dl) {
                return dl.step(mask, first, ent1);
              });
  }
}

// ------------------------------------------------------------ launches

int grid_of(int L, int nlanes, int lanes) {
  return ((L + nlanes - 1) / nlanes) * ((nlanes + lanes - 1) / lanes);
}

template <int kLanes, int kBatch>
int launch_encode(const void* idx, const void* nsym, const void* fc,
                  const void* rcp, void* words, void* counts, void* states,
                  int C, int L, int S, int nlanes, cudaStream_t stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = encode_smem(kLanes, C, S);
  cudaError_t err = cudaFuncSetAttribute(
      rans_encode_kernel<kLanes, kBatch>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rans_encode_kernel<kLanes, kBatch><<<grid_of(L, nlanes, kLanes),
                                       encode_threads<kLanes>(), smem,
                                       stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nsym),
      static_cast<const int32_t*>(fc), static_cast<const uint32_t*>(rcp),
      static_cast<uint16_t*>(words), static_cast<long long*>(counts),
      static_cast<long long*>(states), C, L, S, nlanes);
  return static_cast<int>(cudaGetLastError());
}

template <int kLanes>
int launch_decode(const void* words, const void* states, const void* fctx,
                  const void* nsym, const void* fc, void* out, int C, int L,
                  int S, int R, int nlanes, cudaStream_t stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = decode_smem(kLanes, S);
  cudaError_t err = cudaFuncSetAttribute(
      rans_decode_kernel<kLanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rans_decode_kernel<kLanes><<<grid_of(L, nlanes, kLanes),
                               decode_threads<kLanes>(), smem, stream>>>(
      static_cast<const uint16_t*>(words),
      static_cast<const long long*>(states),
      static_cast<const long long*>(fctx), static_cast<const int32_t*>(nsym),
      static_cast<const int32_t*>(fc), static_cast<int32_t*>(out), C, L, S,
      R, nlanes);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int C, int S, int nlanes) {
  return C >= 4 && C % 4 == 0 && S >= 1 && S <= kMaxSyms && nlanes >= 1;
}

// The largest of lanes = most, most / 2, ..., 32 a block that still
// gives every SM a block (32 when none does).
int pick_lanes(int L, int nlanes, int most) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -static_cast<int>(cudaGetLastError());
  int lanes = most;
  while (lanes > 32 && grid_of(L, nlanes, lanes) < sms) lanes >>= 1;
  return lanes;
}

}  // namespace

// The encode kernel's lanes a block for L lanes of nlanes a bsc block,
// C steps and S symbols a table: 128, 64 or 32, the largest that gives
// every SM a block and whose rows fit in shared memory (32 lanes the
// fastest at pg1661 x 6's 2,048 lanes, 128 at the soup's 204,800,
// PERF.md section 6), or a negative cudaError.
extern "C" int tplc_rans_encode_lanes(int L, int nlanes, int C, int S) {
  if (!shapes_ok(C, S, nlanes))
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int lanes = 128;
  while (lanes >= 32 && encode_smem(lanes, C, S) > static_cast<size_t>(most))
    lanes >>= 1;
  if (lanes < 32) return -static_cast<int>(cudaErrorInvalidValue);
  return pick_lanes(L, nlanes, lanes);
}

// The decode kernel's lanes a block for L lanes of nlanes a bsc block:
// 512, 256, 128, 64 or 32, the largest that gives every SM a block (32
// the fastest at pg1661 x 6, 512 at the soup, PERF.md section 6), or a
// negative cudaError.
extern "C" int tplc_rans_decode_lanes(int L, int nlanes, int S) {
  if (!shapes_ok(4, S, nlanes))
    return -static_cast<int>(cudaErrorInvalidValue);
  return pick_lanes(L, nlanes, 512);
}

extern "C" int tplc_rans_encode(const void* idx, const void* nsym,
                                const void* fc, const void* rcp, void* words,
                                void* counts, void* states, int C, int L,
                                int S, int nlanes, void* stream) {
  if (!shapes_ok(C, S, nlanes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // register batches of 16 steps at 32 and 64 lanes, 32 at 128 (the
  // fastest at each shape of the -e1 path, PERF.md section 6)
  const int lanes = tplc_rans_encode_lanes(L, nlanes, C, S);
  if (lanes == 128)
    return launch_encode<128, 32>(idx, nsym, fc, rcp, words, counts, states,
                                  C, L, S, nlanes, s);
  if (lanes == 64)
    return launch_encode<64, 16>(idx, nsym, fc, rcp, words, counts, states,
                                 C, L, S, nlanes, s);
  if (lanes == 32)
    return launch_encode<32, 16>(idx, nsym, fc, rcp, words, counts, states,
                                 C, L, S, nlanes, s);
  return -lanes;
}

extern "C" int tplc_rans_decode(const void* words, const void* states,
                                const void* fctx, const void* nsym,
                                const void* fc, void* out, int C, int L,
                                int S, int R, int nlanes, void* stream) {
  if (!shapes_ok(C, S, nlanes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = tplc_rans_decode_lanes(L, nlanes, S);
  switch (lanes) {
#define TPLC_DEC(N)                                                         \
  case N:                                                                   \
    return launch_decode<N>(words, states, fctx, nsym, fc, out, C, L, S, R, \
                            nlanes, s);
    TPLC_DEC(32) TPLC_DEC(64) TPLC_DEC(128) TPLC_DEC(256) TPLC_DEC(512)
#undef TPLC_DEC
    default:
      return -lanes;
  }
}

