// The adaptive binary coder's (bsc -e2 on the ST sorters) two serial
// walks for Hopper (sm_90a).  tpulc leaves them to XLA fori_loops
// (tpulc/codecs/bsclike/rans_adaptive.py: abc_encode's model pass,
// :228-263, and reverse rANS pass, :265-311; abc_decode's FSM,
// :314-445).  Wrappers and plain PyTorch versions:
// tpulc_torch/codecs/bsclike/abc_kernels.py (abc_encode_walk,
// abc_decode_walk, rcp_table, fsm_table).
//
// Encode: grid uint8[W, L] step-major (event t of lane l at t * L + l,
// (model + 1) * 2 + bit, 0 = no event), nbits int32[L] (lane l's events
// are t < nbits), inits int32[B, 117] in [0, 4096] (lane l starts from
// row l / lcap), rcp uint32[4097] (floor((2^32 - 1) / max(f, 1))),
// probs uint16[W + 64, L] scratch -> words int16[L, W+2] (uint16
// values; every entry written: the lane's words, then zeros), counts
// int64[L], states int64[L] (uint32 values).  Model pass, t ascending:
// p = the model's probability, then p += ((bit << 12) - p) >> 5 clipped
// to [8, 4088].  rANS pass, t descending from nbits-1 from x = 2^16: f
// = p or 4096 - p, c = 4096 - p or 0 (bit 1 or 0); when x >= f << 20
// (uint32) emit x's low 16 bits and shift x right by 16; then x = (x /
// f) << 12 + x % f + c mod 2^32 (divisor max(f, 1)).
//
// Decode: words int16[L, Wc], states int64[L] (uint32 values),
// lane_cls int32[L] in [0, 32) (c1 * 4 + c2 entering the lane), nsym
// int32[L], inits as above (any uint16), fsm uint32[1024, 2] -> out
// int32[L, chunk] (zeroed by the caller).  Up to `steps` steps (a
// multiple of 4), one bit each, while the lane has rebuilt fewer than
// nsym symbols: bit = (x & 4095) >= 4096 - p; x = f * (x >> 12) + slot
// - c mod 2^32 and, below 2^16, x = x << 16 | the next word (read at
// min(rpos, Wc - 1)); adapt; on a finished symbol write it and roll the
// contexts.
//
// What bounds both walks on the H100 is each lane's serial chain of
// steps, not bytes or operations: at pg1661 x 6's 1,024 lanes the card
// runs 32 warps, one on each of 32 SMs, and the deepest lane walks
// 6,843 events (twice on encode).  With one warp a scheduler nothing
// hides a stall, so a step costs its instructions as issued one after
// another: their count, their stalls, and both sides of every branch
// the 32 lanes take apart.  A direct loop spends 400-500 cycles a step
// on a shared-memory read-modify-write of the model (the next read
// could not pass the store), a 32-bit divide, the FSM's select chains,
// branches for the refill and the output, and an exposed load every
// 16 steps.
//
// This design keeps each step one straight run of instructions:
// - encode, model pass: a block table maps an event byte to its row's
//   offset and its record flags; the probability of event t+2 is read
//   before event t-1's adapted value is stored, and the adapted values
//   of t-1 and t-2 are forwarded in registers when the rows match, so a
//   step's chain is a select and the adaptation.  A record (p, the bit,
//   whether there is an event) is stored a step, so the rANS pass reads
//   no grid; a missing event codes f = 4096 with c = 0 and no emission,
//   which leaves x as it was without a select on the chain.
// - encode, rANS pass: x / f and x % f are a multiply-high by the
//   reciprocal from a table in shared memory and one correction; x = y
//   + c + q (4096 - f), plus 4096 - f when the estimate was one short.
//   Words are stored from the row's end down, so they land in stream
//   order, and one forward copy moves them to the front (no reversal).
//   The block then zeroes its rows' tails with 16-byte stores, so the
//   caller allocates `words` without a fill.
// - both passes prefetch two register batches of 32 steps in turn:
//   batch k+1 is in flight while batch k runs (16 left the loads
//   exposed at the soup shapes), at batch-relative 32-bit offsets from
//   pointers kept in registers (`opaque`: rebuilt from the arguments,
//   each address took ~10 instructions).
// - decode: the FSM is a host-built table (abc_kernels.fsm_table) over
//   states min(c1, 3) * 256 + nz * 128 + model: per state and bit the
//   next state, whether a symbol completes and which, and the mantissa
//   accumulator's move (a mantissa symbol's class is min(E + 1 + nz, 7),
//   so even its successor is in the table).  The block turns it into
//   one 16-byte entry a state: both successors' moves, each with its
//   model row's offset.  So one read a step brings the moves of both
//   next states and two more their model values, all a step ahead of
//   the bit, which only selects; the adapted value is forwarded when
//   the successor's model is the current one.  The next two words wait
//   in registers (`WordQueue`: one predicated 2-byte read a refill,
//   clamped at Wc - 1); eight steps run between checks of the lane's
//   end; a symbol leaves as one predicated 4-byte store (quads of four
//   in one 16-byte store were slower: the shifts and the branch around
//   the store outweighed the fewer stores).
// Lanes a block: a template argument, each lane's models in shared
// memory as int32 [117][lanes] (no bank conflicts whatever the models).
// The library holds the builds the wrappers take: encode at 32 lanes
// while one wave of blocks of 32 holds every lane, else at 64
// (tplc_abc_encode_lanes), decode at 32.  They won against encode at
// 128 lanes, decode at 64 and 128, and decode reading its words in
// 16-byte chunks.  Reached on an H100 (device ms at 1,024 / 25,600 /
// 51,200 lanes; PERF.md section 6): encode 0.5395 / 0.7946 / 1.0874 (a
// direct loop, the first design: 1.7089 / 2.5013 / 3.9423), decode
// 0.4535 / 0.5546 / 0.7004 (1.4198 / 1.5170 / 1.5702).  A step is still
// ~55 issued instructions (decode) and ~65 over both passes (encode),
// so the card spends ~130 and ~155 cycles on it, where the function's
// chain needs ~24 and ~26.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kModels = 117;
constexpr int kEncRows = kModels + 1;   // + a spare row for missing events
constexpr int kBatch = 32;
constexpr int kProbBits = 12;
constexpr uint32_t kScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kRcp = kScale + 1;        // reciprocals of f = 0..4096
constexpr int kFsm = 1024;              // FSM states (fsm_table)

// an encode record (probs scratch): the probability p (bits 0-12), the
// bit, whether there is an event
constexpr uint32_t kRecBit = 1u << 13;
constexpr uint32_t kRecValid = 1u << 14;

// an FSM move (abc_kernels.fsm_table): the next state (bits 0-9), a
// symbol completes (10), the symbol (11-12: 0, 1, 2, or 3 for a mantissa
// symbol, v1 + 1), v1 := 1 (13; else v1 := 2 v1 + bit)
constexpr uint32_t kMoveEmit = 1u << 10;
constexpr uint32_t kMoveVset = 1u << 13;

__device__ __forceinline__ int adapt(int p, int bit) {
  const int q = p + (((bit << kProbBits) - p) >> 5);
  return min(max(q, 8), static_cast<int>(kScale) - 8);
}

// Keeps v in a register: the compiler would rebuild it from the
// kernel's arguments at each use inside the walk.
template <typename T>
__device__ __forceinline__ T* opaque(T* v) {
  uint64_t u = reinterpret_cast<uint64_t>(v);
  asm volatile("" : "+l"(u));
  return reinterpret_cast<T*>(u);
}

template <int kLanes>
size_t encode_smem() {
  const size_t models = sizeof(int32_t) * (kEncRows * kLanes + 256);
  const size_t rcp = sizeof(uint32_t) * kRcp;
  return models > rcp ? models : rcp;
}

template <int kLanes>
size_t decode_smem() {
  return sizeof(int32_t) * kModels * kLanes + sizeof(uint4) * kFsm;
}

// ------------------------------------------------------------- encode

// The model pass's pipeline, rows as byte offsets into the lane's
// column: event t-1's row and adapted value, event t's row and value
// with t-2 and older forwarded, event t+1's row and shared-memory value
// (stores up to t-2).
struct ModelPipe {
  int mp, ap, mc, qc, mn, pn;
};

// Events t0 .. t0 + kBatch - 1 (0 from n on) from the batch's first,
// g (the lane's column at t0); L entries a step.
__device__ __forceinline__ void load_events(int (&e)[kBatch],
                                            const uint8_t* g, uint32_t L,
                                            int t0, int n) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    e[i] = t0 + i < n ? __ldg(g + i * L) : 0;
}

// Event t (its table entry: row offset << 16 | record flags), with e2
// = event t+2's entry; the record goes to *rec.
__device__ __forceinline__ void model_step(ModelPipe& s, char* p,
                                           uint32_t e, uint32_t e2,
                                           uint16_t* rec) {
  const int pt = s.mc == s.mp ? s.ap : s.qc;
  const int at = adapt(pt, (e >> 13) & 1);
  *rec = static_cast<uint16_t>(pt | (e & 0xFFFFu));
  const int qn = s.mn == s.mp ? s.ap : s.pn;
  *reinterpret_cast<int32_t*>(p + s.mp) = s.ap;   // event t-1's value,
  const int mnn = static_cast<int>(e2 >> 16);     // then event t+2's read
  const int pnn = *reinterpret_cast<int32_t*>(p + mnn);
  s.mp = s.mc;
  s.ap = at;
  s.mc = s.mn;
  s.qc = qn;
  s.mn = mnn;
  s.pn = pnn;
}

// A batch of events from e, the next batch en; records from pr (the
// lane's column at the batch's first step), L entries a step.
__device__ __forceinline__ void model_batch(ModelPipe& s, char* p,
                                            const uint32_t* evt,
                                            const int (&e)[kBatch],
                                            const int (&en)[kBatch],
                                            uint16_t* pr, uint32_t L) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const uint32_t e2 = evt[i + 2 < kBatch ? e[(i + 2) % kBatch]
                                           : en[(i + 2) % kBatch]];
    model_step(s, p, evt[e[i]], e2, pr + i * L);
  }
}

// Records t0, t0 - 1, ... (0 below step 0) from pr, the lane's column at
// t0.
__device__ __forceinline__ void load_records(uint32_t (&r)[kBatch],
                                             const uint16_t* pr, uint32_t L,
                                             int t0) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    r[i] = t0 - i >= 0 ? pr[-i * static_cast<int>(L)] : 0u;
}

// One rANS step on a record; an emitted word goes to row[--pos].  A
// record without an event codes f = 4096 with c = 0 and never emits,
// which leaves x as it was.
__device__ __forceinline__ void code_step(uint32_t r, const uint32_t* rcp,
                                          uint32_t& x, int& pos,
                                          uint16_t* row) {
  const uint32_t p = r & 0x1FFFu;
  const bool one = r & kRecBit, valid = r & kRecValid;
  const uint32_t f0 = kScale - p;
  const uint32_t f = valid ? (one ? p : f0) : kScale;
  const uint32_t c = one ? f0 : 0u;
  const uint32_t fx = max(f, 1u);
  const uint32_t g = kScale - fx;
  const uint32_t inv = rcp[min(f, kScale)];
  const bool emit = valid && x >= f << (32 - kProbBits);
  pos -= emit;
  if (emit) row[pos] = static_cast<uint16_t>(x);
  const uint32_t y = emit ? x >> 16 : x;
  // q = y / fx or one less; x = (q << 12) + y % fx + c = y + c + q g
  const uint32_t q = __umulhi(y, inv);
  const uint32_t xe = y + c + q * g;
  x = y + q * (0u - fx) >= fx ? xe + g : xe;
}

__device__ __forceinline__ void code_batch(const uint32_t (&r)[kBatch],
                                           const uint32_t* rcp, uint32_t& x,
                                           int& pos, uint16_t* row) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) code_step(r[i], rcp, x, pos, row);
}

// Zeroes row[0, n) with the block's kLanes threads: 2-byte stores up to
// the first 16-byte boundary and after the last, 16-byte stores between.
template <int kLanes>
__device__ __forceinline__ void zero_words(uint16_t* row, int n, int lt) {
  const int head = min(
      n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) &
                           15) >> 1));
  if (lt < head) row[lt] = 0;
  const int m = (n - head) >> 3;
  uint4* v = reinterpret_cast<uint4*>(row + head);
  for (int i = lt; i < m; i += kLanes) v[i] = make_uint4(0, 0, 0, 0);
  if (lt < ((n - head) & 7)) row[head + 8 * m + lt] = 0;
}

template <int kLanes>
__global__ void __launch_bounds__(kLanes)
abc_encode_kernel(const uint8_t* __restrict__ grid,
                  const int32_t* __restrict__ nbits,
                  const int32_t* __restrict__ inits,
                  const uint32_t* __restrict__ rcp_tab,
                  uint16_t* __restrict__ probs, uint16_t* __restrict__ words,
                  long long* __restrict__ counts,
                  long long* __restrict__ states, int W, int L, int lcap) {
  extern __shared__ int32_t smem[];
  __shared__ int tails[kLanes];   // each row's count: its zeros start there
  const int lt = threadIdx.x;
  const int l = blockIdx.x * kLanes + lt;
  const bool live = l < L;
  const size_t stride = static_cast<size_t>(L);
  const int n = live ? min(max(nbits[l], 0), W) : 0;
  uint16_t* row = opaque(words + static_cast<size_t>(l) * (W + 2));

  // each event byte's entry: its row's byte offset in a lane's column
  // (clip((e >> 1) - 1, 0, 116), the spare row 117 without an event)
  // << 16 | its record flags
  uint32_t* evt = reinterpret_cast<uint32_t*>(smem + kEncRows * kLanes);
  for (int e = lt; e < 256; e += kLanes) {
    const int r = e == 0 ? kModels : min(max((e >> 1) - 1, 0), kModels - 1);
    evt[e] = static_cast<uint32_t>(r * kLanes * 4) << 16 |
             (e == 0 ? 0u : kRecValid | ((e & 1) ? kRecBit : 0u));
  }
  __syncthreads();

  // model pass: p[row][lane] in shared memory; records into probs,
  // whose rows past W absorb a last batch's stores
  char* p = reinterpret_cast<char*>(smem + lt);
  const uint32_t L32 = static_cast<uint32_t>(L);
  uint16_t* pr = probs + l;
  if (n > 0) {
    const int32_t* init = inits + static_cast<size_t>(l / lcap) * kModels;
    for (int m = 0; m < kModels; ++m)
      reinterpret_cast<int32_t*>(p)[m * kLanes] = __ldg(init + m);
    reinterpret_cast<int32_t*>(p)[kModels * kLanes] = kScale / 2;
    const uint8_t* g = grid + l;
    const size_t batch = stride * kBatch;
    int ea[kBatch], eb[kBatch];
    load_events(ea, g, L32, 0, n);
    ModelPipe s;
    s.mp = kModels * kLanes * 4;
    s.ap = kScale / 2;
    s.mc = static_cast<int>(evt[ea[0]] >> 16);
    s.qc = *reinterpret_cast<int32_t*>(p + s.mc);
    s.mn = static_cast<int>(evt[ea[1]] >> 16);
    s.pn = *reinterpret_cast<int32_t*>(p + s.mn);
    uint16_t* rec = pr;
    for (int t0 = 0; t0 < n; t0 += 2 * kBatch) {
      load_events(eb, g + batch, L32, t0 + kBatch, n);
      model_batch(s, p, evt, ea, eb, rec, L32);
      if (t0 + kBatch >= n) break;
      load_events(ea, g + 2 * batch, L32, t0 + 2 * kBatch, n);
      model_batch(s, p, evt, eb, ea, rec + batch, L32);
      g += 2 * batch;
      rec += 2 * batch;
    }
  }

  // rANS pass: the reciprocals take the models' shared memory
  __syncthreads();
  uint32_t* rcp = reinterpret_cast<uint32_t*>(smem);
  for (int i = lt; i < kRcp; i += kLanes) rcp[i] = __ldg(rcp_tab + i);
  __syncthreads();
  int count = W + 2;   // a lane past L has no row to zero
  if (live) {
    uint32_t x = kRansL;
    int pos = W + 2;     // words land last emitted first
    if (n > 0) {
      const size_t batch = stride * kBatch;
      const uint16_t* rp = pr + static_cast<size_t>(n - 1) * stride;
      uint32_t ra[kBatch], rb[kBatch];
      load_records(ra, rp, L32, n - 1);
      for (int t0 = n - 1; t0 >= 0; t0 -= 2 * kBatch) {
        load_records(rb, rp - batch, L32, t0 - kBatch);
        code_batch(ra, rcp, x, pos, row);
        if (t0 - kBatch < 0) break;
        load_records(ra, rp - 2 * batch, L32, t0 - 2 * kBatch);
        code_batch(rb, rcp, x, pos, row);
        rp -= 2 * batch;
      }
    }
    // the words sit at [W + 2 - count, W + 2) in stream order: move them
    // to the front, 32 at a time (each batch read before it is written,
    // and the source lies ahead of the destination)
    count = W + 2 - pos;
    for (int i = 0; i < count; i += 32) {
      uint16_t v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = i + j < count ? row[pos + i + j] : 0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (i + j < count) row[i + j] = v[j];
    }
    counts[l] = count;
    states[l] = x;
  }

  // every row's [count, W + 2) is zeroed by the whole block, once each
  // lane has moved its words out of it
  tails[lt] = count;
  __syncthreads();
  const int rows = min(kLanes, L - static_cast<int>(blockIdx.x) * kLanes);
  for (int r = 0; r < rows; ++r) {
    const size_t first = static_cast<size_t>(blockIdx.x * kLanes + r);
    zero_words<kLanes>(words + first * (W + 2) + tails[r], W + 2 - tails[r],
                       lt);
  }
}

// ------------------------------------------------------------- decode

// *a = x when pred, as one predicated store (no branch for a warp whose
// lanes disagree).
__device__ __forceinline__ void store_if(int32_t* a, bool pred, int x) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p st.global.s32 [%0], %1;\n\t}" ::"l"(a), "r"(x),
      "r"(static_cast<int>(pred))
      : "memory");
}

// A lane's word stream: the next two words in registers, one
// predicated 2-byte read a refill; a read past the row returns word
// Wc - 1.
struct WordQueue {
  const uint16_t* row;
  int last, qi;        // Wc - 1; q1's column
  uint32_t q0, q1;

  __device__ __forceinline__ void open(const uint16_t* r, int Wc) {
    row = opaque(r);
    last = Wc - 1;
    qi = min(1, last);
    q0 = row[0];
    q1 = row[qi];
  }
  __device__ __forceinline__ uint32_t peek() const { return q0; }
  __device__ __forceinline__ void advance(bool take) {
    if (take) {   // predicated: the next word moves up, one more is read
      q0 = q1;
      qi = min(qi + 1, last);
      q1 = __ldg(row + qi);
    }
  }
};

// A lane of the decode walk in registers (its models in shared memory
// at p, the successors' moves at next, its output row o), one bit a
// step.  A move as the kernel holds it: fsm_table's move, and the byte
// offset of its state's model row in a lane's column in bits 16-31.
template <int kLanes>
struct DecodeLane {
  static constexpr int kRowShift = kLanes == 32 ? 7 : (kLanes == 64 ? 8 : 9);
  char* p;
  const uint4* next;   // per state: both successors' moves
  int32_t* o;
  int n;
  uint32_t x;
  int pm, moff;        // the current model's value and row offset
  uint2 T;             // the current state's moves
  int m0, m1, P0, P1;  // both successors' row offsets and values
  uint4 T01;           // and moves, read a step ahead
  WordQueue in;
  uint32_t v1;
  int sym_i;

  static __device__ __forceinline__ uint32_t with_row(uint32_t mv) {
    return mv | ((mv & 127) << kRowShift) << 16;
  }

  __device__ __forceinline__ void ahead(uint32_t k) {
    m0 = static_cast<int>(T.x >> 16);
    m1 = static_cast<int>(T.y >> 16);
    P0 = *reinterpret_cast<int32_t*>(p + m0);
    P1 = *reinterpret_cast<int32_t*>(p + m1);
    T01 = next[k];
  }

  // One step: the bit picks the state's outcome of x and of the FSM,
  // each computed or read before it; a finished symbol past nsym does
  // not leave the lane.
  __device__ __forceinline__ void step() {
    const uint32_t up = static_cast<uint32_t>(pm);
    const uint32_t f0 = kScale - up;
    const uint32_t slot = x & (kScale - 1);
    const uint32_t hi = x >> kProbBits;
    const bool bit = slot >= f0;
    x = bit ? up * hi + (slot - f0) : f0 * hi + slot;
    const bool need = x < kRansL;
    x = need ? (x << 16) | in.peek() : x;
    in.advance(need);
    const int a = adapt(pm, bit);
    *reinterpret_cast<int32_t*>(p + moff) = a;
    const uint32_t mv = bit ? T.y : T.x;
    const int mn = bit ? m1 : m0;
    pm = mn == moff ? a : (bit ? P1 : P0);
    moff = mn;
    T = bit ? make_uint2(T01.z, T01.w) : make_uint2(T01.x, T01.y);
    v1 = (mv & kMoveVset) ? 1u : (v1 << 1) | bit;
    const bool emit = (mv & kMoveEmit) && sym_i < n;
    const int kind = (mv >> 11) & 3;
    store_if(o + sym_i, emit, kind == 3 ? static_cast<int>(v1) + 1 : kind);
    sym_i += emit;
    ahead(mv & 1023);
  }
};

template <int kLanes>
__global__ void __launch_bounds__(kLanes)
abc_decode_kernel(const uint16_t* __restrict__ words,
                  const long long* __restrict__ states,
                  const int32_t* __restrict__ lane_cls,
                  const int32_t* __restrict__ nsym,
                  const int32_t* __restrict__ inits,
                  const uint2* __restrict__ fsm_tab,
                  int32_t* __restrict__ out, int Wc, int L, int lcap,
                  int chunk, int steps) {
  using Lane = DecodeLane<kLanes>;
  extern __shared__ int32_t smem[];
  uint4* next = reinterpret_cast<uint4*>(smem + kModels * kLanes);
  const int lt = threadIdx.x;
  for (int i = lt; i < kFsm; i += kLanes) {
    const uint2 t = __ldg(fsm_tab + i);
    const uint2 a = __ldg(fsm_tab + (t.x & 1023));
    const uint2 b = __ldg(fsm_tab + (t.y & 1023));
    next[i] = make_uint4(Lane::with_row(a.x), Lane::with_row(a.y),
                         Lane::with_row(b.x), Lane::with_row(b.y));
  }
  __syncthreads();
  const int l = blockIdx.x * kLanes + lt;
  if (l >= L) return;
  Lane d;
  d.n = min(max(nsym[l], 0), chunk);
  if (d.n == 0 || steps <= 0) return;
  d.p = reinterpret_cast<char*>(smem + lt);
  const int32_t* init = inits + static_cast<size_t>(l / lcap) * kModels;
  for (int m = 0; m < kModels; ++m)
    reinterpret_cast<int32_t*>(d.p)[m * kLanes] = __ldg(init + m);
  d.next = next;
  d.in.open(words + static_cast<size_t>(l) * Wc, Wc);
  d.o = opaque(out + static_cast<size_t>(l) * chunk);
  d.x = static_cast<uint32_t>(states[l]);
  // the FSM state: min(c1, 3) * 256 + model (E0's is c1 * 4 + c2)
  const int cls = min(max(lane_cls[l], 0), 31);
  const uint32_t k = min(cls >> 2, 3) * 256 + cls;
  d.moff = cls << Lane::kRowShift;
  d.pm = *reinterpret_cast<int32_t*>(d.p + d.moff);
  const uint2 moves = __ldg(fsm_tab + k);
  d.T = make_uint2(Lane::with_row(moves.x), Lane::with_row(moves.y));
  d.ahead(k);
  d.v1 = 0;
  d.sym_i = 0;
  // steps is a multiple of 4: eight steps a turn and four at the end,
  // the lane's end checked once a turn (a step past it changes no
  // output)
  int t = 0;
  for (; t + 8 <= steps && d.sym_i < d.n; t += 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) d.step();
  }
  if (t < steps && d.sym_i < d.n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d.step();
  }
}

template <int kLanes>
int launch_encode(const void* grid, const void* nbits, const void* inits,
                  const void* rcp, void* probs, void* words, void* counts,
                  void* states, int W, int L, int lcap, cudaStream_t stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = encode_smem<kLanes>();
  cudaError_t err = cudaFuncSetAttribute(
      abc_encode_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  abc_encode_kernel<kLanes><<<(L + kLanes - 1) / kLanes, kLanes, smem,
                              stream>>>(
      static_cast<const uint8_t*>(grid), static_cast<const int32_t*>(nbits),
      static_cast<const int32_t*>(inits), static_cast<const uint32_t*>(rcp),
      static_cast<uint16_t*>(probs), static_cast<uint16_t*>(words),
      static_cast<long long*>(counts), static_cast<long long*>(states), W, L,
      lcap);
  return static_cast<int>(cudaGetLastError());
}

template <int kLanes>
int launch_decode(const void* words, const void* states,
                  const void* lane_cls, const void* nsym, const void* inits,
                  const void* fsm, void* out, int Wc, int L, int lcap,
                  int chunk, int steps, cudaStream_t stream) {
  if ((steps & 3) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = decode_smem<kLanes>();
  cudaError_t err = cudaFuncSetAttribute(
      abc_decode_kernel<kLanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  abc_decode_kernel<kLanes><<<(L + kLanes - 1) / kLanes, kLanes, smem,
                              stream>>>(
      static_cast<const uint16_t*>(words),
      static_cast<const long long*>(states),
      static_cast<const int32_t*>(lane_cls),
      static_cast<const int32_t*>(nsym), static_cast<const int32_t*>(inits),
      static_cast<const uint2*>(fsm), static_cast<int32_t*>(out), Wc, L,
      lcap, chunk, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The encode kernel's lanes a block for L lanes on the current card:
// 32 while one wave of blocks of 32 holds them all, else 64 (of 32, 64
// and 128, the fastest at each of the -e2 path's three shapes on an
// H100, PERF.md section 6), or a negative cudaError.
extern "C" int tplc_abc_encode_lanes(int L) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, abc_encode_kernel<32>, 32, encode_smem<32>());
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (L + 31) / 32 <= sms * per_sm ? 32 : 64;
}

// The wrappers' builds: encode at tplc_abc_encode_lanes(L) lanes a
// block; decode at 32, `steps` a multiple of 4.
extern "C" int tplc_abc_encode(const void* grid, const void* nbits,
                               const void* inits, const void* rcp,
                               void* probs, void* words, void* counts,
                               void* states, int W, int L, int lcap,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = tplc_abc_encode_lanes(L);
  if (lanes == 32)
    return launch_encode<32>(grid, nbits, inits, rcp, probs, words, counts,
                             states, W, L, lcap, s);
  if (lanes == 64)
    return launch_encode<64>(grid, nbits, inits, rcp, probs, words, counts,
                             states, W, L, lcap, s);
  return -lanes;
}

extern "C" int tplc_abc_decode(const void* words, const void* states,
                               const void* lane_cls, const void* nsym,
                               const void* inits, const void* fsm, void* out,
                               int Wc, int L, int lcap, int chunk, int steps,
                               void* stream) {
  return launch_decode<32>(words, states, lane_cls, nsym, inits, fsm, out,
                           Wc, L, lcap, chunk, steps,
                           static_cast<cudaStream_t>(stream));
}
