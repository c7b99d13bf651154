"""Chunk-interleaved static order-2 context rANS, bsc's coder 1 (port of
`tpulc/codecs/bsclike/rans.py`; words, counts, states and symbols
bit-identical).

The symbol stream (RLE2 symbols of the BWT + MTF ranks, alphabet 257)
is cut into CHUNK-symbol lanes, each coded by an independent 32-bit
rANS state with 14-bit quantised frequencies and 16-bit renormalisation
(at most one word a symbol).  Symbol t is coded under one of NCTX = 32
static tables, picked by the rank classes of symbols t-1 and t-2; the
decoder regenerates the context from the symbols it has decoded, and
the container stores the context entering each lane.  Blocks are
batched: B blocks' tables stack as [B * NCTX, S] and each block's
context ids are offset by block * NCTX, so one walk codes every lane
of every block.

The frequency normalisation and the table builders are tpulc's host
numpy, copied.  tpulc's two 512-step `fori_loop`s (`rans.py:388-412`,
`:458-480`) are hand kernels on the card (`csrc/rans_ctx.cu`, one
thread a lane, a CUDA block's lanes in one bsc block, whose 32
contexts it stages in shared memory; design notes there):
`rans_encode_walk` and `rans_decode_walk` launch them for CUDA tensors
(one more on the wrapper's `launches`) and run their plain versions for
CPU tensors.  The C entry points pick the lanes a block.  The encode
kernel reads `rcp_table` (host-built reciprocals: no divide) and writes
every entry of `words`, which the wrapper allocates without a fill; the
decode kernel finds a slot's symbol from the packed table alone (so
it takes `lut` to be `slot_table` of the same tables).  The plain
versions,
`rans_encode_walk_plain` and `rans_decode_walk_plain`, walk step-major
(each step reads one contiguous row of [CHUNK, lanes]) with the uint32
state in int64, masked to 32 bits where tpulc's uint32 wraps.
`compact_words` is a boolean-mask select of the padded rows (tpulc
sorts on a 2^30 sentinel, a TPU device); `expand_words` is tpulc's
gather.  tpulc's context-free `rans_encode` / `rans_decode` are not
ported: no driver reaches them.

Words travel as int16 tensors holding uint16 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch import cuda_lib
from tpulc_torch.utils import timing

# 14-bit quantisation: each present symbol of the 257-symbol alphabet
# takes at least one slot
PROB_BITS = 14
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
CHUNK = 512
M32 = 0xFFFFFFFF

_C1 = 8   # rank-class buckets of sym t-1
_C2 = 4   # coarse buckets of sym t-2
NCTX = _C1 * _C2

_CTX_EDGES = (1, 2, 3, 4, 6, 10, 18)  # rank-class buckets (geometric)


# ------------------------------------------------- host tables (numpy)

def normalize_freqs(freqs: np.ndarray) -> np.ndarray:
    """Quantize frequencies to sum 2^PROB_BITS, every present sym >= 1."""
    freqs = np.asarray(freqs, np.int64)
    total = freqs.sum()
    if total == 0:
        out = np.zeros_like(freqs)
        out[0] = PROB_SCALE
        return out.astype(np.int32)
    scaled = np.maximum((freqs * PROB_SCALE) // total, np.where(freqs > 0, 1, 0))
    # fix rounding drift by adjusting the largest symbol
    drift = PROB_SCALE - scaled.sum()
    scaled[np.argmax(scaled)] += drift
    assert scaled.sum() == PROB_SCALE and (scaled[freqs > 0] > 0).all()
    return scaled.astype(np.int32)


def build_tables(freq_q: np.ndarray):
    """(freq, cum, slot->sym LUT) device tables from quantized freqs."""
    cum = np.concatenate([[0], np.cumsum(freq_q)[:-1]]).astype(np.int32)
    lut = np.zeros(PROB_SCALE, np.int32)
    for s in np.flatnonzero(freq_q):
        lut[cum[s]: cum[s] + freq_q[s]] = s
    return freq_q.astype(np.int32), cum, lut


def normalize_freqs_ctx(hists: np.ndarray) -> np.ndarray:
    """[NCTX, S] raw counts -> [NCTX, S] tables each summing 2^PROB_BITS."""
    return np.stack([normalize_freqs(h) for h in hists])


def build_tables_ctx(freq_q: np.ndarray):
    """[NCTX, S] quantized freqs -> stacked (freq, cum, slot LUT) device
    tables; LUT is [NCTX * 2^PROB_BITS] (ctx-major)."""
    fs, cs, ls = [], [], []
    for k in range(freq_q.shape[0]):
        f, c, l = build_tables(freq_q[k])
        fs.append(f)
        cs.append(c)
        ls.append(l)
    return np.stack(fs), np.stack(cs), np.concatenate(ls)


# ------------------------------------------------------------- contexts

def ctx_class(s: torch.Tensor) -> torch.Tensor:
    """Map an RLE2 symbol (0..256) to its order-1 class (0.._C1-1)."""
    c = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    for e in _CTX_EDGES:
        c += s >= e
    return c


def ctx_combine(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """(class(sym t-1), class(sym t-2)) -> context id (0..NCTX-1)."""
    return c1 * _C2 + c2.clamp(max=_C2 - 1)


def ctx_of_stream(syms: torch.Tensor) -> torch.Tensor:
    """Per-position order-2 context (class 0 history at t<=1)."""
    prev = torch.cat([syms.new_zeros(1), syms[:-1]])
    prev2 = torch.cat([syms.new_zeros(2), syms[:-2]])
    return ctx_combine(ctx_class(prev), ctx_class(prev2))


# --------------------------------------------------------- device tables

def packed_table(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """[R, S] tables -> int32[R * S] entries ``cum | freq << PROB_BITS``
    (one gather a step instead of two; freq reaches 2^14, 15 bits)."""
    return (cum.to(torch.int32) | (freq.to(torch.int32) << PROB_BITS)) \
        .reshape(-1).contiguous()


def slot_table(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """[R, S] tables -> slot->symbol LUT int16[R * 2^PROB_BITS]:
    symbol(slot) = #{s : cum[s] + freq[s] <= slot}, tpulc's
    `_lut_from_freqs` (`driver.py:890-905`) as one batched
    searchsorted (its broadcast compare would materialise [R, 2^14,
    S] here)."""
    R = freq.shape[0]
    ends = (cum.to(torch.int64) + freq.to(torch.int64)).contiguous()
    slots = torch.arange(PROB_SCALE, device=freq.device).expand(
        R, PROB_SCALE).contiguous()
    return torch.searchsorted(ends, slots, right=True).to(
        torch.int16).reshape(-1)


def rcp_table() -> np.ndarray:
    """The encode kernel's reciprocals: entry f (0..2^14) is
    floor((2^32 - 1) / max(f, 1)) as uint32, so that for any uint32 x
    q = (x * rcp[f]) >> 32 is x // max(f, 1) or one less."""
    f = np.maximum(np.arange(PROB_SCALE + 1, dtype=np.uint64), 1)
    return (np.uint64(M32) // f).astype(np.uint32)


_RCP: dict = {}


def _rcp(dev: torch.device) -> torch.Tensor:
    """`rcp_table` as int32 on dev, made once a device."""
    if dev not in _RCP:
        _RCP[dev] = timing.upload(rcp_table().view(np.int32), dev)
    return _RCP[dev]


# symbols a context the kernels take (shared memory, and s with its
# class in 16 bits)
MAX_SYMS = 512


def _lane_counts(ms, B: int, nlanes: int, chunk: int,
                 dev: torch.device) -> torch.Tensor:
    """Valid symbols of each lane (block-major) -> int32[B * nlanes]: a
    block's position p is valid while p < ms[block]."""
    ms_t = timing.upload(torch.as_tensor(ms, dtype=torch.int64),
                         dev).reshape(B, 1)
    pos0 = torch.arange(nlanes, device=dev) * chunk
    return (ms_t - pos0).clamp(0, chunk).reshape(-1).to(torch.int32)


# ---------------------------------------------------------------- encode

def rans_encode_walk_plain(idx: torch.Tensor, nsym: torch.Tensor,
                           fc: torch.Tensor):
    """The encode walk, step-major.  idx int32[C, L] (table entry
    ``ctx * S + sym`` of step j of lane l), nsym int32[L] (lane l codes
    steps j < nsym[l]), fc int32 packed table -> (words int16[L, C+2]
    (uint16 values, the lane's first `counts` words in stream order,
    then zeros), counts int64[L], states int64[L] (uint32 values)).
    Each lane walks j = C-1 down to 0 from the state RANS_L."""
    C, L = idx.shape
    dev = idx.device
    e = fc.to(torch.int64)[idx.to(torch.int64)]
    valid = torch.arange(C, device=dev)[:, None] < nsym.to(torch.int64)
    # a step past nsym becomes f = PROB_SCALE, c = 0: it never emits and
    # leaves x as it was, exactly tpulc's masked step
    f = torch.where(valid, e >> PROB_BITS, PROB_SCALE)
    c = torch.where(valid, e & (PROB_SCALE - 1), 0)
    del e, valid
    # f == PROB_SCALE (a probability-1 symbol) never emits: its true
    # renorm threshold is 2^32
    x_max = f << (32 - PROB_BITS)
    can = f < PROB_SCALE
    fx = f.clamp(min=1)
    x = torch.full((L,), RANS_L, dtype=torch.int64, device=dev)
    xs = torch.empty((C, L), dtype=torch.int64, device=dev)
    for j in range(C - 1, -1, -1):
        xs[j] = x
        emit = can[j] & (x >= x_max[j])
        x = torch.where(emit, x >> 16, x)
        q = torch.div(x, fx[j], rounding_mode="floor")
        x = ((q << PROB_BITS) + (x - q * fx[j]) + c[j]) & M32
    # the words of step j, read back: the decoder takes them last
    # emitted first, i.e. in ascending j
    emask = (can & (xs >= x_max)).T
    counts = emask.sum(1)
    tgt = torch.where(emask, emask.cumsum(1) - 1, C + 2)
    words = torch.zeros((L, C + 3), dtype=torch.int16, device=dev)
    words.scatter_(1, tgt, (xs & 0xFFFF).T.to(torch.int16))
    return words[:, : C + 2].contiguous(), counts, x


def rans_encode_walk(idx: torch.Tensor, nsym: torch.Tensor,
                     fc: torch.Tensor, nlanes: int):
    """The encode walk (`rans_encode_walk_plain`'s contract): idx int32[C,
    L] with entries in [0, len(fc)), nsym int32[L], fc int32 1-D, lanes
    block-major, nlanes a block.  A CUDA tensor launches
    `csrc/rans_ctx.cu`'s encode kernel, which takes fc as B = ceil(L /
    nlanes) blocks of NCTX tables of S <= MAX_SYMS symbols, each lane's
    entries inside its own block's, C a multiple of 4, and writes every
    entry of `words`.  The entries' range is the caller's to keep
    (`rans_encode_ctx_batch` builds them from its tables): checking it
    would wait for the card."""
    cuda_lib.check_tensor("idx", idx, torch.int32, (None, None))
    C, L = idx.shape
    cuda_lib.check_tensor("nsym", nsym, torch.int32, (L,))
    cuda_lib.check_tensor("fc", fc, torch.int32, (None,))
    if nlanes < 1:
        raise ValueError("rans_encode_walk: nlanes must be positive")
    if cuda_lib.device_of(idx, nsym, fc).type == "cpu":
        return rans_encode_walk_plain(idx, nsym, fc)
    rows = max(-(-L // nlanes), 1) * NCTX
    S = fc.shape[0] // rows
    if fc.shape[0] != rows * S or not 1 <= S <= MAX_SYMS or C < 4 or C % 4:
        raise ValueError("rans_encode_walk: the kernel takes NCTX tables of "
                         f"1..{MAX_SYMS} symbols a block and C a multiple "
                         "of 4")
    lib = cuda_lib.library()
    rcp = _rcp(idx.device)
    words = torch.empty((L, C + 2), dtype=torch.int16, device=idx.device)
    counts = torch.empty(L, dtype=torch.int64, device=idx.device)
    states = torch.empty(L, dtype=torch.int64, device=idx.device)
    with torch.cuda.device(idx.device):
        cuda_lib.check(lib.tplc_rans_encode(
            idx.data_ptr(), nsym.data_ptr(), fc.data_ptr(), rcp.data_ptr(),
            words.data_ptr(), counts.data_ptr(), states.data_ptr(), C, L, S,
            nlanes, cuda_lib.stream_of(idx)), "rans_encode_walk")
    rans_encode_walk.launches += 1
    return words, counts, states


rans_encode_walk.launches = 0


def rans_encode_ctx_batch(syms2: torch.Tensor, gctx2: torch.Tensor, ms,
                          freq: torch.Tensor, cum: torch.Tensor,
                          chunk: int = CHUNK):
    """syms2/gctx2 int[B, cap] (contexts offset by block * NCTX); ms the
    B valid lengths; freq/cum [B*NCTX, S] -> (words int16[B*nlanes,
    chunk+2], counts int64[B*nlanes], states int64[B*nlanes]) with
    lanes block-major."""
    B, cap = syms2.shape
    S = freq.shape[1]
    nlanes = cap // chunk
    L = B * nlanes
    idx = (gctx2.to(torch.int32) * S + syms2.to(torch.int32)).reshape(
        L, chunk).T.contiguous()
    nsym = _lane_counts(ms, B, nlanes, chunk, syms2.device)
    return rans_encode_walk(idx, nsym, packed_table(freq, cum),
                            max(nlanes, 1))


def rans_encode_ctx(syms: torch.Tensor, ctx: torch.Tensor, m,
                    freq: torch.Tensor, cum: torch.Tensor,
                    chunk: int = CHUNK):
    """One block: syms/ctx int[cap], freq/cum [NCTX, S] -> (words,
    counts, states) as `rans_encode_ctx_batch` with B = 1."""
    return rans_encode_ctx_batch(syms[None], ctx[None], [m], freq, cum,
                                 chunk)


# ---------------------------------------------------------------- decode

def rans_decode_walk_plain(words: torch.Tensor, states: torch.Tensor,
                           fctx: torch.Tensor, nsym: torch.Tensor,
                           lut: torch.Tensor, fc: torch.Tensor, nlanes: int,
                           chunk: int = CHUNK) -> torch.Tensor:
    """The decode walk.  words int16[L, chunk+2] (uint16 rows), states
    int[L] (uint32 values), fctx int[L] (the context entering each lane,
    offset by block * NCTX; lane l is in block l // nlanes), nsym int[L],
    lut int16 slot table, fc int32 packed table -> int32[L, chunk], 0
    past nsym.  A word read clamps at column chunk+1."""
    L = words.shape[0]
    dev = words.device
    S = fc.shape[0] // (lut.shape[0] // PROB_SCALE)
    lut64 = lut.to(torch.int64)
    fc64 = fc.to(torch.int64)
    w64 = words.reshape(-1).to(torch.int64) & 0xFFFF
    lane = torch.arange(L, device=dev)
    row0 = lane * words.shape[1]
    base = lane // max(nlanes, 1) * NCTX
    cls = ctx_class(torch.arange(S, device=dev)).to(torch.int64)
    valid = torch.arange(chunk, device=dev)[:, None] < nsym.to(torch.int64)
    x = states.to(torch.int64) & M32
    k = fctx.to(torch.int64)
    rpos = torch.zeros(L, dtype=torch.int64, device=dev)
    out = torch.zeros((chunk, L), dtype=torch.int32, device=dev)
    for j in range(chunk):
        v = valid[j]
        slot = x & (PROB_SCALE - 1)
        s = lut64[(k << PROB_BITS) + slot]
        e = fc64[k * S + s]
        xn = ((e >> PROB_BITS) * (x >> PROB_BITS) + slot
              - (e & (PROB_SCALE - 1))) & M32
        need = v & (xn < RANS_L)
        w = w64[row0 + rpos.clamp(max=chunk + 1)]
        xn = torch.where(need, ((xn << 16) | w) & M32, xn)
        rpos = rpos + need
        x = torch.where(v, xn, x)
        out[j] = torch.where(v, s, 0)
        # the carried id's high bits are the class of sym t-1, which
        # becomes the t-2 component next step
        k = torch.where(v, base + ctx_combine(cls[s], (k - base) // _C2), k)
    return out.T.contiguous()


def rans_decode_walk(words: torch.Tensor, states: torch.Tensor,
                     fctx: torch.Tensor, nsym: torch.Tensor,
                     lut: torch.Tensor, fc: torch.Tensor, nlanes: int,
                     chunk: int = CHUNK) -> torch.Tensor:
    """The decode walk (`rans_decode_walk_plain`'s contract): words
    int16[L, chunk+2], states and fctx int64[L], nsym int32[L], lut
    int16[R * 2^14] with values in [0, S), fc int32[R * S], each fctx[l]
    in its block's [base, base + NCTX), chunk a multiple of 4.  A CUDA
    tensor launches `csrc/rans_ctx.cu`'s decode kernel, which takes S <=
    MAX_SYMS and finds each slot's symbol from fc's tables, so it takes
    `lut` to be their `slot_table` (each table summing to 2^14).  The
    ranges are the caller's to keep (the driver's tables sum to 2^14,
    so the slot table's symbols are < S, and its contexts are 5-bit
    fields plus the block's base): checking them would wait for the
    card."""
    cuda_lib.check_tensor("words", words, torch.int16, (None, chunk + 2))
    L = words.shape[0]
    cuda_lib.check_tensor("states", states, torch.int64, (L,))
    cuda_lib.check_tensor("fctx", fctx, torch.int64, (L,))
    cuda_lib.check_tensor("nsym", nsym, torch.int32, (L,))
    cuda_lib.check_tensor("lut", lut, torch.int16, (None,))
    cuda_lib.check_tensor("fc", fc, torch.int32, (None,))
    R = lut.shape[0] // PROB_SCALE
    if R < 1 or lut.shape[0] % PROB_SCALE or fc.shape[0] % R or chunk % 4 \
            or nlanes < 1:
        raise ValueError("rans_decode_walk: bad table or lane geometry")
    S = fc.shape[0] // R
    dev = cuda_lib.device_of(words, states, fctx, nsym, lut, fc)
    if dev.type == "cpu":
        return rans_decode_walk_plain(words, states, fctx, nsym, lut, fc,
                                      nlanes, chunk)
    if S > MAX_SYMS:
        raise ValueError(f"rans_decode_walk: the kernel takes at most "
                         f"{MAX_SYMS} symbols a table")
    lib = cuda_lib.library()
    out = torch.empty((L, chunk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_rans_decode(
            words.data_ptr(), states.data_ptr(), fctx.data_ptr(),
            nsym.data_ptr(), fc.data_ptr(), out.data_ptr(), chunk, L, S, R,
            nlanes, cuda_lib.stream_of(words)), "rans_decode_walk")
    rans_decode_walk.launches += 1
    return out


rans_decode_walk.launches = 0


def rans_decode_ctx_batch(words: torch.Tensor, counts: torch.Tensor,
                          states: torch.Tensor, first_gctx: torch.Tensor,
                          ms, freq: torch.Tensor, cum: torch.Tensor,
                          lut: torch.Tensor, B: int, chunk: int = CHUNK):
    """Batched `rans_decode_ctx_chained`: words int16[B*nlanes, chunk+2];
    first_gctx offset by block * NCTX; freq/cum [B*NCTX, S]; lut the
    slot table -> int32[B, nlanes * chunk].  `counts` is carried for
    tpulc's signature: the rows already hold each lane's words."""
    del counts
    L = words.shape[0]
    nlanes = L // B
    nsym = _lane_counts(ms, B, nlanes, chunk, words.device)
    out = rans_decode_walk(
        words.to(torch.int16).contiguous(),
        states.to(torch.int64).contiguous(),
        first_gctx.to(torch.int64).contiguous(), nsym,
        lut.to(torch.int16).contiguous(), packed_table(freq, cum),
        max(nlanes, 1), chunk)
    return out.reshape(B, nlanes * chunk)


def rans_decode_ctx_chained(words: torch.Tensor, counts: torch.Tensor,
                            states: torch.Tensor, first_ctx: torch.Tensor,
                            m, freq: torch.Tensor, cum: torch.Tensor,
                            lut: torch.Tensor, chunk: int = CHUNK):
    """One block's decode -> int32[nlanes * chunk] (the batch, B = 1)."""
    return rans_decode_ctx_batch(words, counts, states, first_ctx, [m],
                                 freq, cum, lut, 1, chunk).reshape(-1)


# ------------------------------------------------------------ word rows

def compact_words(words: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[L, W] padded lane words + per-lane counts -> the lane-major
    concatenation of each row's first counts[l] words."""
    W = words.shape[1]
    valid = torch.arange(W, device=words.device)[None, :] < counts[:, None]
    # a mask select reads its count back to size the output
    return timing.wait(torch.Tensor.__getitem__, words, valid, nbytes=8)


def expand_words(flat: torch.Tensor, counts: torch.Tensor,
                 chunk: int = CHUNK) -> torch.Tensor:
    """Inverse of `compact_words`: flat words + counts -> padded rows
    [L, chunk+2] (one gather).  Handles the zero-word stream (every
    symbol probability-1: single-symbol contexts emit nothing)."""
    if flat.shape[0] == 0:
        flat = flat.new_zeros(1)
    counts = counts.to(torch.int64)
    offs = torch.cumsum(counts, 0) - counts
    iota = torch.arange(chunk + 2, device=flat.device)[None, :]
    idx = (offs[:, None] + iota).clamp(0, flat.shape[0] - 1)
    valid = iota < counts[:, None]
    return torch.where(valid, flat[idx], 0)
