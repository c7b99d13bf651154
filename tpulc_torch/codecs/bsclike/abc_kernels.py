"""The adaptive binary coder's two walks: wrappers, launch counts and
plain versions.

tpulc leaves both to XLA `fori_loop`s (no `pallas_call`):

  `abc_encode_walk`   `rans_adaptive.abc_encode`'s model pass and
                      reverse rANS pass (`rans_adaptive.py:228-311`),
                      CUDA source `csrc/abc.cu`;
  `abc_decode_walk`   `rans_adaptive.abc_decode`'s per-lane FSM
                      (`:314-445`), `csrc/abc.cu`.

Design notes are in the CUDA source.  A CPU tensor runs the plain
PyTorch version; a CUDA tensor launches the kernel (adding one to the
wrapper's `launches`) or raises.  The encode kernel picks its lanes a
CUDA block from L (`tplc_abc_encode_lanes`), the decode kernel holds
32; they read two host-built tables: `rcp_table` (encode:
the reciprocals that replace the rANS divide) and `fsm_table` (decode:
the FSM's moves by state and bit).

Contract of the encode walk: `grid` uint8[W, L] holds each lane's
events step-major (``(model + 1) * 2 + bit`` with model < NMODELS, 0 =
no event), lane l's events are t < nbits[l] (int32[L], <= W), `inits`
int32[B, NMODELS] its initial probabilities (row l // lcap; the kernel
takes them in [0, 4096], `quantize_inits` gives [16, 4080]).  The
model pass records the probability before each event and adapts; the
reverse pass runs rANS over the events t < nbits[l], last first, from
the state 2^16.  Returns words int16[L, W+2] (uint16 values: the
lane's first ``counts[l]`` words in stream order, then zeros), counts
int64[L], states int64[L] (uint32 values).

Contract of the decode walk: `words` int16[L, Wc] each lane's uint16
stream, `states` int64[L] (uint32 values), `lane_cls` int32[L] (c1*4 +
c2 entering the lane; the kernel takes [0, 32), the wire's 5 bits),
`nsym` int32[L] (<= chunk), `inits` as above (the kernel takes any
uint16, the wire's).
Lane l decodes one bit a step for at most ``steps = ceil(nsteps / 4) *
4`` steps (tpulc's unrolled loop) and stops at nsym symbols, into row l
of a zeroed int32[L, chunk]; a word read clamps at column Wc-1; uint32
rANS arithmetic wraps mod 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch import cuda_lib
from tpulc_torch.codecs.bsclike.rans import ctx_class

NMODELS = 117
PROB_BITS = 12
SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
M32 = 0xFFFFFFFF
# the model ids of each FSM phase: E0 (c1 * 4 + c2), E1, EXP, MANT
_M_E1, _M_EXP, _M_MANT = 32, 40, 68
# an FSM move's flags (csrc/abc.cu): a symbol completes; v1 := 1
FSM_EMIT = 1 << 10
FSM_VSET = 1 << 13


def _adapt(p: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """p += ((bit << 12) - p) >> 5, an arithmetic shift, clipped to
    [8, 4088]: identical integer ops on encode and decode."""
    return (p + (((bit << PROB_BITS) - p) >> 5)).clamp(8, SCALE - 8)


def rcp_table() -> np.ndarray:
    """The encode kernel's reciprocals: entry f (0..4096) is
    floor((2^32 - 1) / max(f, 1)) as uint32, so that for any uint32 x
    q = (x * rcp[f]) >> 32 is x // max(f, 1) or one less."""
    f = np.maximum(np.arange(SCALE + 1, dtype=np.uint64), 1)
    return (np.uint64(M32) // f).astype(np.uint32)


def fsm_table() -> np.ndarray:
    """The decode kernel's FSM (tpulc's, `rans_adaptive.py:381-430`):
    uint32[1024, 2], row k = a state, column = the bit.  A state is
    min(c1, 3) * 256 + nz * 128 + its model id, where nz says whether a
    mantissa has had a 1 bit (a mantissa symbol's class is min(E + 1 +
    nz, 7), so its successor needs no value).  A move holds the next
    state (bits 0-9), FSM_EMIT when a symbol completes, the symbol in
    bits 11-12 (0, 1 or 2, or 3 for a mantissa symbol, whose value is
    v1 + 1) and FSM_VSET when the mantissa accumulator restarts at 1
    (else v1 := 2 v1 + bit).  The successor of a finished symbol s is
    E0's model ctx_class(s) * 4 + min(c1, 3) with min(ctx_class(s), 3)
    as its capped class.  States no walk reaches keep their state, or
    go to model 0 past the models."""
    t = np.zeros((1024, 2), np.uint32)
    for k in range(1024):
        cap, nz, m = k >> 8, (k >> 7) & 1, k & 127
        for b in (0, 1):
            if m >= NMODELS:
                mv = cap << 8
            elif m < _M_E1:                        # E0: c1 * 4 + c2
                mv = (cap | FSM_EMIT) if b else cap << 8 | _M_E1 + (m >> 2)
            elif m < _M_EXP:                       # E1: 32 + c1
                mv = (1 << 8 | 4 + cap | FSM_EMIT | 1 << 11 if b
                      else cap << 8 | _M_EXP + cap)
            elif m < _M_MANT:                      # EXP: 40 + lvl*4 + cap
                lvl = (m - _M_EXP) >> 2
                if b:                              # E = 8 implied at lvl 7
                    mv = cap << 8 | (_M_MANT + 6 * 7 | FSM_VSET
                                     if lvl == 6 else m + 4)
                elif lvl == 0:                     # s = 2
                    mv = 2 << 8 | 8 + cap | FSM_EMIT | 2 << 11
                else:                              # E = lvl + 1
                    mv = cap << 8 | _M_MANT + (lvl - 1) * 7 | FSM_VSET
            else:                                  # MANT: 68 + (E-2)*7 + pos
                ee, pos = (m - _M_MANT) // 7 + 2, (m - _M_MANT) % 7
                nz2 = nz | b
                if pos > ee - 2:
                    mv = k
                elif pos == ee - 2:                # s = v1 + 1
                    cls = min(ee + 1 + nz2, 7)
                    mv = 3 << 8 | cls * 4 + cap | FSM_EMIT | 3 << 11
                else:
                    mv = cap << 8 | nz2 << 7 | m + 1
            t[k, b] = mv
    return t


_TABLES: dict = {}


def _table(name: str, dev: torch.device) -> torch.Tensor:
    """A host-built table as int32 on dev, made once a device."""
    key = (name, dev)
    if key not in _TABLES:
        host = rcp_table() if name == "rcp" else fsm_table()
        _TABLES[key] = torch.from_numpy(host.view(np.int32)).to(dev)
    return _TABLES[key]


def _lane_state(inits: torch.Tensor, L: int, lcap: int) -> torch.Tensor:
    lanes = torch.arange(L, device=inits.device)
    return inits.to(torch.int64)[lanes // max(lcap, 1)].clone()


# ----------------------------------------------------------------- encode

def abc_encode_walk_plain(grid: torch.Tensor, nbits: torch.Tensor,
                          inits: torch.Tensor, lcap: int):
    """The encode walk's contract in plain PyTorch, step-major, the
    uint32 state in int64 masked to 32 bits."""
    W, L = grid.shape
    dev = grid.device
    lanes = torch.arange(L, device=dev)
    nsteps = int(nbits.max()) if L else 0
    ev = torch.where(torch.arange(nsteps, device=dev)[:, None]
                     < nbits.to(torch.int64), grid[:nsteps].to(torch.int64), 0)
    pstate = _lane_state(inits, L, lcap)
    probs = torch.zeros((nsteps, L), dtype=torch.int64, device=dev)
    for t in range(nsteps):
        e = ev[t]
        m = ((e >> 1) - 1).clamp(0, NMODELS - 1)
        p = pstate[lanes, m]
        probs[t] = p
        pstate[lanes, m] = torch.where(e > 0, _adapt(p, e & 1), p)
    x = torch.full((L,), RANS_L, dtype=torch.int64, device=dev)
    xs = torch.zeros((nsteps, L), dtype=torch.int64, device=dev)
    emask = torch.zeros((nsteps, L), dtype=torch.bool, device=dev)
    for t in range(nsteps - 1, -1, -1):
        e, p1 = ev[t], probs[t]
        vq = e > 0
        one = (e & 1) == 1
        f = torch.where(one, p1, SCALE - p1)
        c = torch.where(one, SCALE - p1, 0)
        xs[t] = x
        emask[t] = vq & (x >= ((f << (32 - PROB_BITS)) & M32))
        x = torch.where(emask[t], x >> 16, x)
        fx = f.clamp(min=1)
        q = torch.div(x, fx, rounding_mode="floor")
        x = torch.where(vq, ((q << PROB_BITS) + (x - q * fx) + c) & M32, x)
    # emitted last step first, read back in ascending step order
    em = emask.T
    counts = em.sum(1)
    tgt = torch.where(em, em.cumsum(1) - 1, W + 2)
    words = torch.zeros((L, W + 3), dtype=torch.int16, device=dev)
    words.scatter_(1, tgt, (xs & 0xFFFF).T.to(torch.int16))
    return words[:, : W + 2].contiguous(), counts, x


def abc_encode_walk(grid: torch.Tensor, nbits: torch.Tensor,
                    inits: torch.Tensor, lcap: int):
    """The encode walk (the module's contract): a CUDA tensor launches
    `csrc/abc.cu`'s encode kernel, which writes every entry of `words`.
    The records'
    range, nbits <= W and the inits' range are the caller's to keep
    (`rans_adaptive.event_grid` and `quantize_inits` make them):
    checking them would wait for the card."""
    cuda_lib.check_tensor("grid", grid, torch.uint8, (None, None))
    W, L = grid.shape
    cuda_lib.check_tensor("nbits", nbits, torch.int32, (L,))
    cuda_lib.check_tensor("inits", inits, torch.int32, (None, NMODELS))
    if lcap < 1 or inits.shape[0] * lcap < L:
        raise ValueError("abc_encode_walk: fewer init rows than blocks")
    dev = cuda_lib.device_of(grid, nbits, inits)
    if dev.type == "cpu":
        return abc_encode_walk_plain(grid, nbits, inits, lcap)
    lib = cuda_lib.library()
    rcp = _table("rcp", dev)
    probs = torch.empty((W + 64, L), dtype=torch.int16, device=dev)
    words = torch.empty((L, W + 2), dtype=torch.int16, device=dev)
    counts = torch.empty(L, dtype=torch.int64, device=dev)
    states = torch.empty(L, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_abc_encode(
            grid.data_ptr(), nbits.data_ptr(), inits.data_ptr(),
            rcp.data_ptr(), probs.data_ptr(), words.data_ptr(),
            counts.data_ptr(), states.data_ptr(), W, L, lcap,
            cuda_lib.stream_of(grid)), "abc_encode_walk")
    abc_encode_walk.launches += 1
    return words, counts, states


abc_encode_walk.launches = 0


# ----------------------------------------------------------------- decode

def abc_decode_walk_plain(words: torch.Tensor, states: torch.Tensor,
                          lane_cls: torch.Tensor, nsym: torch.Tensor,
                          inits: torch.Tensor, lcap: int, nsteps: int,
                          chunk: int) -> torch.Tensor:
    """The decode walk's contract in plain PyTorch, one lockstep step
    at a time over every lane (tpulc's FSM, `rans_adaptive.py:340-430`,
    with gathers for its one-hot selects).  A lane stays done once it
    has its nsym symbols, so only its output and symbol count are
    gated on it: the rest of a done lane's state is never read again."""
    L, Wc = words.shape
    dev = words.device
    lanes = torch.arange(L, device=dev)
    prow = lanes * NMODELS
    pflat = _lane_state(inits, L, lcap).reshape(-1)
    w64 = words.to(torch.int64).reshape(-1) & 0xFFFF
    wrow = lanes * Wc
    orow = lanes * (chunk + 1)
    n = nsym.to(torch.int64)
    x = states.to(torch.int64) & M32
    cls = lane_cls.to(torch.int64)
    c1, c2 = cls >> 2, cls & 3
    cls_of = ctx_class(torch.arange(257, device=dev)).to(torch.int64)
    z = torch.zeros(L, dtype=torch.int64, device=dev)
    rpos, sym_i, phase, lvl, v1acc, ee, mpos = (z.clone() for _ in range(7))
    out = torch.zeros(L * (chunk + 1), dtype=torch.int32, device=dev)
    for _ in range((nsteps + 3) // 4 * 4):
        is0, is1, is2, is3 = phase == 0, phase == 1, phase == 2, phase == 3
        m = torch.where(is0, c1 * 4 + c2, torch.where(
            is1, _M_E1 + c1, torch.where(
                is2, _M_EXP + lvl.clamp(max=6) * 4 + c1.clamp(max=3),
                _M_MANT + (ee - 2) * 7 + mpos))).clamp(0, NMODELS - 1)
        pidx = prow + m
        p1 = pflat[pidx]
        f0 = (SCALE - p1) & M32
        slot = x & (SCALE - 1)
        b1 = slot >= f0
        bit = b1.to(torch.int64)
        x = (torch.where(b1, p1, f0) * (x >> PROB_BITS) + slot
             - torch.where(b1, f0, 0)) & M32
        need = x < RANS_L
        w = w64[wrow + rpos.clamp(max=Wc - 1)]
        x = torch.where(need, ((x << 16) | w) & M32, x)
        rpos = rpos + need
        pflat[pidx] = _adapt(p1, bit)
        # the FSM's transition
        lvl_n = torch.where(is2 & b1, lvl + 1, lvl)
        to8 = is2 & b1 & (lvl_n == 7)                # E = 8 implied
        stop = is2 & ~b1                             # E = lvl + 1
        emit0, emit1 = is0 & b1, is1 & b1
        emit2 = stop & (lvl == 0)
        v1_n = torch.where(is3, (v1acc << 1) | bit, v1acc)
        mpos_n = torch.where(is3, mpos + 1, mpos)
        emit3 = is3 & (mpos_n == ee - 1)
        done = emit0 | emit1 | emit2 | emit3
        s_out = torch.where(emit0, 0, torch.where(
            emit1, 1, torch.where(emit2, 2, v1_n + 1)))
        emitted = done & (sym_i < n)
        out[orow + torch.where(emitted, sym_i, chunk)] = s_out.to(torch.int32)
        sym_i = sym_i + emitted
        enter_mant = to8 | (stop & (lvl > 0))
        phase = torch.where(done, 0, torch.where(
            is0, 1, torch.where(is1, 2, torch.where(enter_mant, 3, phase))))
        ee = torch.where(to8, 8, torch.where(stop, lvl + 1, ee))
        v1acc = torch.where(enter_mant, 1, v1_n)
        mpos = torch.where(enter_mant, 0, mpos_n)
        lvl = torch.where(done | (is1 & ~b1), 0, lvl_n)
        c2 = torch.where(done, c1.clamp(max=3), c2)
        c1 = torch.where(done, cls_of[s_out], c1)
    return out.reshape(L, chunk + 1)[:, :chunk].contiguous()


def abc_decode_walk(words: torch.Tensor, states: torch.Tensor,
                    lane_cls: torch.Tensor, nsym: torch.Tensor,
                    inits: torch.Tensor, lcap: int, nsteps: int,
                    chunk: int) -> torch.Tensor:
    """The decode walk (the module's contract): a CUDA tensor launches
    `csrc/abc.cu`'s decode kernel, 32 lanes a block."""
    cuda_lib.check_tensor("words", words, torch.int16, (None, None))
    L, Wc = words.shape
    cuda_lib.check_tensor("states", states, torch.int64, (L,))
    cuda_lib.check_tensor("lane_cls", lane_cls, torch.int32, (L,))
    cuda_lib.check_tensor("nsym", nsym, torch.int32, (L,))
    cuda_lib.check_tensor("inits", inits, torch.int32, (None, NMODELS))
    if lcap < 1 or inits.shape[0] * lcap < L or Wc < 1 or chunk < 1 \
            or nsteps < 0:
        raise ValueError("abc_decode_walk: bad lane geometry")
    dev = cuda_lib.device_of(words, states, lane_cls, nsym, inits)
    if dev.type == "cpu":
        return abc_decode_walk_plain(words, states, lane_cls, nsym, inits,
                                     lcap, nsteps, chunk)
    lib = cuda_lib.library()
    fsm = _table("fsm", dev)
    out = torch.zeros((L, chunk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_abc_decode(
            words.data_ptr(), states.data_ptr(), lane_cls.data_ptr(),
            nsym.data_ptr(), inits.data_ptr(), fsm.data_ptr(),
            out.data_ptr(), Wc, L, lcap, chunk, (nsteps + 3) // 4 * 4,
            cuda_lib.stream_of(words)), "abc_decode_walk")
    abc_decode_walk.launches += 1
    return out


abc_decode_walk.launches = 0
