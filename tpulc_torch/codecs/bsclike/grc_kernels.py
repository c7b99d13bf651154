"""The group-rank coder's kernels: wrappers, launch counts and plain
versions.

The counterparts of `tpulc/codecs/bsclike/grc_pallas.py` and of one
stage tpulc leaves to XLA:

  K5 `grc_walk_probs`    `grc_walk_probs_pallas`, CUDA source
                         `csrc/grc_walk.cu`: the encode-side forward
                         model walk;
  `grc_reverse_rans`     `grc._reverse_rans_t` (an XLA loop in tpulc),
                         `csrc/grc_rans.cu`: the reverse-rANS emission
                         that reads K5's output;
  K6 `grc_decode_walk`   `grc_decode_pallas`, `csrc/grc_decode.cu`: the
                         per-lane decode FSM.

Design notes are in the CUDA sources.  A CPU tensor runs the plain
PyTorch version; a CUDA tensor launches the kernel (adding one to the
wrapper's `launches`) or raises.  K5 and K6 hold MAX_LANES lanes a
CUDA block, or their `lanes` argument.

Contract of K5: `gmb` int32[W, L] is the event grid, time-major (record
``(model + 1) * 2 + bit``, 0 = empty slot); `init` int32[NM] and
`cinit` int32[NFAM] seed every lane's fine and coarse counters.  Row t
< nsteps of the int32[W, L] output is the mixed probability before
event t (an empty slot holds model 0's mix and updates nothing); rows
at or past nsteps hold 0.  Model ids are clamped to [0, NM): a record
past ``2 * NM + 1`` reads model NM-1 (tpulc's encoder never writes one).

Contract of the emission: `gmb` and `probs` int32[W, L] (K5's input and
output) -> words int32[L, W+2] (uint16 values), counts int64[L], states
int64[L] (uint32 values).  Each lane runs rANS backwards over its events
t < nsteps from the state 2^16; row l of `words` holds its first
``counts[l]`` words in stream order, then zeros.

Contract of K6: `words` int16[L, Wc] holds each lane's uint16 stream,
`states` int32[L] the final encoder states (uint32 bit patterns),
`init`/`cinit` as for K5.  Lane l decodes ``nsym = clip(m - l*chunk,
0, chunk)`` symbols in at most nsteps steps into row l of a zeroed
int32[L, chunk]; a word read clamps at column Wc-1.  uint32 rANS
arithmetic wraps mod 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch import cuda_lib
from tpulc_torch.codecs.bsclike.grc import (
    B_L0,
    B_RE,
    B_RM,
    B_RT,
    B_UE,
    B_UM,
    B_UT,
    MAX_EK,
    NFAM,
    NM,
    PROB_BITS,
    RANS_L,
    RATE_C,
    RATE_F,
    SCALE,
    _bitlen,
    _ctx_regs,
    _rq_of,
    fam_of_model,
)

M32 = 0xFFFFFFFF
# lanes a K5/K6 block holds by default, the most that fit: each lane's
# NM uint16 counters plus one init table in sm_90's 227 KB (232,448 B)
# of opt-in shared memory.  chip_smoke.py checks 32 and 64 against it.
MAX_LANES = (232_448 - 2 * NM) // (2 * NM)     # 94


def _lanes(lanes: int | None) -> int:
    if lanes is None:
        return MAX_LANES
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"lanes {lanes} outside [1, {MAX_LANES}]")
    return lanes


def _mix(pf, pc, pi):
    return ((19 * pf + 7 * pc + 6 * pi) >> 5).clamp(8, SCALE - 8)


def _adapt(p, bit, rate):
    return (p + (((bit << PROB_BITS) - p) >> rate)).clamp(8, SCALE - 8)


# --------------------------------------------------------------- K5

def grc_walk_probs_plain(gmb: torch.Tensor, init: torch.Tensor,
                         cinit: torch.Tensor, nsteps: int) -> torch.Tensor:
    """K5's contract in plain PyTorch: `grc._walk_probs` with the model
    state indexed by gather/scatter instead of one-hot reductions."""
    W, L = gmb.shape
    dev = gmb.device
    fam = torch.from_numpy(fam_of_model()).to(dev, torch.int64)
    init64 = init.to(torch.int64)
    pstate = init64.expand(L, NM).clone()
    cstate = cinit.to(torch.int64).expand(L, NFAM).clone()
    lanes = torch.arange(L, device=dev)
    probs = torch.zeros((W, L), dtype=torch.int32, device=dev)
    for t in range(min(nsteps, W)):
        e = gmb[t].to(torch.int64)
        mdl = ((e >> 1) - 1).clamp(0, NM - 1)
        upd = e > 0
        bit = e & 1
        f = fam[mdl]
        pf = pstate[lanes, mdl]
        pc = cstate[lanes, f]
        probs[t] = _mix(pf, pc, init64[mdl]).to(torch.int32)
        pstate[lanes, mdl] = torch.where(upd, _adapt(pf, bit, RATE_F), pf)
        cstate[lanes, f] = torch.where(upd, _adapt(pc, bit, RATE_C), pc)
    return probs


def grc_walk_probs(gmb: torch.Tensor, init: torch.Tensor,
                   cinit: torch.Tensor, nsteps: int,
                   lanes: int | None = None) -> torch.Tensor:
    """K5 wrapper (see the module docstring)."""
    cuda_lib.check_tensor("gmb", gmb, torch.int32, (None, None))
    cuda_lib.check_tensor("init", init, torch.int32, (NM,))
    cuda_lib.check_tensor("cinit", cinit, torch.int32, (NFAM,))
    lanes = _lanes(lanes)
    if cuda_lib.device_of(gmb, init, cinit).type == "cpu":
        return grc_walk_probs_plain(gmb, init, cinit, nsteps)
    lib = cuda_lib.library()
    W, L = gmb.shape
    probs = torch.empty_like(gmb)
    with torch.cuda.device(gmb.device):
        cuda_lib.check(lib.tplc_grc_walk_probs(
            gmb.data_ptr(), init.data_ptr(), cinit.data_ptr(),
            probs.data_ptr(), W, L, max(0, min(nsteps, W)),
            lanes, cuda_lib.stream_of(gmb)), "grc_walk_probs")
    grc_walk_probs.launches += 1
    return probs


grc_walk_probs.launches = 0


# ------------------------------------------------- reverse-rANS emission

def grc_reverse_rans_plain(gmb: torch.Tensor, probs: torch.Tensor,
                           nsteps: int):
    """The emission's contract in plain PyTorch: everything that does not
    depend on the state x is computed for the whole grid first, so each
    of the nsteps serial steps is a handful of [L] ops; uint32 in int64
    masked to 32 bits."""
    W, L = gmb.shape
    nsteps = max(0, min(nsteps, W))
    dev = gmb.device
    e = gmb[:nsteps]
    vq = e > 0
    p1 = probs[:nsteps].to(torch.int64)
    b1 = (e & 1) == 1
    f = torch.where(b1, p1, SCALE - p1)
    c = torch.where(b1, SCALE - p1, 0)
    x_max = (f << (32 - PROB_BITS)) & M32
    fx = f.clamp(min=1)
    x = torch.full((L,), RANS_L, dtype=torch.int64, device=dev)
    emit = torch.empty((nsteps, L), dtype=torch.int32, device=dev)
    emask = torch.empty((nsteps, L), dtype=torch.bool, device=dev)
    for i in range(nsteps):
        t = nsteps - 1 - i
        do = vq[t] & (x >= x_max[t])
        emit[i] = x & 0xFFFF
        emask[i] = do
        x = torch.where(do, x >> 16, x)
        q = torch.div(x, fx[t], rounding_mode="floor")
        x = torch.where(vq[t], ((q << PROB_BITS) + (x - q * fx[t]) + c[t])
                        & M32, x)
    counts = emask.sum(dim=0)
    pos_in_lane = torch.cumsum(emask.to(torch.int64), dim=0) - 1
    tgt = torch.where(emask, counts - 1 - pos_in_lane, W + 2)
    words = torch.zeros((L, W + 3), dtype=torch.int32, device=dev)
    words.scatter_(1, tgt.T, emit.T)
    return words[:, : W + 2], counts, x


def grc_reverse_rans(gmb: torch.Tensor, probs: torch.Tensor, nsteps: int):
    """Emission wrapper (see the module docstring)."""
    cuda_lib.check_tensor("gmb", gmb, torch.int32, (None, None))
    W, L = gmb.shape
    cuda_lib.check_tensor("probs", probs, torch.int32, (W, L))
    if cuda_lib.device_of(gmb, probs).type == "cpu":
        return grc_reverse_rans_plain(gmb, probs, nsteps)
    lib = cuda_lib.library()
    # the kernel writes every entry of words, the zeros past counts too
    words = torch.empty((L, W + 2), dtype=torch.int32, device=gmb.device)
    counts = torch.empty(L, dtype=torch.int64, device=gmb.device)
    states = torch.empty(L, dtype=torch.int64, device=gmb.device)
    with torch.cuda.device(gmb.device):
        cuda_lib.check(lib.tplc_grc_reverse_rans(
            gmb.data_ptr(), probs.data_ptr(), words.data_ptr(),
            counts.data_ptr(), states.data_ptr(), W, L,
            max(0, min(nsteps, W)), cuda_lib.stream_of(gmb)),
            "grc_reverse_rans")
    grc_reverse_rans.launches += 1
    return words, counts, states


grc_reverse_rans.launches = 0


# --------------------------------------------------------------- K6

def grc_decode_walk_plain(words: torch.Tensor, states: torch.Tensor,
                          init: torch.Tensor, cinit: torch.Tensor, m: int,
                          nsteps: int, chunk: int) -> torch.Tensor:
    """K6's contract in plain PyTorch: `grc.grc_decode`'s `body2` over
    all lanes, uint32 arithmetic in int64 masked to 32 bits.  Stops
    early once every lane is done (an inactive lane never changes)."""
    L, Wc = words.shape
    dev = words.device
    fam = torch.from_numpy(fam_of_model()).to(dev, torch.int64)
    init64 = init.to(torch.int64)
    pstate = init64.expand(L, NM).clone()
    cstate = cinit.to(torch.int64).expand(L, NFAM).clone()
    lanes = torch.arange(L, device=dev)
    w64 = words.to(torch.int64) & 0xFFFF
    nsym = (m - lanes * chunk).clamp(0, chunk)
    out = torch.zeros((L, chunk + 1), dtype=torch.int32, device=dev)
    z = torch.zeros(L, dtype=torch.int64, device=dev)
    x = states.to(torch.int64) & M32
    rpos, opos, phase, lvl, val, mleft = z, z, z, z, z, z
    ek, kval, kleft, r, prev_r, prev2_r, prev_e = z, z, z, z, z, z, z
    prev_k, prev2_k = z + 1, z + 1
    for t in range(nsteps):
        if t % 256 == 0 and not bool((opos < nsym).any()):
            break
        active = opos < nsym
        cR4, cRun, hE, cR4c, cR0 = _ctx_regs(prev_r, prev2_r, prev_k,
                                            prev2_k, prev_e)
        rq = _rq_of(r)
        mdl = torch.where(
            phase == 0, B_L0, torch.where(
                phase == 1, B_RT + cR4 * 16 + cRun * 4 + hE, torch.where(
                    phase == 2, B_RE + (lvl.clamp(1, 6) - 1) * 4 + cR4c,
                    torch.where(
                        phase == 3,
                        B_RM + (ek.clamp(1, 7) - 1) * 64 + val.clamp(max=63),
                        torch.where(
                            phase == 4, B_UT + rq * 32 + cRun * 8 + cR0,
                            torch.where(
                                phase == 5,
                                B_UE + (lvl.clamp(1, MAX_EK - 1) - 1) * 4
                                + rq,
                                B_UM + (ek.clamp(1, MAX_EK) - 1) * 32
                                + kval.clamp(max=31)))))))
        mdl = mdl.clamp(0, NM - 1)
        f = fam[mdl]
        pf = pstate[lanes, mdl]
        pc = cstate[lanes, f]
        pe = _mix(pf, pc, init64[mdl])
        f0 = SCALE - pe
        slot = x & (SCALE - 1)
        bit = (slot >= f0).to(torch.int64)
        b1 = bit == 1
        fq = torch.where(b1, pe, f0)
        cq = torch.where(b1, f0, 0)
        x_new = (fq * (x >> PROB_BITS) + slot - cq) & M32
        need = active & (x_new < RANS_L)
        w = w64[lanes, rpos.clamp(max=Wc - 1)]
        x = torch.where(active, torch.where(
            need, ((x_new << 16) | w) & M32, x_new), x)
        rpos = rpos + need.to(torch.int64)
        pstate[lanes, mdl] = torch.where(active, _adapt(pf, bit, RATE_F), pf)
        cstate[lanes, f] = torch.where(active, _adapt(pc, bit, RATE_C), pc)

        is0, is1, is2, is3 = phase == 0, phase == 1, phase == 2, phase == 3
        is4, is5, is6 = phase == 4, phase == 5, phase == 6
        # rank side
        r_n = torch.where(is0 & b1, 0, torch.where(is1 & b1, 1, r))
        to_ut = (is0 | is1) & b1
        to_rt = is0 & ~b1
        to_re = is1 & ~b1
        lvl_n = torch.where(to_re, 1, lvl)
        re_cont = is2 & b1
        lvl_n = torch.where(re_cont, lvl + 1, lvl_n)
        re_to_rm_hi = re_cont & (lvl_n == 7)
        enter_rm = re_to_rm_hi | (is2 & ~b1)
        ek_rank = torch.where(re_to_rm_hi, 7, lvl)
        ek_n = torch.where(enter_rm, ek_rank, ek)
        val_n = torch.where(is3, val * 2 + bit,
                            torch.where(enter_rm, 1, val))
        mleft_n = torch.where(is3, mleft - 1,
                              torch.where(enter_rm, ek_rank, mleft))
        rm_done = is3 & (mleft_n == 0)
        r_n = torch.where(rm_done, val_n, r_n)
        to_ut = to_ut | rm_done
        # run side
        ut_one = is4 & b1
        to_ue = is4 & ~b1
        lvl_n = torch.where(to_ue, 1, lvl_n)
        ue_cont = is5 & b1
        lvl_n = torch.where(ue_cont, lvl + 1, lvl_n)
        ue_to_um_hi = ue_cont & (lvl_n == MAX_EK)
        enter_um = ue_to_um_hi | (is5 & ~b1)
        ek_run = torch.where(ue_to_um_hi, MAX_EK, lvl)
        ek_n = torch.where(enter_um, ek_run, ek_n)
        kval_n = torch.where(is6, kval * 2 + bit,
                             torch.where(enter_um, 1, kval))
        kleft_n = torch.where(is6, kleft - 1,
                              torch.where(enter_um, ek_run, kleft))
        um_done = is6 & (kleft_n == 0)
        k_done = torch.where(ut_one, 1, torch.where(um_done, kval_n, 0))
        complete = active & (ut_one | um_done)
        k_done = torch.minimum(k_done.clamp(min=0),
                               (nsym - opos).clamp(min=1))
        # emit the group's rank at opos (column `chunk` is a dump slot)
        put = complete & (r_n > 0)
        out[lanes, torch.where(put, opos, chunk)] = torch.where(
            put, r_n, 0).to(torch.int32)
        opos_n = torch.where(complete, opos + k_done, opos)
        prev2_r_n = torch.where(complete, prev_r, prev2_r)
        prev2_k_n = torch.where(complete, prev_k, prev2_k)
        prev_r_n = torch.where(complete, r_n, prev_r)
        prev_k_n = torch.where(complete, k_done, prev_k)
        prev_e_n = torch.where(
            complete, torch.where(r_n > 0, _bitlen(r_n) - 1, 0), prev_e)
        phase_n = torch.where(
            complete, 1, torch.where(
                to_rt, 1, torch.where(
                    to_re, 2, torch.where(
                        enter_rm, 3, torch.where(
                            to_ut, 4, torch.where(
                                to_ue, 5, torch.where(enter_um, 6,
                                                      phase)))))))

        def keep(new, old):
            return torch.where(active, new, old)

        opos, phase, lvl = keep(opos_n, opos), keep(phase_n, phase), \
            keep(lvl_n, lvl)
        val, mleft, ek = keep(val_n, val), keep(mleft_n, mleft), \
            keep(ek_n, ek)
        kval, kleft = keep(kval_n, kval), keep(kleft_n, kleft)
        r = keep(torch.where(complete, 0, r_n), r)
        prev_r, prev2_r = keep(prev_r_n, prev_r), keep(prev2_r_n, prev2_r)
        prev_k, prev2_k = keep(prev_k_n, prev_k), keep(prev2_k_n, prev2_k)
        prev_e = keep(prev_e_n, prev_e)
    return out[:, :chunk].contiguous()


def grc_decode_walk(words: torch.Tensor, states: torch.Tensor,
                    init: torch.Tensor, cinit: torch.Tensor, m: int,
                    nsteps: int, chunk: int,
                    lanes: int | None = None) -> torch.Tensor:
    """K6 wrapper (see the module docstring)."""
    cuda_lib.check_tensor("words", words, torch.int16, (None, None))
    L, Wc = words.shape
    cuda_lib.check_tensor("states", states, torch.int32, (L,))
    cuda_lib.check_tensor("init", init, torch.int32, (NM,))
    cuda_lib.check_tensor("cinit", cinit, torch.int32, (NFAM,))
    if Wc < 1 or chunk < 1:
        raise ValueError("need at least one word column and chunk >= 1")
    lanes = _lanes(lanes)
    if cuda_lib.device_of(words, states, init, cinit).type == "cpu":
        return grc_decode_walk_plain(words, states, init, cinit, m, nsteps,
                                     chunk)
    lib = cuda_lib.library()
    out = torch.zeros((L, chunk), dtype=torch.int32, device=words.device)
    m = int(np.clip(m, 0, L * chunk))
    with torch.cuda.device(words.device):
        cuda_lib.check(lib.tplc_grc_decode(
            words.data_ptr(), states.data_ptr(), init.data_ptr(),
            cinit.data_ptr(), out.data_ptr(), L, Wc, m, max(0, nsteps),
            chunk, lanes, cuda_lib.stream_of(words)),
            "grc_decode_walk")
    grc_decode_walk.launches += 1
    return out


grc_decode_walk.launches = 0
