"""The port's group-rank coder (`tpulc_torch.codecs.bsclike.grc` and the
plain versions of K5, the reverse-rANS emission and K6 in
`grc_kernels`) against tpulc's on the same numpy rank streams: every
integer output equal (tolerance 0).

tpulc's Pallas walks run in interpret mode, as `tests/test_grc.py`
runs them; the port's plain versions are what its wrappers run for CPU
tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.bsclike import grc as tg
from tpulc.codecs.bsclike import grc_pallas as tgp
from tpulc.codecs.bsclike.rans_adaptive import bucket_bits as t_bucket_bits
from tpulc_torch.codecs.bsclike import grc as pg
from tpulc_torch.codecs.bsclike import grc_kernels as pk

torch.set_num_threads(1)

# tpulc calls these inside its jitted encoder; jit them here too
_t_binarize = jax.jit(tg._binarize, static_argnames=("W", "chunk", "bs"))
_t_stats_quant = jax.jit(tg._stats_quant)
_t_walk_probs = jax.jit(tg._walk_probs)
_t_reverse_rans = jax.jit(tg._reverse_rans_t, static_argnames=("L", "W"))


def _mk_ranks(n, seed=0, p_run=0.3, p_rank=0.5):
    """Copy of `tests/test_grc.py:_mk_ranks`."""
    rng = np.random.default_rng(seed)
    r = np.zeros(n, np.int32)
    i = 0
    while i < n:
        i += int(rng.geometric(p_run))
        if i < n:
            r[i] = int(np.clip(rng.geometric(p_rank), 1, 255))
            i += 1
    return r


CASES = {
    "dense": dict(p_run=0.9, p_rank=0.3),
    "sparse": dict(p_run=0.05, p_rank=0.7),
    "mixed": dict(p_run=0.3, p_rank=0.5),
}


def _ranks(name, cap=4096, m=3777):
    r = _mk_ranks(cap, seed=sorted(CASES).index(name) * 101 + 5,
                  **CASES[name])
    r[m:] = 0
    return r, m


def _extreme(name, cap=2048):
    return {
        "allzero": np.zeros(cap, np.int32),
        "allmax": np.full(cap, 255, np.int32),
        "alternate": np.where(np.arange(cap) % 2 == 0, 1, 2).astype(np.int32),
    }[name], cap


def _stream(name):
    return _extreme(name) if name in ("allzero", "allmax", "alternate") \
        else _ranks(name)


STREAMS = [*CASES, "allzero", "allmax", "alternate"]


@pytest.mark.parametrize("name", STREAMS)
def test_grc_encode_equals_tpulc(name):
    ranks, m = _stream(name)
    lb, ns = tg.grc_lane_bits(jnp.asarray(ranks), jnp.int32(m))
    plb, pns = pg.grc_lane_bits(torch.from_numpy(ranks), m)
    assert np.array_equal(plb.numpy(), np.asarray(lb)) and pns == int(ns)
    maxbits = int(plb.max())
    W = t_bucket_bits(max(maxbits, 1))
    assert pg.bucket_bits(max(maxbits, 1)) == W
    ref = tg.grc_encode(jnp.asarray(ranks), jnp.int32(m), W)
    got = pg.grc_encode(torch.from_numpy(ranks), m, W)
    for a, b, what in zip(ref, got, ("words", "counts", "states", "inits",
                                     "cinits", "tot")):
        assert np.array_equal(b.numpy().astype(np.int64),
                              np.asarray(a).astype(np.int64)), what
    if name in CASES:  # the extreme streams' decodes run 20k steps
        dec = pg.grc_decode(got[0], got[2], m, got[3], got[4], maxbits,
                            ranks.shape[0])
        assert np.array_equal(dec.numpy()[:m], ranks[:m])


@pytest.mark.parametrize("name", list(CASES))
def test_binarize_and_stats_equal_tpulc(name):
    """The event grid (port: time-major) equals tpulc's with the full
    start bucket and with a bucket below cap; so do the wired inits."""
    ranks, m = _ranks(name)
    lb, ns = pg.grc_lane_bits(torch.from_numpy(ranks), m)
    W = pg.bucket_bits(max(int(lb.max()), 1))
    gmb, lane_bits = pg._binarize(torch.from_numpy(ranks), m, W)
    assert np.array_equal(lane_bits.numpy(), lb.numpy())
    bs = 1 << max(10, (ns - 1).bit_length())
    assert bs < ranks.shape[0]
    for b in (None, bs):
        tgmb, tlb = _t_binarize(jnp.asarray(ranks), jnp.int32(m), W=W, bs=b)
        assert np.array_equal(gmb.T.numpy(), np.asarray(tgmb))
        assert np.array_equal(lane_bits.numpy(), np.asarray(tlb))
    ti, tc, tt = _t_stats_quant(tgmb)
    pi, pc, pt = pg._stats_quant(gmb)
    assert np.array_equal(pi.numpy(), np.asarray(ti))
    assert np.array_equal(pc.numpy(), np.asarray(tc))
    assert np.array_equal(pt.numpy(), np.asarray(tt))


def _walk_inputs(name):
    ranks, m = _ranks(name)
    lb, _ = pg.grc_lane_bits(torch.from_numpy(ranks), m)
    nsteps = int(lb.max())
    W = pg.bucket_bits(nsteps)
    gmb, _ = pg._binarize(torch.from_numpy(ranks), m, W)
    init, cinit, _ = pg._stats_quant(gmb)
    return ranks, m, gmb, init, cinit, nsteps, W


@pytest.mark.parametrize("name", ["dense", "mixed"])
def test_walk_probs_plain_equals_tpulc_walks(name):
    """K5's plain version against tpulc's XLA walk (rows < nsteps, the
    rows its rANS reads) and its Pallas kernel in interpret mode on the
    kernel's padded grid (every row)."""
    _, _, gmb, init, cinit, nsteps, W = _walk_inputs(name)
    L = gmb.shape[1]
    probs = pk.grc_walk_probs_plain(gmb, init, cinit, nsteps)
    assert torch.equal(probs, pk.grc_walk_probs(gmb, init, cinit, nsteps))
    assert not probs[nsteps:].any()
    xla = np.asarray(_t_walk_probs(
        jnp.asarray(gmb.T.numpy()), jnp.asarray(init.numpy()),
        jnp.asarray(cinit.numpy()),
        jnp.full((L,), nsteps, jnp.int32))).astype(np.int64)
    assert np.array_equal(probs.numpy()[:nsteps].T, xla[:, :nsteps])
    Wp = -(-W // tgp.T_BLOCK) * tgp.T_BLOCK
    Lp = -(-L // tgp.NL) * tgp.NL
    gp = np.zeros((Wp, Lp), np.int32)
    gp[:W, :L] = gmb.numpy()
    pallas = tgp.grc_walk_probs_pallas(
        jnp.asarray(gp), jnp.asarray(init.numpy()),
        jnp.asarray(cinit.numpy()), jnp.int32(nsteps), interpret=True)
    ours = pk.grc_walk_probs_plain(torch.from_numpy(gp), init, cinit, nsteps)
    assert np.array_equal(ours.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("name", ["sparse", "mixed"])
def test_decode_walk_plain_equals_tpulc_decoders(name):
    """K6's plain version against tpulc's XLA decoder and its Pallas
    kernel in interpret mode: the whole [cap] output."""
    ranks, m = _ranks(name)
    cap = ranks.shape[0]
    maxbits = int(pg.grc_lane_bits(torch.from_numpy(ranks), m)[0].max())
    words, counts, states, inits, cinits, _ = tg.grc_encode(
        jnp.asarray(ranks), jnp.int32(m), t_bucket_bits(maxbits))
    args = (words, counts, states, jnp.int32(m), inits, cinits,
            jnp.int32(maxbits), cap)
    xla = np.asarray(tg.grc_decode(*args))
    pallas = np.asarray(tgp.grc_decode_pallas(*args, interpret=True))
    ours = pg.grc_decode(torch.from_numpy(np.asarray(words).astype(np.int32)),
                         torch.from_numpy(np.asarray(states).astype(np.int64)),
                         m, torch.from_numpy(np.asarray(inits).astype(np.int32)),
                         torch.from_numpy(np.asarray(cinits).astype(np.int32)),
                         maxbits, cap)
    assert np.array_equal(ours.numpy(), xla)
    assert np.array_equal(ours.numpy(), pallas)
    assert np.array_equal(ours.numpy()[:m], ranks[:m])


def test_decode_walk_clamps_reads_and_stops_at_nsteps():
    """A stream cut short: reads clamp at the last word column, lanes
    stop after nsteps, and the plain version equals tpulc's XLA decoder
    on the same truncated words."""
    ranks, m = _ranks("mixed")
    cap = ranks.shape[0]
    maxbits = int(pg.grc_lane_bits(torch.from_numpy(ranks), m)[0].max())
    words, counts, states, inits, cinits, _ = tg.grc_encode(
        jnp.asarray(ranks), jnp.int32(m), t_bucket_bits(maxbits))
    cut = np.asarray(words)[:, :7]
    steps = maxbits // 3
    xla = np.asarray(tg.grc_decode(jnp.asarray(cut), counts, states,
                                   jnp.int32(m), inits, cinits,
                                   jnp.int32(steps), cap))
    ours = pk.grc_decode_walk_plain(
        torch.from_numpy(np.ascontiguousarray(cut).view(np.int16)),
        torch.from_numpy(np.asarray(states).view(np.int32).copy()),
        torch.from_numpy(np.asarray(inits).astype(np.int32)),
        torch.from_numpy(np.asarray(cinits).astype(np.int32)), m, steps,
        pg.GCHUNK)
    assert np.array_equal(ours.numpy().reshape(-1), xla)


def _edge_grid(case):
    """(gmb, probs, nsteps, W) of the emission's edge grids: "lanes33",
    33 lanes of any length with holes and every seventh lane empty, and
    K5's probabilities; "full_lanes", an event at every step of every
    other lane at p = 1 or 4,095 (the most words a lane emits), empty
    lanes between."""
    rng = np.random.default_rng([23, len(case)])
    if case == "lanes33":
        W, L = 96, 33
        g = rng.integers(1, 2 * pg.NM + 2, size=(W, L)).astype(np.int32)
        length = rng.integers(1, W + 1, size=L)
        length[np.arange(L) % 7 == 3] = 0
        g[np.arange(W)[:, None] >= length[None, :]] = 0
        g[rng.random((W, L)) < 0.3] = 0
        init = torch.from_numpy(rng.integers(8, 4089, size=pg.NM).astype(
            np.int32))
        cinit = torch.from_numpy(rng.integers(8, 4089, size=pg.NFAM).astype(
            np.int32))
        gmb = torch.from_numpy(g)
        return gmb, pk.grc_walk_probs(gmb, init, cinit, W), W, W
    W, L = 160, 6
    g = np.zeros((W, L), np.int32)
    p = np.zeros((W, L), np.int32)
    for lane, prob in ((0, 1), (2, 4095), (3, 1), (5, 4095)):
        g[:, lane] = rng.choice([2, 3], size=W)
        p[:, lane] = prob
    return torch.from_numpy(g), torch.from_numpy(p), W, W


@pytest.mark.parametrize("case", ["real", "empty_lane", "nsteps0",
                                  "short", "lanes33", "full_lanes"])
def test_reverse_rans_equals_tpulc(case):
    """The emission's wrapper on CPU tensors (its plain version) against
    tpulc's `_reverse_rans_t` on the same grids: words, counts and
    states.  "empty_lane" zeroes one lane's events; "short" codes only
    the first third of the rows (nsteps < W); "lanes33" and "full_lanes"
    are `_edge_grid`'s: 33 ragged lanes with holes, and full lanes at p
    = 1 and 4,095 between empty ones."""
    if case in ("lanes33", "full_lanes"):
        gmb, probs, nsteps, W = _edge_grid(case)
    else:
        _, _, gmb, init, cinit, nsteps, W = _walk_inputs("mixed")
        if case == "empty_lane":
            gmb = gmb.clone()
            gmb[:, 1] = 0
        nsteps = {"nsteps0": 0, "short": nsteps // 3}.get(case, nsteps)
        probs = pk.grc_walk_probs(gmb, init, cinit, nsteps)
    L = gmb.shape[1]
    words, counts, states = pk.grc_reverse_rans(gmb, probs, nsteps)
    tw, tc, ts = _t_reverse_rans(jnp.asarray(gmb.numpy()),
                                 jnp.asarray(probs.numpy()),
                                 jnp.int32(nsteps), L=L, W=W)
    assert words.shape == (L, W + 2) and words.dtype == torch.int32
    assert np.array_equal(words.numpy(), np.asarray(tw).astype(np.int32))
    assert np.array_equal(counts.numpy(), np.asarray(tc).astype(np.int64))
    assert np.array_equal(states.numpy(), np.asarray(ts).astype(np.int64))
    if case == "empty_lane":
        assert counts[1] == 0 and states[1] == pg.RANS_L
    if case == "nsteps0":
        assert not words.any() and not counts.any()
    if case == "full_lanes":
        assert int(counts.min()) == 0 and int(counts.max()) > W // 4


@pytest.mark.parametrize("lanes", [0, -1, 95])
@pytest.mark.parametrize("kernel", ["walk", "decode"])
def test_lanes_a_block_outside_the_shared_memory_raise(kernel, lanes):
    """K5 and K6 hold at most MAX_LANES lanes a block (94: what one
    SM's 227 KB of shared memory holds); other counts raise, on any
    device."""
    assert pk.MAX_LANES == 94
    init = torch.full((pg.NM,), 2048, dtype=torch.int32)
    cinit = torch.full((pg.NFAM,), 2048, dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        if kernel == "walk":
            pk.grc_walk_probs(torch.zeros((8, 4), dtype=torch.int32), init,
                              cinit, 4, lanes=lanes)
        else:
            pk.grc_decode_walk(torch.zeros((4, 64), dtype=torch.int16),
                               torch.zeros(4, dtype=torch.int32), init,
                               cinit, 10, 5, 1024, lanes=lanes)


def test_inits_pack_round_trip_equals_tpulc():
    rng = np.random.default_rng(3)
    tot = (rng.random(pg.NM) < 0.2).astype(np.int64) * 5
    ones = (tot > 0) * 2
    inits = pg.quantize_inits(ones, tot)
    assert np.array_equal(inits, tg.quantize_inits(ones, tot))
    blob = pg.pack_inits(inits, tot)
    assert blob == tg.pack_inits(inits, tot)
    out, off = pg.unpack_inits(b"xx" + blob, 2)
    assert off == 2 + len(blob)
    assert np.array_equal(out[tot > 0], inits[tot > 0])
    assert (out[tot == 0] == pg.SCALE // 2).all()


def test_wrappers_check_their_inputs():
    g = torch.zeros((8, 4), dtype=torch.int32)
    init = torch.full((pg.NM,), 2048, dtype=torch.int32)
    cinit = torch.full((pg.NFAM,), 2048, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.grc_walk_probs(g.long(), init, cinit, 4)
    with pytest.raises(ValueError):
        pk.grc_walk_probs(g, init[:-1], cinit, 4)
    with pytest.raises(ValueError):
        pk.grc_walk_probs(g.T, init, cinit, 4)
    w = torch.zeros((4, 64), dtype=torch.int16)
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.grc_decode_walk(w.int(), s, init, cinit, 10, 5, 1024)
    with pytest.raises(ValueError):
        pk.grc_decode_walk(w, s[:3], init, cinit, 10, 5, 1024)
    with pytest.raises(ValueError):
        pk.grc_reverse_rans(g.long(), g, 4)
    with pytest.raises(ValueError):
        pk.grc_reverse_rans(g, g[:, :3].contiguous(), 4)
    with pytest.raises(ValueError):
        pk.grc_reverse_rans(g, g.T.contiguous().T, 4)
    with pytest.raises(ValueError):
        pk.grc_reverse_rans(g.T, g.T, 4)
