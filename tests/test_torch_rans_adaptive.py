"""The port's adaptive binary coder (`tpulc_torch/codecs/bsclike/
rans_adaptive.py` and the plain walks of `abc_kernels.py`) against
tpulc's (`tpulc/codecs/bsclike/rans_adaptive.py`, through JAX on the
CPU) on the same symbol streams, made with numpy from a seed:
`abc_stats`, `quantize_inits`, `bucket_bits`, `abc_encode`'s words,
counts and states, `abc_decode`'s symbols, on tpulc's own cases (the
full alphabet, constant streams, the lane-boundary context, two blocks,
a short valid prefix) and a mixed batch; then the plain walks against
tpulc's passes.  Everything is integer: equality is exact (tolerance
0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.bsclike import rans_adaptive as T
from tpulc_torch.codecs.bsclike import abc_kernels as K
from tpulc_torch.codecs.bsclike import rans_adaptive as P

torch.set_num_threads(1)

CAP = 2 * P.ACHUNK  # two lanes a block


def _case(name: str):
    """(syms int32[B, CAP], ms int32[B]) of each of tpulc's cases."""
    rng = np.random.default_rng(len(name))
    if name == "full_alphabet":
        s = np.minimum(rng.geometric(0.35, size=CAP) - 1, 256)
        s[:257] = np.arange(257)
        return s[None], np.array([CAP])
    if name.startswith("const"):
        return np.full((1, CAP), int(name[5:])), np.array([CAP])
    if name == "lane_boundary":
        s = rng.integers(0, 20, size=CAP)
        s[P.ACHUNK - 3: P.ACHUNK + 3] = [17, 0, 5, 9, 0, 3]
        return s[None], np.array([CAP])
    if name == "two_blocks":
        a = np.minimum(rng.geometric(0.6, size=CAP) - 1, 256)
        b = rng.integers(0, 257, size=CAP)
        return np.stack([a, b]), np.array([CAP, CAP])
    if name == "short_prefix":
        s = np.minimum(rng.geometric(0.5, size=CAP) - 1, 256)
        return s[None], np.array([P.ACHUNK + 37])
    # three blocks, one empty and one of a few symbols (stream pads 256)
    s = np.minimum(rng.geometric(0.3, size=(3, CAP)) - 1, 256)
    s[1, 5:] = 256
    return s, np.array([CAP - 100, 5, 0])


CASES = ["full_alphabet", "const0", "const1", "const2", "const255",
         "const256", "lane_boundary", "two_blocks", "short_prefix", "mixed"]


@pytest.fixture(scope="module", params=CASES)
def coded(request):
    """Both packages' statistics, inits, W and encode of one case."""
    syms, ms = _case(request.param)
    syms, ms = syms.astype(np.int32), ms.astype(np.int32)
    theirs = [np.asarray(a) for a in T.abc_stats(jnp.asarray(syms),
                                                 jnp.asarray(ms))]
    ours = [a.numpy() for a in P.abc_stats(torch.from_numpy(syms), ms)]
    inits = T.quantize_inits(theirs[0], theirs[1])
    W = T.bucket_bits(max(int(theirs[2].max()), 1))
    t_enc = [np.asarray(a) for a in T.abc_encode(
        jnp.asarray(syms), jnp.asarray(ms), jnp.asarray(inits), W)]
    p_enc = P.abc_encode(torch.from_numpy(syms), ms,
                         torch.from_numpy(inits.astype(np.int32)), W)
    return request.param, syms, ms, theirs, ours, inits, W, t_enc, p_enc


def test_stats_inits_and_bucket_equal_tpulc(coded):
    _, _, _, theirs, ours, inits, W, _, _ = coded
    for t, o in zip(theirs, ours):
        np.testing.assert_array_equal(o, t.astype(np.int64))
    np.testing.assert_array_equal(P.quantize_inits(ours[0], ours[1]), inits)
    assert P.bucket_bits(int(ours[2].max())) == W


def test_encode_equals_tpulc(coded):
    name, _, _, _, _, _, _, (tw, tc, ts), (pw, pc, pst) = coded
    np.testing.assert_array_equal(pw.numpy().view(np.uint16), tw)
    np.testing.assert_array_equal(pc.numpy(), tc)
    np.testing.assert_array_equal(pst.numpy(), ts.astype(np.int64))
    if name.startswith("const"):
        assert int(pc.sum()) < 2 * (CAP // P.ACHUNK) + 20


def test_decode_equals_tpulc_and_the_symbols(coded):
    _, syms, ms, theirs, ours, inits, _, (tw, tc, ts), (pw, _, pst) = coded
    B = syms.shape[0]
    nsteps = int(theirs[2].max())
    want = np.asarray(T.abc_decode(
        jnp.asarray(tw), jnp.asarray(tc), jnp.asarray(ts),
        jnp.asarray(theirs[3].astype(np.int32)), jnp.asarray(ms),
        jnp.asarray(inits), jnp.int32(nsteps), B=B))
    got = P.abc_decode(pw, pst, torch.from_numpy(ours[3]), ms,
                       torch.from_numpy(inits.astype(np.int32)), nsteps,
                       B).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        np.testing.assert_array_equal(got[b, : ms[b]], syms[b, : ms[b]])


def test_inits_shape():
    assert P.NMODELS == T.NMODELS == 117
    ones, tot = np.zeros((1, 117)), np.zeros((1, 117))
    tot[0, :5] = 100
    ones[0, :5] = [0, 1, 50, 99, 100]
    q = P.quantize_inits(ones, tot)
    np.testing.assert_array_equal(q, T.quantize_inits(ones, tot))
    assert (q[0, 5:] == 2048).all()


@pytest.mark.parametrize("maxbits", [1, 255, 256, 257, 384, 385, 5000,
                                     16384])
def test_bucket_bits_equals_tpulc(maxbits):
    for lo in (64, 256, 1024):
        assert P.bucket_bits(maxbits, lo) == T.bucket_bits(maxbits, lo)


def test_plain_walks_equal_tpulc_passes():
    """The plain encode walk's probabilities and words are tpulc's
    model and reverse passes on a grid of events; the event grid is
    tpulc's [lanes, W] grid transposed; the plain decode walk from
    random states (garbage symbols) equals tpulc's FSM."""
    syms, ms = _case("mixed")
    syms = syms.astype(np.int32)
    ones, tot, lane_bits, lane_cls = P.abc_stats(torch.from_numpy(syms), ms)
    inits = P.quantize_inits(ones.numpy(), tot.numpy())
    W = P.bucket_bits(int(lane_bits.max()))
    grid, nbits = P.event_grid(torch.from_numpy(syms), ms, W)
    assert grid.dtype == torch.uint8 and int(grid.max()) <= 235
    np.testing.assert_array_equal(nbits.numpy(), lane_bits.numpy())
    tw, tc, ts = T.abc_encode(jnp.asarray(syms), jnp.asarray(ms),
                              jnp.asarray(inits), W)
    inits_t = torch.from_numpy(inits.astype(np.int32))
    pw, pc, pst = K.abc_encode_walk_plain(grid, nbits, inits_t,
                                          CAP // P.ACHUNK)
    np.testing.assert_array_equal(pw.numpy().view(np.uint16), np.asarray(tw))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(tc))
    states = np.random.default_rng(2).integers(0, 1 << 32, pst.shape[0],
                                               dtype=np.uint64)
    nsteps = int(lane_bits.max())
    want = np.asarray(T.abc_decode(
        tw, tc, jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(lane_cls.numpy().astype(np.int32)), jnp.asarray(ms),
        jnp.asarray(inits), jnp.int32(nsteps), B=3))
    nsym = P._lane_counts(ms, 3, CAP // P.ACHUNK, P.ACHUNK,
                          torch.device("cpu"))
    got = K.abc_decode_walk_plain(
        pw, torch.from_numpy(states.astype(np.int64)),
        lane_cls.to(torch.int32), nsym, inits_t, CAP // P.ACHUNK, nsteps,
        P.ACHUNK)
    np.testing.assert_array_equal(got.numpy().reshape(3, -1), want)
