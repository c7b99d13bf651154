"""The port's adaptive binary coder (`tpulc_torch/codecs/bsclike/
rans_adaptive.py` and the plain walks of `abc_kernels.py`) against
tpulc's (`tpulc/codecs/bsclike/rans_adaptive.py`, through JAX on the
CPU) on the same symbol streams, made with numpy from a seed:
`abc_stats`, `quantize_inits`, `bucket_bits`, `abc_encode`'s words,
counts and states, `abc_decode`'s symbols, on tpulc's own cases (the
full alphabet, constant streams, the lane-boundary context, two blocks,
a short valid prefix) and a mixed batch; then the plain walks against
tpulc's passes, also on the walks' edge cases (`ABC_CASES`); and the
tables the CUDA kernels read (`rcp_table`, `fsm_table`) against the
arithmetic and the binarization they stand for.  Everything is
integer: equality is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_walk_cases import ABC_CASES, abc_case, abc_states

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


@pytest.mark.parametrize("name", ABC_CASES)
def test_plain_walks_equal_tpulc_on_edge_cases(name):
    """The plain encode walk on the event grid of each edge case equals
    tpulc's abc_encode (words, counts, states), and the plain decode
    walk, from the case's states on its words, tpulc's abc_decode."""
    syms, ms, inits, kind, wc = abc_case(name)
    B, cap = syms.shape
    lcap = cap // P.ACHUNK
    st = torch.from_numpy(syms)
    ones, tot, lane_bits, lane_cls = P.abc_stats(st, ms)
    if inits is None:
        inits = P.quantize_inits(ones.numpy(), tot.numpy())
    W = P.bucket_bits(max(int(lane_bits.max()), 1))
    grid, nbits = P.event_grid(st, ms, W)
    nbits_l = nbits.numpy()
    if name == "full_and_empty":
        assert nbits_l.tolist() == [W, 0]
    if name == "lanes33":
        assert grid.shape[1] == 33
    inits_t = torch.from_numpy(inits.astype(np.int32))
    pw, pc, pst = K.abc_encode_walk_plain(grid, nbits, inits_t, lcap)
    tw, tc, ts = (np.asarray(a) for a in T.abc_encode(
        jnp.asarray(syms), jnp.asarray(ms), jnp.asarray(inits), W))
    np.testing.assert_array_equal(pw.numpy().view(np.uint16), tw)
    np.testing.assert_array_equal(pc.numpy(), tc)
    np.testing.assert_array_equal(pst.numpy(), ts.astype(np.int64))
    states = abc_states(kind, pst)
    words = pw[:, :wc].contiguous() if wc else pw
    nsteps = int(nbits.max())
    want = np.asarray(T.abc_decode(
        jnp.asarray(words.numpy().view(np.uint16)), jnp.asarray(tc),
        jnp.asarray(states.numpy().astype(np.uint32)),
        jnp.asarray(lane_cls.numpy().astype(np.int32)), jnp.asarray(ms),
        jnp.asarray(inits), jnp.int32(nsteps), B=B))
    nsym = P._lane_counts(ms, B, lcap, P.ACHUNK, torch.device("cpu"))
    got = K.abc_decode_walk_plain(words, states, lane_cls.to(torch.int32),
                                  nsym, inits_t, lcap, nsteps, P.ACHUNK)
    np.testing.assert_array_equal(got.numpy().reshape(B, -1), want)
    if kind == "true":
        for b in range(B):
            np.testing.assert_array_equal(want[b, : ms[b]], syms[b, : ms[b]])


def test_rcp_table_gives_the_exact_quotient():
    """The encode kernel's division: for every f in [1, 4096] and x at
    0, f - 1, f, f << 20 and its neighbours, 2^32 - 1 and random uint32,
    q = (x * rcp[f]) >> 32 plus one when x - q f >= f is x // f, and
    x - q f (less f then) is x % f; f = 0 divides by 1."""
    rcp = K.rcp_table().astype(np.uint64)
    assert rcp.shape == (4097,) and rcp[0] == rcp[1] == 2 ** 32 - 1
    f = np.arange(1, 4097, dtype=np.uint64)[:, None]
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.broadcast_to(np.array([0, 2 ** 32 - 1], np.uint64), (4096, 2)),
        f - 1, f, f + 1, (f << 20) - 1, f << 20, (f << 20) + 1,
        rng.integers(0, 2 ** 32, size=(4096, 64), dtype=np.uint64)], axis=1)
    x = x & np.uint64(2 ** 32 - 1)
    q = (x * rcp[1:, None]) >> np.uint64(32)
    r = x - q * f
    over = r >= f
    q, r = q + over, np.where(over, r - f, r)
    np.testing.assert_array_equal(q, x // f)
    np.testing.assert_array_equal(r, x % f)


def test_fsm_table_follows_every_symbols_events():
    """The decode kernel's FSM table against tpulc's binarization: for
    every symbol 0..256 in every context (c1 in 0..7, c2 in 0..3), the
    table walked from the state min(c1, 3) * 256 + c1 * 4 + c2 on the
    symbol's bits visits the symbol's event models (a state's model is
    its low 7 bits), completes the symbol at its last event and nowhere
    before, rebuilds its value, and moves to the state of the next E0
    event: min(ctx_class(s), 3) * 256 + ctx_class(s) * 4 + min(c1, 3).
    Every (state, bit) pair the decode can meet lies on such a path:
    the binarization is a complete prefix code.  Every move leads to a
    state of a model below 117."""
    tab = K.fsm_table().astype(np.int64)
    assert tab.shape == (1024, 2)
    assert ((tab & 1023) & 127 < K.NMODELS).all()
    s = torch.arange(257)
    cls = P._cls(s).numpy()
    seen = set()
    for c1 in range(8):
        for c2 in range(4):
            full = torch.full((257,), 0, dtype=torch.int64)
            bz = P._Binarized(s, full + c1, full + c2)
            slots = [[a.numpy() for a in bz.slot(q)]
                     for q in range(P.MAX_SYM_BITS)]
            for sym in range(257):
                k, v1, done = min(c1, 3) * 256 + c1 * 4 + c2, 0, False
                for model, bit, valid in slots:
                    if not valid[sym]:
                        break
                    assert not done and k & 127 == model[sym]
                    seen.add((k, int(bit[sym])))
                    mv = int(tab[k, bit[sym]])
                    v1 = 1 if mv & K.FSM_VSET else (v1 << 1) | int(bit[sym])
                    kind = (mv >> 11) & 3
                    k = mv & 1023
                    if mv & K.FSM_EMIT:
                        done = True
                        assert (v1 + 1 if kind == 3 else kind) == sym
                        c = int(cls[sym])
                        assert kind == min(c, 3)
                        assert k == min(c, 3) * 256 + c * 4 + min(c1, 3)
                assert done
    # every move of every state a walk reaches was taken
    reach = {k for k, _ in seen}
    assert all((k, b) in seen for k in reach for b in (0, 1))


def test_chip_smoke_encode_chain_is_the_longest_dependence():
    """chip_smoke.abc_encode_chain, the encode walk's chain bound,
    equals a scalar count on random event grids: event t's probability
    waits on the earlier events of its model (5 operations each), the
    reverse pass's step t on the steps after it (6 each), so a lane
    needs max over its events of 5 k_t + 6 (t + 1)."""
    import chip_smoke

    rng = np.random.default_rng(3)
    for W, L in ((50, 7), (300, 70), (64, 1), (8, 3)):
        grid = rng.integers(0, 12, size=(W, L)).astype(np.uint8)
        grid[:, 0] = 0 if L == 3 else grid[:, 0]  # a lane without events
        nbits = rng.integers(0, W + 1, size=L).astype(np.int32)
        want = 0
        for lane in range(L):
            seen = {}
            for t in range(int(nbits[lane])):
                e = int(grid[t, lane])
                if e:
                    m = min(max((e >> 1) - 1, 0), K.NMODELS - 1)
                    want = max(want, 5 * seen.get(m, 0) + 6 * (t + 1))
                    seen[m] = seen.get(m, 0) + 1
        assert chip_smoke.abc_encode_chain(
            torch, torch.from_numpy(grid), torch.from_numpy(nbits),
            lanes=3) == want
