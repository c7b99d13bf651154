"""tpulc_torch MTF vs tpulc: `mtf_encode`/`mtf_decode` bit-identical,
the plain versions of K1, K2 and K4 equal to tpulc's Pallas kernels
run in interpret mode (16 chunks x 128, as test_primitives2 runs K4; K1
also on its edge cases), and K1's tile maxima scanned equal to tpulc's
scan over chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_walk_cases import K1_CASES, K1_SHAPES, k1_case, k1_reference

from tpulc.primitives import mtf as jmtf
from tpulc.primitives import mtf_pallas
from tpulc_torch.primitives import mtf_kernels
from tpulc_torch.primitives.mtf import mtf_decode, mtf_encode

torch.set_num_threads(1)


def _rand(n, seed, alphabet=256):
    rng = np.random.default_rng(seed)
    return rng.integers(0, alphabet, size=n).astype(np.uint8)


@pytest.mark.parametrize("alphabet", [2, 16, 256])
@pytest.mark.parametrize("n", [128, 4096])
def test_mtf_encode_matches_tpulc_and_gold(n, alphabet):
    data = _rand(n, n + alphabet, alphabet)
    got = mtf_encode(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, jmtf.mtf_encode_np(data))
    np.testing.assert_array_equal(got, np.asarray(jmtf.mtf_encode(
        jnp.asarray(data))))


@pytest.mark.parametrize("n", [128, 512, 8192])
def test_mtf_decode_matches_tpulc(n):
    ranks = jmtf.mtf_encode(jnp.asarray(_rand(n, n)))
    want = np.asarray(jmtf.mtf_decode(ranks))
    got = mtf_decode(torch.from_numpy(np.array(ranks))).numpy()
    np.testing.assert_array_equal(got, want)


def test_mtf_clustered_roundtrip():
    data = np.repeat(_rand(128, 99), 32)[:4096]
    enc = mtf_encode(torch.from_numpy(data))
    assert (enc.numpy() == 0).mean() > 0.9
    np.testing.assert_array_equal(mtf_decode(enc).numpy(), data)


def _tables_and_seq(seed):
    rng = np.random.default_rng(seed)
    t0 = np.stack([rng.permutation(256) for _ in range(16)]).astype(np.int32)
    seq = rng.integers(0, 256, size=(16, 128)).astype(np.int32)
    return t0, seq


@pytest.mark.parametrize("name,nchunks,C", [
    ("seq15", 16, 128),
    *((name, n, C) for name in K1_CASES for n, C in K1_SHAPES)])
def test_k1_recency_plain_matches_pallas_interpret(name, nchunks, C):
    """`seq15`: 16 random chunks, one of a single symbol; then every K1
    case (runs, symbols outside [0, 256)) at every chunk length and at
    chunk counts of 0, 1 and no multiple of tpulc's 128-chunk tile,
    against the scalar contract and (past 0 chunks) tpulc's kernel."""
    if name == "seq15":
        _, syms = _tables_and_seq(15)
        syms[3] = 7  # one chunk of a single symbol
    else:
        syms = k1_case(name, nchunks, C).numpy()
    got = mtf_kernels.mtf_recency(torch.from_numpy(syms)).numpy()
    np.testing.assert_array_equal(got, k1_reference(syms))
    if nchunks:
        want = np.asarray(mtf_pallas.mtf_recency_pallas(jnp.asarray(syms),
                                                        interpret=True))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", mtf_kernels.START_TILES)
@pytest.mark.parametrize("name", K1_CASES)
def test_tile_maxima_scanned_equal_tpulcs_scan(name, tile):
    """K1's tile maxima (`mtf_tile_max_plain`, what K1 writes on the card
    with `partials`), scanned exclusively over tiles, equal tpulc's
    exclusive `associative_scan(maximum)` over chunks
    (`tpulc/primitives/mtf.py:85-89`) at each tile's first chunk."""
    for nchunks, C in K1_SHAPES:
        syms = k1_case(name, nchunks, C)
        rec, part, t = mtf_kernels.mtf_recency(syms, partials=True, tile=tile)
        assert t == tile
        assert torch.equal(part, mtf_kernels.mtf_tile_max_plain(rec, C, tile))
        ntiles = -(-nchunks // tile)
        assert part.shape == (256, ntiles) and part.dtype == torch.int32
        if nchunks == 0:
            continue
        excl = torch.cat([torch.full((256, 1), -1, dtype=torch.int32),
                          torch.cummax(part, dim=1).values[:, :-1]], dim=1)
        base = (jnp.arange(nchunks, dtype=jnp.int32) * C)[:, None]
        r = jnp.asarray(rec.numpy())
        recency = jnp.where(r >= 0, r + base, -1)
        incl = jax.lax.associative_scan(jnp.maximum, recency, axis=0)
        before = jnp.concatenate([jnp.full((1, 256), -1, jnp.int32),
                                  incl[:-1]], axis=0)
        np.testing.assert_array_equal(excl.numpy().T,
                                      np.asarray(before)[::tile])


def test_k2_encode_plain_matches_pallas_interpret():
    t0, syms = _tables_and_seq(16)
    want_r, want_t = mtf_pallas.mtf_encode_lockstep_pallas(
        jnp.asarray(t0), jnp.asarray(syms), interpret=True)
    got_r, got_t = mtf_kernels.mtf_encode_lockstep(torch.from_numpy(t0),
                                                   torch.from_numpy(syms))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_k4_lockstep_plain_matches_pallas_interpret():
    t0, ranks = _tables_and_seq(17)
    want_s, want_t = mtf_pallas.mtf_lockstep_pallas(
        jnp.asarray(t0), jnp.asarray(ranks), interpret=True)
    got_s, got_t = mtf_kernels.mtf_lockstep(torch.from_numpy(t0),
                                            torch.from_numpy(ranks))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    t0, seq = _tables_and_seq(18)
    with pytest.raises(ValueError):
        mtf_kernels.mtf_lockstep(torch.from_numpy(t0).long(),
                                 torch.from_numpy(seq))
    with pytest.raises(ValueError):
        mtf_kernels.mtf_recency(torch.from_numpy(seq).T)
    with pytest.raises(ValueError):
        mtf_kernels.mtf_encode_lockstep(torch.from_numpy(t0)[:8],
                                        torch.from_numpy(seq))
