"""The port's dynamic-length BWT (`tpulc_torch.codecs.bwt.masked`)
against tpulc's on the same padded numpy blocks: ranks, idx0, anchors
and ok equal (tolerance 0), and both inverses equal tpulc's over the
whole capacity and give the block back; the unanchored RLE2 forward's
symbols and histogram equal tpulc's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.bwt import masked as tm
from tpulc.primitives.mtf import mtf_decode as t_mtf_decode
from tpulc_torch.codecs.bwt import masked as pm

torch.set_num_threads(1)
S = 1024  # the bsc codec's anchor stride


def _case(name):
    with open("tests/data/pg1661.txt", "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    rng = np.random.default_rng(11)
    return {
        "text_n_lt_cap": (raw[1000:4000], 4096),
        "text_full": (raw[:2048], 2048),
        "random": (rng.integers(0, 256, 5000).astype(np.uint8), 8192),
        "zero_tail": (np.concatenate([raw[:1000], np.zeros(300, np.uint8)]),
                      2048),
        "periodic": (np.tile(np.frombuffer(b"abcab", np.uint8), 400), 2048),
        "one_byte": (raw[:1], 1024),
        "empty": (raw[:0], 1024),
    }[name]


CASES = ["text_n_lt_cap", "text_full", "random", "zero_tail", "periodic",
         "one_byte", "empty"]


@pytest.mark.parametrize("name", CASES)
def test_forward_ranks_anchored_equals_tpulc(name):
    data, cap = _case(name)
    n = data.shape[0]
    padded = np.zeros(cap, np.uint8)
    padded[:n] = data
    ranks, idx0, anchors, ok = tm.forward_ranks_anchored(
        jnp.asarray(padded), jnp.int32(n), S)
    pr, pidx0, panchors, pok = pm.forward_ranks_anchored(
        torch.from_numpy(padded), n, S)
    assert np.array_equal(pr.numpy(), np.asarray(ranks))
    assert pidx0 == int(idx0)
    assert np.array_equal(panchors.numpy(), np.asarray(anchors))
    assert pok == bool(ok)
    assert pok == (name != "periodic")  # periodic -> doubling fallback

    # both inverses: equal to tpulc's over the whole capacity
    t_ranks = jnp.asarray(pr.numpy())
    anch = pm.inverse_ranks_anchored(pr, n, panchors, S)
    t_anch = tm.inverse_ranks_anchored(t_ranks, jnp.int32(n),
                                       jnp.int32(pidx0),
                                       jnp.asarray(panchors.numpy()), S)
    assert np.array_equal(anch.numpy(), np.asarray(t_anch))
    dbl = pm.inverse_ranks(pr, n, pidx0)
    t_dbl = tm.bwt_decode_masked(
        t_mtf_decode(t_ranks.astype(jnp.uint8)), jnp.int32(n),
        jnp.int32(pidx0))
    assert np.array_equal(dbl.numpy(), np.asarray(t_dbl))
    assert np.array_equal(dbl.numpy()[:n], data)
    if pok:
        assert np.array_equal(anch.numpy()[:n], data)


@pytest.mark.parametrize("name", CASES)
def test_forward_masked_equals_tpulc(name):
    """bsc's unanchored forward (syms, m, idx0 and the histogram of
    syms[:m], a `prefix_hist`) equals tpulc's `forward_masked`."""
    data, cap = _case(name)
    n = data.shape[0]
    padded = np.zeros(cap, np.uint8)
    padded[:n] = data
    syms, m, idx0, hist = tm.forward_masked(jnp.asarray(padded),
                                            jnp.int32(n))
    ps, pm_, pidx0, phist = pm.forward_masked(torch.from_numpy(padded), n)
    assert np.array_equal(ps.numpy(), np.asarray(syms))
    assert int(pm_) == int(m) and pidx0 == int(idx0)
    assert np.array_equal(phist.numpy(), np.asarray(hist))
    assert int(phist.sum()) == int(m)


def test_bwt_encode_masked_last_column_equals_tpulc():
    data, cap = _case("text_n_lt_cap")
    padded = np.zeros(cap, np.uint8)
    padded[: data.shape[0]] = data
    last, idx0, anchors, ok = tm.bwt_encode_masked_anchored(
        jnp.asarray(padded), jnp.int32(data.shape[0]), S)
    pl, pidx0, pa, pok = pm.bwt_encode_masked_anchored(
        torch.from_numpy(padded), data.shape[0], S)
    assert np.array_equal(pl.numpy(), np.asarray(last))
    assert (pidx0, pok) == (int(idx0), bool(ok))
    assert np.array_equal(pa.numpy(), np.asarray(anchors))
