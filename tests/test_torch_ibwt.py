"""The anchored inverse-BWT lane walk (`tpulc_torch.codecs.bwt.
ibwt_kernels.anchored_walk`), whose plain version both of the port's
anchored inverses run on the CPU, against tpulc's
`rotsort.bwt_decode_anchored` and `masked.bwt_decode_masked_anchored`
run through JAX on the same `last` column and anchors: bit-identical
over the whole output, and the block back.  The CUDA kernel is held
against the plain version in `test_torch_cuda_kernels.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.bwt import masked as tm
from tpulc.codecs.bwt import rotsort as trot
from tpulc_torch.codecs.bwt import ibwt_kernels as ik
from tpulc_torch.codecs.bwt import masked as pm
from tpulc_torch.codecs.bwt import rotsort as prot

torch.set_num_threads(1)

STRIDES = [512, 1024]   # bz's and bsc's anchor strides
MASKED_CAP = 51_000     # one capacity, so tpulc's masked decode compiles once


def _block(src: str, n: int) -> np.ndarray:
    if src == "pg1661":
        with open("tests/data/pg1661.txt", "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)
        return raw[1234: 1234 + n].copy()
    return np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)


def _sizes(S):
    return [1, S - 1, S, S + 1, 50_000]


CASES = [(src, S, n) for S in STRIDES for n in _sizes(S)
         for src in ("pg1661", "random")]
IDS = [f"{src}-S{S}-n{n}" for src, S, n in CASES]


@pytest.mark.parametrize("src,S,n", CASES, ids=IDS)
def test_rotsort_anchored_inverse_equals_tpulc(src, S, n):
    data = _block(src, n)
    last, idx0, anchors, ok = prot.bwt_encode_anchored(
        torch.from_numpy(data), S)
    assert ok
    want = np.asarray(trot.bwt_decode_anchored(
        jnp.asarray(last.numpy()), jnp.int32(idx0),
        jnp.asarray(anchors.numpy()), S))
    got = prot.bwt_decode_anchored(last, anchors, S)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), data)


@pytest.mark.parametrize("src,S,n", CASES, ids=IDS)
def test_masked_anchored_inverse_equals_tpulc(src, S, n):
    """cap > n: lanes past n start at idx0 and write nothing, and the
    output is 0 past n."""
    data = _block(src, n)
    padded = np.zeros(MASKED_CAP, np.uint8)
    padded[:n] = data
    last, idx0, anchors, ok = pm.bwt_encode_masked_anchored(
        torch.from_numpy(padded), n, S)
    assert ok and anchors.shape[0] == -(-MASKED_CAP // S)
    want = np.asarray(tm.bwt_decode_masked_anchored(
        jnp.asarray(last.numpy()), jnp.int32(n), jnp.int32(idx0),
        jnp.asarray(anchors.numpy()), S))
    got = pm.bwt_decode_masked_anchored(last, n, anchors, S)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:n].numpy(), data)
    assert not got[n:].any()


def test_walk_lanes_ragged_tail_and_argument_checks():
    """The walk reads only the ceil(n / S) lanes that write (int32 or
    int64 anchors alike), zero-fills past n, counts no launch on the
    CPU, and refuses too few anchors and wrong dtypes or shapes."""
    S, n, cap = 512, 2_000, 3_000
    padded = np.zeros(cap, np.uint8)
    padded[:n] = _block("pg1661", n)
    last, _, anchors, _ = pm.bwt_encode_masked_anchored(
        torch.from_numpy(padded), n, S)
    T = pm._lf_map(last, n)
    before = ik.anchored_walk.launches
    lanes = -(-n // S)
    want = ik.anchored_walk_plain(T, last, anchors, n, S, cap)
    for a in (anchors[:lanes], anchors.to(torch.int64)):
        np.testing.assert_array_equal(
            ik.anchored_walk(T, last, a, n, S, cap).numpy(), want.numpy())
    np.testing.assert_array_equal(want[:n].numpy(), padded[:n])
    assert not want[n:].any()
    assert ik.anchored_walk.launches == before
    empty = ik.anchored_walk(T, last, anchors[:0], 0, S, cap)
    assert empty.shape == (cap,) and not empty.any()
    for args in ((T, last, anchors[:lanes - 1], n, S, cap),
                 (T.to(torch.int32), last, anchors, n, S, cap),
                 (T, last.to(torch.int32), anchors, n, S, cap),
                 (T, last, anchors.to(torch.float32), n, S, cap),
                 (T, last, anchors, cap + 1, S, cap),
                 (T, last, anchors, n, 0, cap)):
        with pytest.raises(ValueError):
            ik.anchored_walk(*args)
