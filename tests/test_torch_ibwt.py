"""The anchored inverse-BWT lane walk (`tpulc_torch.codecs.bwt.
ibwt_kernels.anchored_walk`), whose plain version both of the port's
anchored inverses run on the CPU, against tpulc's
`rotsort.bwt_decode_anchored` and `masked.bwt_decode_masked_anchored`
run through JAX on the same `last` column and anchors: bit-identical
over the whole output, and the block back.  The CUDA kernel is held
against the plain version in `test_torch_cuda_kernels.py`."""

import functools

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
                 (T.to(torch.int64), last, anchors, n, S, cap),
                 (T, last.to(torch.int32), anchors, n, S, cap),
                 (T, last, anchors.to(torch.float32), n, S, cap),
                 (T, last, anchors, cap + 1, S, cap),
                 (T, last, anchors, n, 0, cap)):
        with pytest.raises(ValueError):
            ik.anchored_walk(*args)


@functools.lru_cache(maxsize=None)
def _last_column(src: str, n: int, masked: bool) -> np.ndarray:
    """A block's real last column: the rotation sort's (length n) or the
    masked BWT's (capacity MASKED_CAP, zeros past n)."""
    data = _block(src, n)
    if not masked:
        last, _, _, ok = prot.bwt_encode_anchored(torch.from_numpy(data),
                                                  512)
    else:
        padded = np.zeros(MASKED_CAP, np.uint8)
        padded[:n] = data
        last, _, _, ok = pm.bwt_encode_masked_anchored(
            torch.from_numpy(padded), n, 512)
    assert ok
    return last.numpy()


def _lf_of(last: np.ndarray, n: int, masked: bool) -> torch.Tensor:
    t = torch.from_numpy(last)
    return pm._lf_map(t, n) if masked else prot._lf_map(t)


LF_CASES = [(src, S, n, masked) for src, S, n in CASES
            for masked in (False, True)]
LF_IDS = [f"{src}-S{S}-n{n}-{'masked' if m else 'rotsort'}"
          for src, S, n, m in LF_CASES]


@pytest.mark.parametrize("src,S,n,masked", LF_CASES, ids=LF_IDS)
def test_lf_map_buckets_give_the_last_column(src, S, n, masked):
    """The invariant the walk kernel reads its bytes by: with C the
    cumulative byte counts of last[:n] (257 values), the successor T[p]
    of every row p < n lies in last[p]'s bucket [C[c], C[c + 1]), so
    searchsorted(C, T[:n], right=True) - 1 == last[:n]; and T[:n] is a
    permutation of [0, n)."""
    last = _last_column(src, n, masked)
    T = _lf_of(last, n, masked).numpy()
    C = np.concatenate([[0], np.cumsum(np.bincount(last[:n],
                                                   minlength=256))])
    assert C.shape == (257,) and C[-1] == n
    np.testing.assert_array_equal(
        np.searchsorted(C, T[:n], side="right") - 1, last[:n])
    np.testing.assert_array_equal(np.sort(T[:n]), np.arange(n))


@pytest.mark.parametrize("src,S,n,masked", LF_CASES, ids=LF_IDS)
def test_lf_map_int32_equals_int64(src, S, n, masked):
    """Both `_lf_map`s return int32 (the walk's 4-byte table entry) with
    the values of the int64 map: numpy's stable argsort scattered for the
    rotation sort's, tpulc's masked `_lf_map` through JAX for the masked
    one (padding rows map to themselves)."""
    last = _last_column(src, n, masked)
    got = _lf_of(last, n, masked)
    assert got.dtype == torch.int32
    if masked:
        want = np.asarray(tm._lf_map(jnp.asarray(last), jnp.int32(n)))
    else:
        want = np.empty(n, np.int64)
        want[np.argsort(last, kind="stable")] = np.arange(n)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


def test_plain_walk_zeroes_lanes_anchored_in_the_padding():
    """The anchor contract on a masked block (cap > n): an anchor in [n,
    cap) is a padding row, which has no byte in C, so its lane reads
    nothing and writes zeros over its run, as does a negative anchor;
    the other lanes give the block back."""
    S, n, cap = 512, 2_000, 3_000
    padded = np.zeros(cap, np.uint8)
    padded[:n] = _block("pg1661", n)
    last, _, anchors, _ = pm.bwt_encode_masked_anchored(
        torch.from_numpy(padded), n, S)
    T = pm._lf_map(last, n)
    for a_dtype in (torch.int32, torch.int64):
        bad = anchors.to(a_dtype).clone()
        bad[1], bad[3] = n, cap - 1
        bad[2] = -1
        out = ik.anchored_walk(T, last, bad, n, S, cap).numpy()
        keep = np.ones(cap, bool)
        for j in (1, 2, 3):
            run = slice(max(n - (j + 1) * S, 0), n - j * S)
            assert not out[run].any()
            keep[run] = False
        np.testing.assert_array_equal(out[keep], padded[keep])


def test_plain_walk_zeroes_int64_anchors_past_int32():
    """An int64 anchor is read at its own width: one whose low 32 bits
    name a real row, 2^32 + that row, is outside [0, n), so its lane
    writes zeros while the same row as an anchor gives the lane back."""
    S, n = 512, 2_000
    data = _block("pg1661", n)
    last, _, anchors, _ = prot.bwt_encode_anchored(torch.from_numpy(data),
                                                   S)
    T = prot._lf_map(last)
    wide = anchors.to(torch.int64)
    bad = wide.clone()
    bad[1] = (1 << 32) + int(wide[1])
    run = slice(n - 2 * S, n - S)
    out = ik.anchored_walk(T, last, bad, n, S, n).numpy()
    assert not out[run].any()
    np.testing.assert_array_equal(
        ik.anchored_walk(T, last, wide, n, S, n).numpy(), data)
    keep = np.ones(n, bool)
    keep[run] = False
    np.testing.assert_array_equal(out[keep], data[keep])
