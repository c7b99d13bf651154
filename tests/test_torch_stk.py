"""The port's ST-k sorter (`tpulc_torch/codecs/bwt/stk.py`) against
tpulc's (`tpulc/codecs/bwt/stk.py`) on the same inputs, made with numpy
from a seed: the forward sort's last column and idx0 (masked, against
`st_encode_masked` and the naive gold `st_encode_np`), the context
keys, the hybrid inverse through the copied C walk against tpulc's
`st_decode`, and the wired forward, predecessor permutation and device
inverse.  Everything is integer: equality is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.bwt import stk as T
from tpulc_torch.codecs.bwt import stk as P
from tpulc_torch.gold.st_inverse import st_inverse

torch.set_num_threads(1)

CAP = 1024


def _data(name: str, n: int, cap: int = CAP) -> np.ndarray:
    """uint8[cap] with the first n bytes real, the rest zero."""
    rng = np.random.default_rng(len(name) * 7 + n)
    out = np.zeros(cap, np.uint8)
    if name == "text":
        with open("tests/data/pg1661.txt", "rb") as f:
            out[:n] = np.frombuffer(f.read()[:n], np.uint8)
    elif name == "ternary":
        out[:n] = rng.integers(0, 3, n)
    elif name == "periodic":
        out[:n] = np.tile(np.frombuffer(b"abcab", np.uint8), n // 5 + 1)[:n]
    else:
        out[:n] = rng.integers(0, 256, n)
    return out


CASES = [("text", 1000), ("ternary", 777), ("periodic", 600),
         ("random", CAP), ("text", 1), ("ternary", 5), ("random", 0)]


@pytest.mark.parametrize("k", range(3, 9))
@pytest.mark.parametrize("name,n", CASES)
def test_st_forward_equals_tpulc_and_gold(name, n, k):
    data = _data(name, n)
    l1, i1 = T.st_encode_masked(jnp.asarray(data), jnp.int32(n), k)
    l2, i2 = P.st_encode_masked(torch.from_numpy(data), n, k)
    np.testing.assert_array_equal(l2.numpy(), np.asarray(l1))
    assert int(i2) == int(i1)
    if n:
        lg, ig = T.st_encode_np(data[:n], k)
        np.testing.assert_array_equal(l2.numpy()[:n], lg)
        assert int(i2) == ig
        assert not l2.numpy()[n:].any()


@pytest.mark.parametrize("k", [3, 5, 8])
@pytest.mark.parametrize("name,n", CASES[:5])
def test_st_context_keys_and_hybrid_inverse(name, n, k):
    data = _data(name, n)
    l1, i1 = T.st_encode_masked(jnp.asarray(data), jnp.int32(n), k)
    last, idx0 = np.array(l1)[:n], int(i1)
    h1, lo1 = T.st_context_keys(jnp.asarray(last), k)
    h2, lo2 = P.st_context_keys(torch.from_numpy(last), k)
    np.testing.assert_array_equal(h2.numpy(), np.asarray(h1).astype(np.int64))
    np.testing.assert_array_equal(lo2.numpy(),
                                  np.asarray(lo1).astype(np.int64))
    ours = P.st_decode(torch.from_numpy(last), idx0, k)
    np.testing.assert_array_equal(ours, T.st_decode(last, idx0, k))
    np.testing.assert_array_equal(ours, data[:n])


def test_hybrid_inverse_refuses_a_bad_primary_index():
    """tpulc's walk reads L[idx0] before it checks anything; the port
    checks idx0 first, and a walk that finds no slot raises too."""
    data = _data("text", 500)
    last, idx0 = P.st_encode_masked(torch.from_numpy(data), 500, 8)
    for bad in (500, 10 ** 6, -1):
        with pytest.raises(ValueError, match="idx0"):
            P.st_decode(last[:500], bad, 8)
    hi, lo = P.st_context_keys(last[:500], 8)
    hi = hi.numpy().astype(np.uint32)
    with pytest.raises(ValueError, match="walk failed"):
        st_inverse(last[:500].numpy(), hi[::-1].copy(),
                   lo.numpy().astype(np.uint32), int(idx0), 8)


@pytest.mark.parametrize("k", [3, 6, 8])
@pytest.mark.parametrize("name,n", CASES)
def test_st_wired_forward_and_device_inverse(name, n, k):
    data = _data(name, n)
    a1, f1, j1 = T.st_encode_with_next_masked(jnp.asarray(data),
                                              jnp.int32(n), k)
    a2, f2, j2 = P.st_encode_with_next_masked(torch.from_numpy(data), n, k)
    np.testing.assert_array_equal(a2.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
    assert int(j2) == int(j1)
    p1 = T.st_predecessor_perm_masked(a1, f1, j1, jnp.int32(n), k)
    p2 = P.st_predecessor_perm_masked(a2, f2, int(j2), n, k)
    np.testing.assert_array_equal(p2.numpy(), np.asarray(p1))
    o1 = T.st_decode_device_masked(a1, f1, j1, jnp.int32(n), k)
    o2 = P.st_decode_device_masked(a2, f2, int(j2), n, k)
    np.testing.assert_array_equal(o2.numpy(), np.asarray(o1))
    np.testing.assert_array_equal(o2.numpy()[:n], data[:n])
