"""The running max / min scans (`tpulc_torch.primitives.scan_kernels`):
the plain versions, which the wrappers run on CPU tensors, against
`jax.lax.associative_scan(jnp.maximum / jnp.minimum, x, reverse=...)`
(tpulc's form of these scans) on the same seeded numpy inputs,
bit-identical.  The CUDA kernel is held against the plain version in
`test_torch_cuda_kernels.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc_torch.primitives import scan_kernels as sk

torch.set_num_threads(1)

SIZES = [1, 2, 4095, 4096, 4097, 65537]
OPS = {"max": (jnp.maximum, sk.running_max, sk.running_max_plain),
       "min": (jnp.minimum, sk.running_min, sk.running_min_plain)}


def _tpulc(op, x: np.ndarray, reverse: bool) -> np.ndarray:
    with jax.enable_x64(x.dtype == np.int64):
        return np.asarray(jax.lax.associative_scan(
            OPS[op][0], jnp.asarray(x), reverse=reverse))


def _input(kind: str, n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(n * 7 + len(kind))
    wide = 1 << 40 if dtype == np.int64 else 1 << 30
    if kind == "random":
        x = rng.integers(-wide, wide, n)
    elif kind == "sentinels":   # rle.py's -1 / n + 1 and rotsort's 1 << 30
        x = rng.choice(np.array([-1, n + 1, 1 << 30, 3, n // 2]), n)
    elif kind == "runs":        # long equal runs, as after a BWT
        x = np.repeat(rng.integers(-9, 9, -(-n // 300)), 300)[:n]
    else:
        raise KeyError(kind)
    return x.astype(dtype)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_equals_tpulc(n, op, dtype, reverse):
    _, wrapper, plain = OPS[op]
    for kind in ("random", "sentinels", "runs"):
        x = _input(kind, n, dtype)
        want = _tpulc(op, x, reverse)
        t = torch.from_numpy(x)
        got = plain(t, reverse)
        assert got.dtype == t.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(wrapper(t, reverse).numpy(), want)


@pytest.mark.parametrize("op", OPS)
def test_extremes_and_monotone_inputs(op):
    """The dtype's extremes (the kernel's identities) and strictly
    monotone inputs scan like any other value."""
    for dtype in (np.int32, np.int64):
        info = np.iinfo(dtype)
        x = np.array([info.max, 0, info.min, 5, info.min, info.max, -3],
                     dtype)
        for reverse in (False, True):
            for v in (x, np.arange(5000, dtype=dtype),
                      -np.arange(5000, dtype=dtype)):
                np.testing.assert_array_equal(
                    OPS[op][2](torch.from_numpy(v), reverse).numpy(),
                    _tpulc(op, v, reverse))


@pytest.mark.parametrize("op", OPS)
def test_empty_and_refused_inputs_on_the_cpu(op):
    """n = 0 gives an empty result of x's dtype; a CPU call launches
    nothing; other dtypes and ranks are refused."""
    _, wrapper, _ = OPS[op]
    before = wrapper.launches
    for dtype in (torch.int32, torch.int64):
        for reverse in (False, True):
            y = wrapper(torch.empty(0, dtype=dtype), reverse)
            assert y.shape == (0,) and y.dtype == dtype
    assert wrapper(torch.tensor([3, 1, 2]), True).tolist() == (
        [3, 2, 2] if op == "max" else [1, 1, 2])
    assert wrapper.launches == before
    for bad in (torch.zeros(4, dtype=torch.float32),
                torch.zeros(4, dtype=torch.uint8),
                torch.zeros((2, 3), dtype=torch.int64)):
        with pytest.raises(ValueError):
            wrapper(bad)
