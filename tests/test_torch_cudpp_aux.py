"""The port's CUDPP auxiliary primitives (`primitives/cudpp_aux.py`:
MD5 rand, spmv, the tridiagonal solver, the cuckoo hash table) against
tpulc's (through JAX on the CPU) and hashlib: MD5 words and hash tables
bit-identical, spmv and the solver within rtol 1e-5."""

import hashlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.primitives import cudpp_aux as tpulc_aux
from tpulc_torch.primitives import cudpp_aux as aux

torch.set_num_threads(1)


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_md5_blocks_equal_hashlib_and_tpulc():
    """One-block messages of 0..55 bytes, padded as MD5 pads them."""
    rng = np.random.default_rng(0)
    msgs = [rng.integers(0, 256, n).astype(np.uint8).tobytes()
            for n in range(56)]
    m = np.zeros((len(msgs), 16), np.uint32)
    for i, msg in enumerate(msgs):
        block = msg + b"\x80" + bytes(55 - len(msg)) \
            + struct.pack("<Q", 8 * len(msg))
        m[i] = np.frombuffer(block, "<u4")
    got = aux.md5_blocks(torch.from_numpy(m.astype(np.int64))).numpy()
    np.testing.assert_array_equal(
        got, _u32(tpulc_aux.md5_blocks(jnp.asarray(m))))
    for i, msg in enumerate(msgs):
        want = np.frombuffer(hashlib.md5(msg).digest(), "<u4")
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("n", [1, 4, 1001])
@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_md5_rand_equals_tpulc(n, seed):
    got = aux.md5_rand(n, seed, device="cpu")
    assert got.shape == (n,) and got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), _u32(tpulc_aux.md5_rand(n, jnp.uint32(seed))))
    blk = (n - 1) // 4
    want = np.frombuffer(hashlib.md5(struct.pack("<II", seed, blk)).digest(),
                         "<u4")[: n - 4 * blk]
    np.testing.assert_array_equal(got.numpy()[4 * blk:], want)


def test_spmv_matches_tpulc():
    """A seeded CSR with empty rows, among them the first and the last."""
    rng = np.random.default_rng(1)
    nrows, ncols = 300, 200
    dense = np.where(rng.random((nrows, ncols)) < 0.05,
                     rng.standard_normal((nrows, ncols)), 0.0)
    dense[[0, 17, 18, nrows - 1]] = 0.0
    x = rng.standard_normal(ncols).astype(np.float32)
    rows, cols = np.nonzero(dense)
    values = dense[rows, cols].astype(np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=nrows))]).astype(np.int32)
    want = np.asarray(tpulc_aux.spmv(
        jnp.asarray(values), jnp.asarray(cols.astype(np.int32)),
        jnp.asarray(row_ptr), jnp.asarray(x)))
    got = aux.spmv(torch.from_numpy(values),
                   torch.from_numpy(cols.astype(np.int32)),
                   torch.from_numpy(row_ptr), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[[0, 17, 18, nrows - 1]].any()


@pytest.mark.parametrize("n", [8, 64, 256])
def test_tridiagonal_solve_matches_tpulc(n):
    rng = np.random.default_rng(n)
    B = 5
    a = rng.standard_normal((B, n)) * 0.3
    c = rng.standard_normal((B, n)) * 0.3
    b = 2.0 + np.abs(rng.standard_normal((B, n)))  # diagonally dominant
    d = rng.standard_normal((B, n))
    args = [z.astype(np.float32) for z in (a, b, c, d)]
    want = np.asarray(tpulc_aux.tridiagonal_solve(
        *(jnp.asarray(z) for z in args)))
    got = aux.tridiagonal_solve(*(torch.from_numpy(z) for z in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _table_equals_tpulc(keys, vals, **kw):
    want = tpulc_aux.CuckooTable(keys, vals, **kw)
    got = aux.CuckooTable(keys, vals, device="cpu", **kw)
    for name in ("tk", "tv", "stash_k", "stash_v"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _u32(getattr(want, name)), name)
    return want, got


def test_cuckoo_table_equals_tpulc():
    rng = np.random.default_rng(3)
    n = 20_000
    keys = rng.choice(1 << 30, size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want, got = _table_equals_tpulc(keys, vals)
    assert got.stash_k.shape[0] > 1  # the stash is exercised
    absent = (keys[:3000].astype(np.uint64) + (1 << 31)).astype(np.uint32)
    query = np.concatenate([keys, absent])
    rng.shuffle(query)
    wv, wf = want.lookup(jnp.asarray(query))
    gv, gf = got.lookup(query)
    np.testing.assert_array_equal(gv.numpy(), _u32(wv))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    assert gf.sum() == n
    pos = {int(k): i for i, k in enumerate(keys)}
    hit = gf.numpy()
    np.testing.assert_array_equal(
        gv.numpy()[hit], vals[[pos[int(k)] for k in query[hit]]])


def test_cuckoo_one_winner_a_slot():
    """Keys 12, 43, 47 and 68 all take slot 3 of a 12-slot table in the
    first round: the last of them (tpulc's last writer) wins, and every
    slot holds one key's key and that key's value."""
    keys = np.array([12, 1, 43, 2, 47, 3, 68, 4], np.uint32)
    vals = np.arange(100, 108, dtype=np.uint32)
    assert {int(aux._h(torch.tensor(k), aux.CuckooTable.SEEDS[0], 12))
            for k in (12, 43, 47, 68)} == {3}
    _, got = _table_equals_tpulc(keys, vals)
    assert got.size == 12
    tk, tv = got.tk.numpy(), got.tv.numpy()
    assert tk[3] == 68 and tv[3] == 106
    val_of = dict(zip(keys.tolist(), vals.tolist()))
    for k, v in zip(tk, tv):
        if k != 0xFFFFFFFF:
            assert val_of[int(k)] == v
    gv, gf = got.lookup(keys)
    assert gf.all() and np.array_equal(gv.numpy(), vals)
