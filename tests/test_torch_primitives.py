"""The port's primitive layer (`primitives/{parallel,suffix,dc3,
dc3_device,histogram}.py`) against tpulc's (through JAX on the CPU) on
the same seeded numpy inputs: integer results bit-identical, float
scans within rtol 1e-5, atol 1e-6 (the two summation trees differ);
`checksum.adler32_np` against zlib, read in place."""

import tracemalloc
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpulc.codecs.bwt.rotsort import bwt_encode_np
from tpulc.primitives import dc3 as tpulc_dc3
from tpulc.primitives import histogram as tpulc_hist
from tpulc.primitives import parallel as tpar
from tpulc.primitives import suffix as tpulc_suffix
from tpulc.primitives.dc3_device import suffix_array_dc3 as tpulc_sa_dc3
from tpulc_torch.primitives import dc3, histogram
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.primitives import parallel as par
from tpulc_torch.primitives.dc3_device import suffix_array_dc3
from tpulc_torch.primitives.suffix import (
    sa_to_bwt,
    suffix_array,
    suffix_array_np,
)

torch.set_num_threads(1)

OPS = {"add": (jnp.add, torch.add), "max": (jnp.maximum, torch.maximum),
       "min": (jnp.minimum, torch.minimum),
       "or": (jnp.bitwise_or, torch.bitwise_or)}


def _pg(n=None):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _same(want, got):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_integer_scans_equal_tpulc(op, exclusive, reverse):
    rng = np.random.default_rng(1)
    x1 = rng.integers(-1000, 1000, 257).astype(np.int32)
    x2 = rng.integers(-1000, 1000, (5, 33)).astype(np.int32)
    jop, top = OPS[op]
    for fn, tfn, x in ((par.scan, tpar.scan, x1),
                       (par.multi_scan, tpar.multi_scan, x2)):
        jx, tx = _both(x)
        if op == "or" and exclusive:  # tpulc has no identity for it
            with pytest.raises(ValueError):
                tfn(jx, op=jop, exclusive=True, reverse=reverse)
            with pytest.raises(ValueError):
                fn(tx, op=top, exclusive=True, reverse=reverse)
            continue
        want = tfn(jx, op=jop, exclusive=exclusive, reverse=reverse)
        got = fn(tx, op=top, exclusive=exclusive, reverse=reverse)
        assert got.dtype == torch.int32
        _same(want, got)
    with pytest.raises(ValueError):
        par.multi_scan(torch.from_numpy(x1))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("reverse", [False, True])
def test_exclusive_scan_of_an_empty_axis_is_empty(op, reverse):
    """An exclusive scan of n elements has n outputs: `scan` of length 0
    and `multi_scan` of [R, 0] give empty tensors of x's shape.  tpulc
    returns [identity] here, shape (1,) and (2, 1) (its fault F10), which
    the port does not follow; an op without an identity still raises."""
    jop, top = OPS[op]
    for fn, tfn, shape in ((par.scan, tpar.scan, (0,)),
                           (par.multi_scan, tpar.multi_scan, (2, 0))):
        x = np.zeros(shape, np.int32)
        jx, tx = _both(x)
        if op == "or":
            with pytest.raises(ValueError):
                fn(tx, op=top, exclusive=True, reverse=reverse)
            continue
        got = fn(tx, op=top, exclusive=True, reverse=reverse)
        assert got.shape == shape and got.dtype == torch.int32
        f10 = tfn(jx, op=jop, exclusive=True, reverse=reverse)
        assert f10.shape == shape[:-1] + (1,)   # the reference fault
        for exclusive in (False, True):
            y = fn(torch.zeros(shape, dtype=torch.float32), op=top,
                   exclusive=exclusive, reverse=reverse)
            assert y.shape == shape and y.dtype == torch.float32
        _same(tfn(jx, op=jop, reverse=reverse),
              fn(tx, op=top, reverse=reverse))


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_float_scans_close_to_tpulc(op, exclusive, reverse):
    """Inputs in [0, 1): no partial sum cancels, so the relative
    tolerance bounds the two summation orders' rounding."""
    rng = np.random.default_rng(2)
    jop, top = OPS[op]
    for fn, tfn, shape in ((par.scan, tpar.scan, (1000,)),
                           (par.multi_scan, tpar.multi_scan, (4, 300))):
        x = rng.random(shape).astype(np.float32)
        jx, tx = _both(x)
        np.testing.assert_allclose(
            fn(tx, op=top, exclusive=exclusive, reverse=reverse).numpy(),
            np.asarray(tfn(jx, op=jop, exclusive=exclusive, reverse=reverse)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["add", "max", "min", "or"])
def test_segmented_scan_equals_tpulc(op):
    rng = np.random.default_rng(3)
    jop, top = OPS[op]
    for n in (1, 7, 1000):
        x = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
        f = (rng.random(n) < 0.1).astype(np.int32)
        _same(tpar.segmented_scan(jnp.asarray(x), jnp.asarray(f), op=jop),
              par.segmented_scan(torch.from_numpy(x), torch.from_numpy(f),
                                 op=top))
    x = rng.random(1000).astype(np.float32)
    f = rng.random(1000) < 0.1
    np.testing.assert_allclose(
        par.segmented_scan(torch.from_numpy(x), torch.from_numpy(f)).numpy(),
        np.asarray(tpar.segmented_scan(jnp.asarray(x), jnp.asarray(f))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mask", ["random", "empty", "full"])
def test_compact_equals_tpulc(mask):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 20, 500).astype(np.int32)
    m = {"random": rng.random(500) < 0.3, "empty": np.zeros(500, bool),
         "full": np.ones(500, bool)}[mask]
    want, wcnt = tpar.compact(jnp.asarray(x), jnp.asarray(m), fill=-7)
    got, cnt = par.compact(torch.from_numpy(x), torch.from_numpy(m), fill=-7)
    _same(want, got)
    assert int(cnt) == int(wcnt)


def test_reduce_sorts_and_merge_equal_tpulc():
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 30), 1 << 30, 1001).astype(np.int32)
    jx, tx = _both(x)
    for op in ("add", "max", "min"):
        jop, top = OPS[op]
        assert int(par.reduce(tx, op=top)) == int(tpar.reduce(jx, op=jop))
    with pytest.raises(ValueError):
        tpar.reduce(jx, op=jnp.bitwise_or)
    with pytest.raises(ValueError):
        par.reduce(tx, op=torch.bitwise_or)
    keys = rng.integers(0, 50, 2000).astype(np.int32)  # many ties
    vals = np.arange(2000, dtype=np.int32)
    for fn, tfn in ((par.sort_pairs, tpar.sort_pairs),
                    (par.sort_strings, tpar.sort_strings)):
        wk, wv = tfn(jnp.asarray(keys), jnp.asarray(vals))
        gk, gv = fn(torch.from_numpy(keys), torch.from_numpy(vals))
        _same(wk, gk)
        _same(wv, gv)
    a = np.sort(rng.integers(0, 1000, 300)).astype(np.int32)
    b = np.sort(rng.integers(0, 1000, 77)).astype(np.int32)
    _same(tpar.merge_sorted(jnp.asarray(a), jnp.asarray(b)),
          par.merge_sorted(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("lo,hi", [(0, 8), (-11, 13)])
def test_multisplit_equals_tpulc(lo, hi):
    """Out-of-range ids: tpulc's dropped scatter counts an id in
    [-8, 0) in bucket 8 + id and drops the rest; values sort by the
    raw id."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, 1 << 16, 3000).astype(np.int32)
    b = rng.integers(lo, hi, 3000).astype(np.int32)
    wv, ws = tpar.multisplit(jnp.asarray(x), jnp.asarray(b), 8)
    gv, gs = par.multisplit(torch.from_numpy(x), torch.from_numpy(b), 8)
    _same(wv, gv)
    _same(ws, gs)


@pytest.mark.parametrize("n", [1, 2, 5000])
def test_listrank_equals_tpulc(n):
    rng = np.random.default_rng(n)
    order = rng.permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[order] = np.roll(order, -1)
    head = int(order[0])
    want = tpar.listrank(jnp.asarray(nxt), jnp.int32(head))
    got = par.listrank(torch.from_numpy(nxt), head)
    _same(want, got)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    _same(rank, got)


def test_sort_strings_full_equals_tpulc():
    lines = _pg().split(b"\n")[:2000]
    packed = np.frombuffer(b"\0".join(lines) + b"\0", np.uint8)
    starts = np.cumsum([0] + [len(w) + 1 for w in lines[:-1]]).astype(np.int32)
    want = tpar.sort_strings_full(jnp.asarray(packed), jnp.asarray(starts))
    got = par.sort_strings_full(torch.from_numpy(packed.copy()),
                                torch.from_numpy(starts))
    _same(want, got)
    assert [lines[i] for i in got.tolist()] == sorted(lines)


SA_CASES = {
    **{s.decode(): s for s in (b"banana", b"mississippi", b"aaaa", b"abcabc",
                               b"x")},
    **{f"random{n}": np.random.default_rng(n).integers(
        0, 256, n).astype(np.uint8).tobytes() for n in (4, 5, 6)},
    "a2000": b"a" * 2000,
    "random3000": np.random.default_rng(7).integers(
        0, 256, 3000).astype(np.uint8).tobytes(),
    "alpha3": np.random.default_rng(8).integers(
        0, 3, 2000).astype(np.uint8).tobytes(),
    "pg50000": _pg(50_000),
}


@pytest.mark.parametrize("name", SA_CASES)
def test_suffix_arrays_equal_tpulc(name):
    data = np.frombuffer(SA_CASES[name], np.uint8)
    jd, td = jnp.asarray(data), torch.from_numpy(data.copy())
    want = np.asarray(tpulc_suffix.suffix_array(jd))
    _same(want, suffix_array(td))
    _same(want, dc3.dc3_suffix_array(data))
    _same(tpulc_dc3.dc3_suffix_array(data), dc3.dc3_suffix_array(data))
    if len(data) <= 3000:
        _same(suffix_array_np(data), want)
        _same(tpulc_suffix.suffix_array_np(data), suffix_array_np(data))
    if len(data) < 4:
        with pytest.raises(ValueError):
            suffix_array_dc3(td)
        return
    _same(tpulc_sa_dc3(jd), suffix_array_dc3(td))


@pytest.mark.parametrize("n", [4, 5, 6, 7, 9, 1000, 1001, 1002])
def test_suffix_array_dc3_every_residue(n):
    """n % 3 == 0, 1, 2 (the dummy sample exists only at 1), binary and
    byte alphabets, against the naive gold."""
    rng = np.random.default_rng(n)
    for alpha in (2, 256):
        data = rng.integers(0, alpha, n).astype(np.uint8)
        _same(suffix_array_np(data), suffix_array_dc3(torch.from_numpy(data)))


@pytest.mark.parametrize("s", [b"banana\x00", b"mississippi\x00",
                               b"the cat sat on the mat\x00"])
def test_sa_to_bwt_equals_rotation_bwt(s):
    """With a unique smallest sentinel, suffix order is rotation order."""
    data = np.frombuffer(s, np.uint8)
    td = torch.from_numpy(data.copy())
    bwt, idx0 = sa_to_bwt(td, suffix_array(td))
    want, want_idx = bwt_encode_np(data)
    _same(want, bwt)
    assert int(idx0) == want_idx
    wb, wi = tpulc_suffix.sa_to_bwt(jnp.asarray(data),
                                    tpulc_suffix.suffix_array(
                                        jnp.asarray(data)))
    _same(wb, bwt)
    assert int(wi) == int(idx0)


@pytest.mark.parametrize("bins", [256, 100])
def test_histograms_equal_tpulc(bins):
    rng = np.random.default_rng(9)
    data = np.frombuffer(_pg(30_000), np.uint8)
    blocks = rng.integers(0, 256, (6, 1000)).astype(np.uint8)
    _same(tpulc_hist.byte_histogram(jnp.asarray(data), bins),
          histogram.byte_histogram(torch.from_numpy(data.copy()), bins))
    _same(tpulc_hist.batched_byte_histogram(jnp.asarray(blocks), bins),
          histogram.batched_byte_histogram(torch.from_numpy(blocks), bins))


def _adler_input(kind):
    """-> (the argument, the bytes it holds, the start value)."""
    raw = _pg(70000)
    arr = np.frombuffer(raw, np.uint8)
    words = arr[:69996].view("<u4").reshape(-1, 3)
    return {
        "bytes": (raw, raw, 1),
        "bytearray": (bytearray(raw), raw, 1),
        "memoryview": (memoryview(raw)[5:60005], raw[5:60005], 1),
        "ndarray": (words, raw[:69996], 1),
        "strided": (words[::3, 1:], words[::3, 1:].tobytes(), 1),
        "value": (arr, raw, zlib.adler32(b"running")),
    }[kind]


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview",
                                  "ndarray", "strided", "value"])
def test_adler32_equals_zlib(kind):
    data, raw, value = _adler_input(kind)
    assert adler32_np(data, value) == zlib.adler32(raw, value) & 0xFFFFFFFF


def test_adler32_reads_a_contiguous_array_in_place():
    arr = np.resize(np.frombuffer(_pg(), np.uint8), 1 << 20)
    tracemalloc.start()
    try:
        adler32_np(arr)
        adler32_np(arr.view("<u4").reshape(64, -1))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < arr.nbytes // 16
