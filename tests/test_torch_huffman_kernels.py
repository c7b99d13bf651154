"""The plain versions of the huffman codec's walks — K3 (unpacked and
packed), K7 and K8 — against scalar references of their contracts, and
the port's batched decoders against tpulc's on real containers.

On valid streams K3's first-hit chain, K8's monotone count and the ranks
decoder's threshold count give the same symbols; on corrupt tables they
differ, so each is held to its own contract there ("guard": no length
ever matches; "junk": random, non-nested limits).  tpulc's K8 runs in
Pallas interpret mode at chunk_syms=8, the size at which it finishes in
seconds on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.huffman import driver as jdrv
from tpulc.codecs.huffman.decode import huffman_decode_flat_batch as jflat
from tpulc_torch.codecs.huffman import decode as hdec
from tpulc_torch.codecs.huffman import decode_kernels as dk
from tpulc_torch.codecs.huffman import driver
from tpulc_torch.codecs.huffman.device_tables import canonical_decode_params

torch.set_num_threads(1)

L = 12
B, CCAP, CS, W = 2, 128, 16, 80   # nsub = 256 chunks, two K8 tiles


def _bits(words):
    """uint32 [B, W] -> per-stream bit arrays (MSB first)."""
    return [np.unpackbits(w.astype(">u4").view(np.uint8)) for w in words]


def _window(bits, pos):
    win = 0
    for j in range(L):
        win = (win << 1) | (int(bits[pos + j]) if pos + j < len(bits) else 0)
    return win


def _inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64).astype(
        np.uint32)
    tbits = np.array([W * 32 - 19, W * 32 - 600], np.int32)
    nsub = B * CCAP
    offs = np.sort(rng.integers(0, W * 32 + 40, size=nsub)).astype(np.int32)
    offs[5] = tbits[0]                     # an empty chunk
    T = 3
    lens = rng.integers(0, L + 1, size=(T, 256))
    lim, base, _ = (t.numpy() for t in canonical_decode_params(
        torch.from_numpy(lens), L))
    if kind == "guard":
        lim = np.zeros_like(lim)
    elif kind == "junk":
        lim = rng.integers(0, 1 << 11, size=lim.shape).astype(np.int32)
        base = rng.integers(-50, 300, size=base.shape).astype(np.int32)
    tab = rng.integers(0, T, size=nsub).astype(np.int32)
    return words, tbits, offs, lim, base, tab


def _walk_ref(words, tbits, offs, lim, base, tab):
    """Scalar K3/K7 contract: first-hit chain, ln = 1 guard, end =
    min(tbits, offs + CS*L), 0 at or past end."""
    bits = _bits(words)
    out = np.zeros((len(offs), CS), np.int64)
    for c, start in enumerate(offs):
        b, t = c // CCAP, tab[c]
        pos = int(start)
        end = min(int(tbits[b]), pos + CS * L)
        for s in range(CS):
            win = _window(bits[b], pos)
            ln, ci = 1, 0
            for l in range(1, L + 1):
                if (win >> (L - l)) < lim[t, l]:
                    ln, ci = l, base[t, l] + (win >> (L - l))
                    break
            if pos < end:
                out[c, s] = ci
                pos += ln
    return out


def _flat_ref(words, offs, left, lj, base):
    """Scalar K8 contract: monotone count over left-justified limits,
    valid iff win < lj[L], emit while bits_left > 0."""
    bits = _bits(words)
    out = np.zeros((len(offs), CS), np.int64)
    for c, start in enumerate(offs):
        b, t = c // CCAP, c // dk.TILE
        pos, bl = int(start), int(left[c])
        for s in range(CS):
            win = _window(bits[b], pos)
            ln = 1 + sum(win >= lj[t, l] for l in range(1, L))
            found = win < lj[t, L]
            if not found:
                ln = 1
            ci = base[t, ln] + (win >> (L - ln)) if found else 0
            if bl > 0:
                out[c, s] = ci
                bl -= ln
                pos += ln
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            if a.dtype == np.uint32 else torch.from_numpy(a) for a in arrays]


def _pack_ref(ci):
    return np.clip(ci, 0, 255).astype(np.uint8).reshape(len(ci), -1, 4)


@pytest.mark.parametrize("kind", ["valid", "guard", "junk"])
def test_k3_and_k7_plain_match_the_contract(kind):
    words, tbits, offs, lim, base, tab = _inputs(kind)
    want = _walk_ref(words, tbits, offs, lim, base, tab)
    args = _t(words, tbits, offs, lim, base, tab) + [CS, L]
    np.testing.assert_array_equal(dk.huffman_walk(*args).numpy(), want)
    np.testing.assert_array_equal(dk.huffman_walk_v1(*args).numpy(), want)
    packed = dk.huffman_walk(*args, packed=True).numpy()
    assert packed.shape == (B * CCAP, CS // 4)
    # byte k of word q is symbol 4q+k: a little-endian uint8 view
    np.testing.assert_array_equal(packed.view(np.uint8).reshape(-1, CS // 4, 4),
                                  _pack_ref(want))
    if kind == "guard":
        assert not want.any()


@pytest.mark.parametrize("kind", ["valid", "guard", "junk"])
def test_k8_plain_matches_the_contract(kind):
    words, tbits, offs, lim, base, _ = _inputs(kind, seed=1)
    T = B * CCAP // dk.TILE
    lj = (lim[:T].astype(np.int64) << (L - np.arange(L + 1))).astype(np.int32)
    if kind == "junk":
        lj = np.random.default_rng(9).integers(
            0, 1 << L, size=lj.shape).astype(np.int32)
    left = np.minimum(tbits[np.arange(B * CCAP) // CCAP] - offs,
                      CS * L).astype(np.int32)
    want = _flat_ref(words, offs, left, lj, base[:T])
    got = dk.huffman_walk_flat(*_t(words, offs, left, lj,
                                   np.ascontiguousarray(base[:T])), CS, L)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint8).reshape(-1, CS // 4, 4), _pack_ref(want))


def test_packed_k3_is_the_packed_unpacked_k3():
    args = _t(*_inputs("valid", seed=2)) + [CS, L]
    unpacked = dk.huffman_walk_plain(*args)
    packed = dk.huffman_walk_plain(*args, packed=True)
    assert torch.equal(packed, dk.pack_ranks(unpacked))
    assert torch.equal(packed.view(torch.uint8).long(),
                       unpacked.clamp(0, 255).long())


def test_wrappers_check_their_inputs():
    words, tbits, offs, lim, base, tab = _t(*_inputs("valid"))
    with pytest.raises(ValueError, match="multiple of 4"):
        dk.huffman_walk(words, tbits, offs, lim, base, tab, 18, L, packed=True)
    with pytest.raises(ValueError, match="tbits"):
        dk.huffman_walk_v1(words, tbits[:1], offs, lim, base, tab, CS, L)
    left = torch.zeros(offs.shape[0] - 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        dk.huffman_walk_flat(words, offs[:-128], left, lim[:1], base[:1],
                             CS, L)


def _tpulc_group(data, **kw):
    """tpulc container -> its parsed batch arrays (numpy) and ranks-path
    symbols (the XLA decoder tpulc runs on the CPU)."""
    comp = jdrv.compress(data, **kw)
    from tpulc.pipeline.container import Container

    c = Container.from_bytes(comp)
    prep = jdrv._parse_aligned_group(c.payloads, c.block_size, L)
    words, tbits, lens, offs, ns, chunk = prep
    want = np.asarray(jdrv._decode_batch_ranks(
        jnp.asarray(words), jnp.asarray(tbits), jnp.asarray(lens),
        jnp.asarray(offs), chunk, L))
    return (words, tbits, lens, offs, chunk), want


@pytest.mark.parametrize("chunk_syms", [128, 256])
def test_batched_decoders_equal_tpulc_ranks(chunk_syms):
    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read(150000)
    (words, tbits, lens, offs, chunk), want = _tpulc_group(
        data, block_size=1 << 16, chunk_syms=chunk_syms)
    args = _t(words, tbits, lens, offs)
    for fn in (hdec.huffman_decode_ranks_batch,
               hdec.huffman_decode_pallas_batch,
               hdec.huffman_decode_buffered_batch,
               hdec.huffman_decode_flat_batch):
        got = fn(*args, chunk, L)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)
    np.testing.assert_array_equal(
        driver.decode_batch_device(*args, chunk, L).numpy(), want)


def test_flat_path_equals_tpulc_interpret_k8():
    """tpulc's `huffman_decode_flat_batch` runs its Pallas K8 in
    interpret mode; the port's flat path (plain K8) must give the same
    symbols on 3 blocks of 8 KB at chunk_syms=8."""
    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read(3 * 8192)
    (words, tbits, lens, offs, chunk), _ = _tpulc_group(
        data, block_size=8192, chunk_syms=8)
    assert chunk == 8
    want = np.asarray(jflat(
        jnp.asarray(words), jnp.asarray(tbits), jnp.asarray(lens),
        jnp.asarray(offs), chunk, L, jdrv.flat_row_words(chunk, L),
        interpret=True))
    got = hdec.huffman_decode_flat_batch(*_t(words, tbits, lens, offs),
                                         chunk, L)
    np.testing.assert_array_equal(got.numpy(), want)
