"""The plain K3 (canonical Huffman chunk walk) vs tpulc.

tpulc's CPU decode never runs its Pallas walk (`_PALLAS_DECODE` is
False on the CPU); it takes the XLA LUT path
`huffman_decode_uniform_packed` with a per-chunk `lut_base`.  The port's
walk plus its symbol gather is held to that path's symbols over the
first m symbols of a real multi-table bz block.  A scalar numpy
reference pins the raw contract, the corrupt-stream guard included.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.bwt import driver as jdrv
from tpulc.codecs.huffman.decode import huffman_decode_uniform_packed
from tpulc.codecs.huffman.device_tables import canonical_lut_packed
from tpulc_torch.codecs.bwt.rle import ALPHABET
from tpulc_torch.codecs.huffman.decode_kernels import (
    huffman_walk,
    huffman_walk_plain,
)
from tpulc_torch.codecs.huffman.device_tables import canonical_decode_params

torch.set_num_threads(1)

L, CS = 15, 128


@partial(jax.jit, static_argnames=("cap",))
def _tpulc_symbols(words, total_bits, lengths, sel, offs, cap):
    luts = jax.vmap(lambda ln: canonical_lut_packed(ln, L))(lengths)
    return huffman_decode_uniform_packed(
        words, total_bits, cap, luts.reshape(-1), L, offs, CS,
        out_dtype=jnp.int32, lut_base=sel << L)


def test_walk_matches_tpulc_on_a_multitable_bz_block():
    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read(150000)
    cap = jdrv._cap_for(1 << 16)
    comp = jdrv.compress(data, block_size=1 << 16)
    from tpulc.pipeline.container import Container

    blocks = [jdrv._parse_block(p) for p in Container.from_bytes(comp).payloads]
    multi = [b for b in blocks if b[5] is not None]
    assert multi, "expected a multi-table block in pg1661"
    n, m, idx0, tb, lengths, sel, bit_offsets, anchors, words = multi[0]
    assert lengths.shape[0] >= 2
    ccap = cap // CS
    sel_p = np.zeros(ccap, np.int32)
    sel_p[: sel.shape[0]] = sel
    offs_p = np.full(ccap, tb, np.int32)
    offs_p[: bit_offsets.shape[0]] = bit_offsets

    want = np.asarray(_tpulc_symbols(
        jnp.asarray(words), jnp.int32(tb), jnp.asarray(lengths),
        jnp.asarray(sel_p), jnp.asarray(offs_p), cap))

    lim, base, ss = canonical_decode_params(torch.from_numpy(lengths), L)
    sel_t = torch.from_numpy(sel_p).long()
    ci = huffman_walk(torch.from_numpy(words.view(np.int32).copy())[None],
                      torch.tensor([tb], dtype=torch.int32),
                      torch.from_numpy(offs_p), lim, base,
                      sel_t.to(torch.int32), CS, L)
    flat = ci.reshape(-1)[:cap].clamp(0, ALPHABET - 1).long()
    ctx = torch.repeat_interleave(sel_t, CS)[:cap]
    got = ss.reshape(-1)[ctx * ALPHABET + flat].numpy()
    np.testing.assert_array_equal(got[:m], want[:m])


def _walk_ref(words, offs, total_bits, lim, base, cs, ln_max):
    """Scalar reference of K3's contract, one chunk and one bit at a time."""
    bits = np.unpackbits(words.astype(">u4").view(np.uint8))
    out = np.zeros((len(offs), cs), np.int64)
    for c, start in enumerate(offs):
        pos, end = int(start), min(total_bits, int(start) + cs * ln_max)
        for t in range(cs):
            win = 0
            for j in range(ln_max):
                win = (win << 1) | (int(bits[pos + j])
                                    if pos + j < len(bits) else 0)
            ln, ci = 1, 0
            for l in range(1, ln_max + 1):
                if (win >> (ln_max - l)) < lim[c, l]:
                    ln, ci = l, base[c, l] + (win >> (ln_max - l))
                    break
            if pos < end:
                out[c, t] = ci
                pos += ln
    return out


@pytest.mark.parametrize("corrupt", [False, True])
def test_walk_contract_and_corrupt_guard(corrupt):
    rng = np.random.default_rng(int(corrupt))
    nsub, cs = 12, 16
    words = rng.integers(0, 1 << 32, size=40, dtype=np.uint64).astype(np.uint32)
    total_bits = 40 * 32 - 21
    offs = np.sort(rng.integers(0, total_bits + 30, size=nsub)).astype(np.int32)
    lens = rng.integers(0, L + 1, size=(nsub, ALPHABET))
    lim, base, _ = (t.numpy() for t in canonical_decode_params(
        torch.from_numpy(lens), L))
    if corrupt:  # no length ever matches: every step is the 1-bit guard
        lim = np.zeros_like(lim)
    got = huffman_walk_plain(
        torch.from_numpy(words.view(np.int32))[None],
        torch.tensor([total_bits], dtype=torch.int32), torch.from_numpy(offs),
        torch.from_numpy(lim), torch.from_numpy(base),
        torch.arange(nsub, dtype=torch.int32), cs, L)
    want = _walk_ref(words, offs, total_bits, lim, base, cs, L)
    np.testing.assert_array_equal(got.numpy(), want)
    if corrupt:
        assert not got.numpy().any()


def test_walk_wrapper_checks_shapes():
    z = torch.zeros(4, dtype=torch.int32)
    w = torch.zeros((1, 4), dtype=torch.int32)
    tb = torch.zeros(1, dtype=torch.int32)
    tab = torch.zeros((4, L + 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        huffman_walk(w, tb, z, tab[:, :4].contiguous(), tab, z, CS, L)
    with pytest.raises(ValueError):
        huffman_walk(w, tb, z, tab, tab, z, 127, L)
    with pytest.raises(ValueError):
        huffman_walk(w.long(), tb, z, tab, tab, z, CS, L)
    with pytest.raises(ValueError):  # 4 chunks over 3 streams
        huffman_walk(torch.zeros((3, 4), dtype=torch.int32),
                     torch.zeros(3, dtype=torch.int32), z, tab, tab, z, CS, L)
