"""CUHD interop and the self-synchronising decoder of tpulc_torch against
tpulc's: llhuff unit streams, `cuhd_decode`, `huffman_encode` and
`huffman_decode` at the subsequence sizes tpulc's tests use."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.huffman import cuhd_compat as jcuhd
from tpulc.codecs.huffman import huffman_decode as jdecode
from tpulc.codecs.huffman import huffman_encode as jencode
from tpulc_torch.codecs.huffman import (
    HuffmanTable,
    cuhd_compat,
    huffman_decode,
    huffman_encode,
)
from tpulc_torch.codecs.huffman.decode import (
    huffman_decode_aligned,
    huffman_decode_uniform,
)

torch.set_num_threads(1)


def _data(n, seed, skew):
    rng = np.random.default_rng(seed)
    if skew:
        p = rng.dirichlet(np.full(256, 0.05))
        return rng.choice(256, size=n, p=p).astype(np.uint8)
    return rng.integers(0, 256, size=n).astype(np.uint8)


def _encoded(data):
    table = HuffmanTable.from_freqs(np.bincount(data, minlength=256), 12)
    out_words = len(data) * 12 // 32 + 2
    words, total = huffman_encode(torch.from_numpy(data),
                                  torch.from_numpy(table.codes.astype(np.int64)),
                                  torch.from_numpy(table.lengths), out_words)
    jw, jt = jencode(jnp.asarray(data), jnp.asarray(table.codes),
                     jnp.asarray(table.lengths), out_words)
    assert int(total) == int(jt)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw).astype(np.int64))
    return table, words, int(total)


@pytest.mark.parametrize("skew,sub_bits", [(False, 128), (True, 512)])
def test_selfsync_decode_matches_tpulc(skew, sub_bits):
    data = _data(6000, 10, skew)
    table, words, total = _encoded(data)
    n_out = len(data) + 64
    out, n_valid = huffman_decode(words, total, n_out,
                                  torch.from_numpy(table.lut_sym.astype(np.int64)),
                                  torch.from_numpy(table.lut_len.astype(np.int64)),
                                  12, sub_bits=sub_bits)
    jout, jn = jdecode(jnp.asarray(words.numpy().astype(np.uint32)),
                       jnp.int32(total), n_out, jnp.asarray(table.lut_sym),
                       jnp.asarray(table.lut_len), 12, sub_bits=sub_bits)
    assert n_valid == int(jn) == len(data)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy()[: len(data)], data)


def test_aligned_and_uniform_decode():
    data = _data(3000, 4, True)
    table, words, total = _encoded(data)
    lens = table.lengths[data].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
    cs = 256
    offs = torch.from_numpy(starts[::cs].copy())
    lut = (torch.from_numpy(table.lut_sym.astype(np.int64)),
           torch.from_numpy(table.lut_len.astype(np.int64)))
    got = huffman_decode_uniform(words, total, len(data), *lut, 12, offs, cs)
    np.testing.assert_array_equal(got.numpy(), data)
    sym_offs = torch.arange(offs.shape[0]) * cs
    got = huffman_decode_aligned(words, total, len(data), *lut, 12, offs,
                                 sym_offs)
    np.testing.assert_array_equal(got.numpy(), data)


def test_llhuff_stream_and_decode_match_tpulc():
    rng = np.random.default_rng(7)
    data = np.clip(rng.binomial(255, 0.5, size=6000), 0, 255).astype(np.uint8)
    stream, lengths = cuhd_compat.llhuff_encode(data, device="cpu")
    jstream, jlengths = jcuhd.llhuff_encode(data)
    assert stream == jstream and lengths == jlengths
    out = cuhd_compat.cuhd_decode(stream, lengths, len(data), device="cpu")
    np.testing.assert_array_equal(out, jcuhd.cuhd_decode(jstream, jlengths,
                                                         len(data)))
    np.testing.assert_array_equal(out, data)


def test_single_symbol_and_table_sidecar(tmp_path):
    data = np.full(100, 65, np.uint8)
    stream, lengths = cuhd_compat.llhuff_encode(data, device="cpu")
    assert lengths == {65: 1}
    assert stream == bytes(16)  # 100 one-bit zero codes -> 13 bytes -> 4 units
    p = str(tmp_path / "tab.bin")
    cuhd_compat.save_table(lengths, p)
    assert cuhd_compat.load_table(p) == lengths
    out = cuhd_compat.cuhd_decode(stream, cuhd_compat.load_table(p), 100,
                                  device="cpu")
    np.testing.assert_array_equal(out, data)
