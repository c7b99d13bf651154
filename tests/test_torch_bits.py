"""tpulc_torch `pack_bits` and `peek_bits` vs tpulc's: bit-identical
words, counts and windows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.primitives.bits import pack_bits as jax_pack_bits
from tpulc.primitives.bits import peek_bits as jax_peek_bits
from tpulc_torch.primitives.bits import pack_bits, peek_bits

torch.set_num_threads(1)


def _codes(rng, lengths):
    return np.array(
        [rng.integers(0, 1 << int(l), dtype=np.uint64) if l else 0
         for l in lengths], np.uint32)


@pytest.mark.parametrize("max_len", [1, 13, 16, 32])
def test_pack_bits_matches_tpulc(max_len):
    rng = np.random.default_rng(max_len)
    lengths = rng.integers(0, max_len + 1, size=1000).astype(np.int32)
    lengths[:3] = [0, max_len, 0]
    codes = _codes(rng, lengths)
    out_words = -(-int(lengths.sum()) // 32) + 3
    want_w, want_t = jax_pack_bits(jnp.asarray(codes), jnp.asarray(lengths),
                                   out_words)
    got_w, got_t = pack_bits(torch.from_numpy(codes.astype(np.int64)),
                             torch.from_numpy(lengths), out_words)
    assert int(got_t) == int(want_t)
    np.testing.assert_array_equal(got_w.numpy().astype(np.uint32),
                                  np.asarray(want_w))


def test_pack_bits_exact_fill_and_empty():
    # 32-bit codes filling out_words exactly, then the empty input
    rng = np.random.default_rng(7)
    lengths = np.full(8, 32, np.int32)
    codes = rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(np.uint32)
    want_w, want_t = jax_pack_bits(jnp.asarray(codes), jnp.asarray(lengths), 8)
    got_w, got_t = pack_bits(torch.from_numpy(codes.astype(np.int64)),
                             torch.from_numpy(lengths), 8)
    assert int(got_t) == int(want_t) == 256
    np.testing.assert_array_equal(got_w.numpy().astype(np.uint32),
                                  np.asarray(want_w))
    w0, t0 = pack_bits(torch.zeros(0, dtype=torch.int64),
                       torch.zeros(0, dtype=torch.int32), 4)
    assert int(t0) == 0 and w0.tolist() == [0, 0, 0, 0]


def test_pack_bits_batched_rows_equal_one_at_a_time():
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 13, size=(3, 500))
    codes = (rng.integers(0, 1 << 12, size=(3, 500)) & ((1 << lengths) - 1))
    words, tb = pack_bits(torch.from_numpy(codes), torch.from_numpy(lengths),
                          200)
    for j in range(3):
        w1, t1 = pack_bits(torch.from_numpy(codes[j]),
                           torch.from_numpy(lengths[j]), 200)
        assert torch.equal(words[j], w1) and int(tb[j]) == int(t1)


@pytest.mark.parametrize("width", [1, 12, 25, 32])
def test_peek_bits_matches_tpulc(width):
    """Windows anywhere in the stream, the last bits included; tpulc pads
    its stream with zero words, the port reads zeros past the end."""
    rng = np.random.default_rng(width)
    words = rng.integers(0, 1 << 32, size=20, dtype=np.uint64).astype(np.uint32)
    pos = np.arange(0, 20 * 32, 7, dtype=np.int32)
    padded = np.concatenate([words, np.zeros(2, np.uint32)])
    want = np.asarray(jax_peek_bits(jnp.asarray(padded), jnp.asarray(pos),
                                    width))
    got = peek_bits(torch.from_numpy(words.astype(np.int64)),
                    torch.from_numpy(pos), width)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
