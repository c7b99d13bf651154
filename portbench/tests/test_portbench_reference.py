"""The plain decoders against the port's containers at small sizes on
the CPU (the port's plain PyTorch path), and against broken ones."""

import numpy as np
import pytest

from portbench import control
from portbench.reference import bsc, bz, common
from tpulc_torch.pipeline.registry import get_codec

PG = open(f"{common.__file__.rsplit('/', 2)[0]}/data/pg1661.txt", "rb").read()


def soup(n, seed=3, words=(b"the", b"of", b"and", b"lossless", b"entropy")):
    rng = np.random.default_rng(seed)
    return b"".join(words[i] + b" " for i in rng.integers(
        len(words), size=n // 3))[:n]


def records(n, seed=4):
    """Fixed-width binary records: the record filter's input."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((n // 12, 12), np.uint8)
    rec[:, 0:4] = np.arange(n // 12, dtype="<u4").view(np.uint8).reshape(-1, 4)
    rec[:, 4] = rng.integers(0, 4, n // 12)
    rec[:, 8:12] = 0xF2
    return rec.tobytes()


BZ_CASES = {
    "pg": (PG[:150_000], 65_536),
    "soup": (soup(100_000), 40_000),
    "tail": (PG[:70_001], 70_000),
    "tiny": (b"a", 900_000),
    "runs": (b"\x00" * 5_000 + b"ab" * 3_000, 16_384),
}
BSC_CASES = {
    "pg_lzp": (PG[:120_000] * 2, 1 << 17, {}),
    "soup": (soup(100_000), 65_536, {}),
    "periodic": (bytes(range(256)) * 300, 50_000, {}),
    "escapes": (bytes(np.random.default_rng(1).choice(
        np.array([0xF2, 0x41, 0x42, 0x00], np.uint8), 20_000)) * 3,
        1 << 16, {}),
    "reorder": (records(48_000), 1 << 16, {"filter_mode": "reorder:12"}),
    "reverse": (PG[:50_000], 1 << 16, {"filter_mode": "reverse"}),
    "no_lzp": (PG[:40_000], 1 << 16, {"use_lzp": False}),
    "stored": (bytes(np.random.default_rng(2).integers(
        0, 256, 5_000, dtype=np.uint8)), 1 << 16, {}),
    "segmented": (PG[:40_000] + bytes(np.random.default_rng(5).integers(
        0, 256, 40_000, dtype=np.uint8)), 1 << 17, {}),
}


@pytest.mark.parametrize("case", sorted(BZ_CASES))
def test_bz_reads_the_port(case):
    data, bs = BZ_CASES[case]
    c = get_codec("bz").compress(data, block_size=bs, device="cpu")
    assert bz.decode(c) == data


# the payload's flags and coder byte that each case must reach
BSC_SHAPES = {"stored": (2, 2, 1), "segmented": (0, 0, 3),
              "reorder": (128, 128, 1), "pg_lzp": (1, 1, 1),
              "no_lzp": (1, 0, 1)}


@pytest.mark.parametrize("case", sorted(BSC_CASES))
def test_bsc_reads_the_port(case):
    data, bs, kw = BSC_CASES[case]
    c = get_codec("bsc").compress(data, block_size=bs, device="cpu", **kw)
    assert bsc.decode(c) == data
    if case in BSC_SHAPES:
        mask, want, coder = BSC_SHAPES[case]
        _, _, payloads, _ = common.parse_container(c, bsc.CODEC)
        flags, got_coder = payloads[0][20], payloads[0][21]
        assert (flags & mask, got_coder) == (want, coder)


@pytest.mark.parametrize("codec,ref", [("bz", bz), ("bsc", bsc)])
def test_broken_containers_are_refused(codec, ref):
    data = PG[:30_000]
    c = get_codec(codec).compress(data, block_size=16_384, device="cpu")
    with pytest.raises(common.FormatError):
        ref.decode(c[:-1])                      # sizes do not add up
    flipped = bytearray(c)
    flipped[-3] ^= 1
    with pytest.raises(common.FormatError):
        ref.decode(bytes(flipped))              # payload adler32
    resealed = control.flip_payload_byte(c)    # checksums made whole
    try:
        assert ref.decode(resealed) != data
    except (common.FormatError, IndexError, RuntimeError):
        pass


def test_lossy_container_reads_back_wrong():
    data = np.frombuffer(PG[:30_000], np.uint8).copy()
    data[1234] ^= 0x20
    c = get_codec("bsc").compress(data, block_size=16_384, device="cpu")
    assert bsc.decode(c) != PG[:30_000]


def test_lzp_against_a_plain_loop():
    """The run-at-a-time LZP decoder against a byte-at-a-time one."""
    from tpulc_torch.gold.lzp import lzp_encode

    data = (PG[:20_000] + bytes([0xF2, 0, 0xF2]) + PG[5_000:9_000]) * 2
    s = np.frombuffer(lzp_encode(data), np.uint8)
    assert common.lzp_decode(s, len(data)).tobytes() == data
    table, out, i = {}, bytearray(s[:8].tobytes()), 8
    while i < len(s):
        x = int.from_bytes(bytes(out[-8:]), "little")
        h = ((x * 0x9E3779B97F4A7C15) % 2**64) >> (64 - 18)
        q = table.get(h, -1)
        table[h] = len(out)
        c = int(s[i])
        i += 1
        if q >= 0 and c == 0xF2:
            b = int(s[i])
            i += 1
            if b == 0:
                out.append(0xF2)
                continue
            v, shift = 0, 0
            while b & 0x80:
                v |= (b & 0x7F) << shift
                shift += 7
                b = int(s[i])
                i += 1
            for k in range((v | b << shift) - 1 + 32):
                out.append(out[q + k])
            continue
        out.append(c)
    assert bytes(out) == data


def test_mtf_and_bwt_against_plain_loops():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 6, 3_000).astype(np.uint8)
    table, ranks = list(range(256)), []
    for b in data:
        r = table.index(int(b))
        ranks.append(r)
        table.insert(0, table.pop(r))
    import torch
    got = common.mtf_decode(torch.tensor(ranks), chunk=64)
    assert np.array_equal(got.numpy(), data)
    n = data.shape[0]
    rots = sorted(range(n), key=lambda i: data[i:].tobytes() + data[:i].tobytes())
    last = torch.from_numpy(data[[(i - 1) % n for i in rots]])
    out = common.inverse_bwt(last, rots.index(0))
    assert np.array_equal(out.numpy(), data)
