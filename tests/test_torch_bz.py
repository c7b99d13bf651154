"""The port's slice end to end on the CPU: the bz codec of tpulc_torch
against tpulc's.  Containers must be byte-identical (the multi-table
selectors agree on these inputs), each package must decode the
other's containers, and the port's CLI must round-trip."""

import numpy as np
import pytest
import torch

from tpulc.codecs import store as jstore
from tpulc.codecs.bwt import driver as jdrv
from tpulc_torch.cli.main import main as cli_main
from tpulc_torch.codecs import store
from tpulc_torch.codecs.bwt import driver
from tpulc_torch.pipeline.registry import get_codec

torch.set_num_threads(1)


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read(n)


def _case(name):
    if name == "pg1661_150k":  # text blocks + a zero-padded tail block
        return _pg(150000), 1 << 16
    if name == "text":
        return (b"the quick brown fox jumps over the lazy dog. " * 1200)[:50000], 32768
    if name == "random":
        rng = np.random.default_rng(21)
        return rng.integers(0, 256, size=70000).astype(np.uint8).tobytes(), 32768
    if name == "structured":
        rng = np.random.default_rng(22)
        words = [b"the ", b"and ", b"compression ", b"block ", b"a ", b"of "]
        return b"".join(words[i] for i in rng.integers(0, 6, size=20000))[:80000], 32768
    if name.startswith("edge"):  # tiny blocks: anchor-less, single-table
        n = int(name[4:])
        rng = np.random.default_rng(n)
        return rng.integers(0, 4, size=n).astype(np.uint8).tobytes(), 1024
    if name == "empty":
        return b"", 1024
    if name == "periodic":  # ranks never unique: pointer-doubling decode
        return b"abc" * 3000, 1 << 16
    raise KeyError(name)


CASES = ["pg1661_150k", "text", "random", "structured", "edge1", "edge63",
         "edge64", "edge65", "edge1000", "empty", "periodic"]


@pytest.mark.parametrize("name", CASES)
def test_bz_container_identical_and_cross_decodes(name):
    data, bs = _case(name)
    ours = driver.compress(data, block_size=bs, device="cpu")
    theirs = jdrv.compress(data, block_size=bs)
    assert ours == theirs
    assert driver.decompress(ours, device="cpu") == data
    assert driver.decompress(theirs, device="cpu") == data
    assert jdrv.decompress(ours) == data


def test_bz_decode_paths_are_exercised():
    """pg1661 at 1<<16 mixes multi-table anchored blocks with a
    single-table tail; the tiny and periodic blocks are anchor-less."""
    from tpulc_torch.pipeline.container import Container

    data, bs = _case("pg1661_150k")
    modes = [driver._BLOCK_HEAD.unpack(p[: driver._BLOCK_HEAD.size])[4]
             for p in Container.from_bytes(
                 driver.compress(data, block_size=bs, device="cpu")).payloads]
    assert 3 in modes  # anchored + multi-table
    for name in ("edge1", "periodic"):
        data, bs = _case(name)
        p = Container.from_bytes(
            driver.compress(data, block_size=bs, device="cpu")).payloads[0]
        assert driver._BLOCK_HEAD.unpack(p[: driver._BLOCK_HEAD.size])[4] == 0


def test_bz_corruption_is_refused():
    data, bs = _case("text")
    comp = bytearray(driver.compress(data, block_size=bs, device="cpu"))
    comp[-5] ^= 0xFF
    with pytest.raises(ValueError):
        driver.decompress(bytes(comp), device="cpu")


def test_store_matches_tpulc():
    data = _pg(5000)
    ours = store.compress(data, block_size=1024, device="cpu")
    assert ours == jstore.compress(data, block_size=1024)
    assert store.decompress(ours, device="cpu") == data


def test_registry_serves_bz_and_store_only():
    """bz, store and (since later slices) huffman, bsc, bzip2, lzss and
    culzss resolve: every codec of tpulc's registry."""
    assert get_codec("bz") is driver
    assert get_codec(0) is store
    assert get_codec("huffman").__name__ == "tpulc_torch.codecs.huffman.driver"
    assert get_codec("bsc").__name__ == "tpulc_torch.codecs.bsclike.driver"
    assert get_codec("bzip2").__name__ == "tpulc_torch.codecs.bwt.bzip2_codec"
    assert get_codec("lzss").__name__ == "tpulc_torch.codecs.lzss.driver"
    assert get_codec("culzss").__name__ == \
        "tpulc_torch.codecs.lzss.culzss_driver"


def test_cli_roundtrip_and_info(tmp_path, capsys):
    src = tmp_path / "in.txt"
    src.write_bytes(_pg(40000))
    comp, back = tmp_path / "out.tplc", tmp_path / "back.txt"
    assert cli_main(["compress", "-c", "bz", "-i", str(src), "-o", str(comp),
                     "-b", "32768", "--device", "cpu"]) == 0
    assert cli_main(["info", "-i", str(comp)]) == 0
    assert '"codec": "bz"' in capsys.readouterr().out
    assert cli_main(["decompress", "-i", str(comp), "-o", str(back),
                     "--device", "cpu"]) == 0
    assert back.read_bytes() == src.read_bytes()
    assert jdrv.decompress(comp.read_bytes()) == src.read_bytes()
    # bsc with its default -e 1, on the ST-8 sorter, and culzss (the
    # last codec ported) round-trip
    for extra in (["-c", "bsc"], ["-c", "bsc", "-m", "st8"],
                  ["-c", "culzss"]):
        assert cli_main(["compress", *extra, "-i", str(src),
                         "-o", str(comp), "--device", "cpu"]) == 0
        assert cli_main(["decompress", "-i", str(comp), "-o", str(back),
                         "--device", "cpu"]) == 0
        assert back.read_bytes() == src.read_bytes()
