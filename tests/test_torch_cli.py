"""The port's CLI against tpulc's: given tpulc's argv (no -c, no -b: both
default to huffman with 1 MiB blocks; `-c bz -b 65536`; `-c bsc -b
65536` with bsc's default `-e 1`; `-c bsc -e 2 -b 65536`; the same two
on the ST-8 sorter, `-m st8`; `-c lzss -b 65536` with and without
`--exact`), it writes tpulc's bytes, and `info` reports the same on
either package's output.  `-c bzip2 --level N` writes Python's
`bz2.compress` bytes, and `info` and `decompress` take a bare .bz2 as
tpulc's do.  The port's argv adds `--device cpu`, its only option tpulc
lacks, because this check runs without a card."""

import bz2
import json

import pytest
import torch

from tpulc.cli.main import main as tpulc_main
from tpulc_torch.cli.main import main as port_main

torch.set_num_threads(1)


@pytest.mark.parametrize("extra", [[], ["-c", "bz", "-b", "65536"],
                                   ["-c", "bsc", "-b", "65536"],
                                   ["-c", "bsc", "-e", "2", "-b", "65536"],
                                   ["-c", "bsc", "-m", "st8", "-b", "65536"],
                                   ["-c", "bsc", "-m", "st8", "-e", "2", "-b",
                                    "65536"],
                                   ["-c", "lzss", "-b", "65536"],
                                   ["-c", "lzss", "-b", "65536", "--exact"]],
                         ids=["defaults", "bz", "bsc_e1", "bsc_e2",
                              "bsc_st8", "bsc_st8_e2", "lzss", "lzss_exact"])
def test_same_argv_same_bytes(tmp_path, capsys, extra):
    src = tmp_path / "in.txt"
    with open("tests/data/pg1661.txt", "rb") as f:
        src.write_bytes(f.read(150000))
    theirs, ours = tmp_path / "t.tplc", tmp_path / "p.tplc"
    assert tpulc_main(["compress", "-i", str(src), "-o", str(theirs),
                       *extra]) == 0
    assert port_main(["compress", "-i", str(src), "-o", str(ours), *extra,
                      "--device", "cpu"]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    capsys.readouterr()
    infos = []
    for main, path in ((tpulc_main, theirs), (port_main, theirs),
                       (port_main, ours)):
        assert main(["info", "-i", str(path)]) == 0
        infos.append(json.loads(capsys.readouterr().out))
    assert infos[0] == infos[1] == infos[2]
    assert infos[0]["codec"] == (extra[1] if extra else "huffman")
    assert infos[0]["block_size"] == (65536 if extra else 1 << 20)
    back = tmp_path / "back.txt"
    assert port_main(["decompress", "-i", str(theirs), "-o", str(back),
                      "--device", "cpu"]) == 0
    assert back.read_bytes() == src.read_bytes()


@pytest.mark.parametrize("level", [None, 1, 9])
def test_bzip2_level_writes_the_stdlib_bytes(tmp_path, capsys, level):
    """`-c bzip2` (tpulc's default block size, so level 9, or `--level`)
    writes `bz2.compress`'s bytes; `info` and `decompress` sniff `BZh`
    in either package's CLI."""
    src = tmp_path / "in.txt"
    with open("tests/data/pg1661.txt", "rb") as f:
        src.write_bytes(f.read(40000))
    out = tmp_path / "o.bz2"
    extra = [] if level is None else ["--level", str(level)]
    assert port_main(["compress", "-c", "bzip2", "-i", str(src), "-o",
                      str(out), *extra, "--device", "cpu"]) == 0
    assert out.read_bytes() == bz2.compress(src.read_bytes(), level or 9)
    capsys.readouterr()
    for main in (tpulc_main, port_main):
        assert main(["info", "-i", str(out)]) == 0
        assert json.loads(capsys.readouterr().out) == {
            "format": ".bz2", "level": level or 9, "streams": 1}
    back = tmp_path / "back.txt"
    assert port_main(["decompress", "-i", str(out), "-o", str(back),
                      "--device", "cpu"]) == 0
    assert back.read_bytes() == src.read_bytes()
