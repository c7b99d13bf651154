"""The port's CLI against tpulc's: given tpulc's argv (no -c, no -b: both
default to huffman with 1 MiB blocks; `-c bz -b 65536`; `-c bsc -b
65536` with bsc's default `-e 1`; `-c bsc -e 2 -b 65536`; the same two
on the ST-8 sorter, `-m st8`), it writes
tpulc's bytes, and `info` reports the same on either package's output.
The port's argv adds `--device cpu`, its only option tpulc lacks,
because this check runs without a card."""

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
                                    "65536"]],
                         ids=["defaults", "bz", "bsc_e1", "bsc_e2",
                              "bsc_st8", "bsc_st8_e2"])
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
