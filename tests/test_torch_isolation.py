"""The port stands alone: importing every tpulc_torch module (the bsc
slices' `gold/lzp.py`, `gold/st_inverse.py`, `codecs/bsclike/*`,
`codecs/bwt/masked.py` and `codecs/bwt/stk.py`, the bzip2 and lzss
slice's `codecs/bwt/{bz2stream,bzip2_codec}.py`, `gold/bzip2.py`,
`codecs/lzss/*` and `primitives/parallel.py`, the culzss and
distribution slice's `codecs/lzss/culzss*.py` and `dist/*`, and the
primitive layer's `primitives/{parallel,suffix,dc3,dc3_device,
histogram,cudpp_aux}.py` and `gold/{lzss_gold,culzss_gold}.py` among
them)
pulls in neither jax nor triton nor tpulc (the card's machine has no
jax), builds nothing and initialises no process group, and asking for
CUDA without a card raises instead of running on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

import tpulc_torch.device as device_mod
from tpulc_torch.codecs import store
from tpulc_torch.codecs.bwt import driver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import tpulc_torch
for m in pkgutil.walk_packages(tpulc_torch.__path__, "tpulc_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "triton", "tpulc"))
print("BAD", bad)
print("BUILT", tpulc_torch.cuda_lib._lib is not None)
import tpulc_torch.gold.lzp as lzp
import tpulc_torch.gold.st_inverse as st_inverse
import tpulc_torch.gold.bzip2 as gold_bzip2
import tpulc_torch.gold.lzss_gold as lzss_gold
print("LZP_BUILT", lzp._lib is not None or st_inverse._lib is not None
      or gold_bzip2._lib is not None or lzss_gold._lib is not None)
import torch.distributed as dist
print("GROUP", dist.is_available() and dist.is_initialized())
print("MODULES", sorted(m.name for m in pkgutil.walk_packages(
    tpulc_torch.__path__, "tpulc_torch.")))
"""

BSC_SLICE = ["tpulc_torch.gold.lzp", "tpulc_torch.codecs.bsclike.driver",
             "tpulc_torch.codecs.bsclike.filters",
             "tpulc_torch.codecs.bsclike.grc",
             "tpulc_torch.codecs.bsclike.grc_kernels",
             "tpulc_torch.codecs.bsclike.rans",
             "tpulc_torch.codecs.bsclike.rans_adaptive",
             "tpulc_torch.codecs.bsclike.abc_kernels",
             "tpulc_torch.gold.st_inverse", "tpulc_torch.gold.build",
             "tpulc_torch.codecs.bwt.masked", "tpulc_torch.codecs.bwt.stk",
             "tpulc_torch.codecs.bwt.bz2stream",
             "tpulc_torch.codecs.bwt.bzip2_codec", "tpulc_torch.gold.bzip2",
             "tpulc_torch.codecs.lzss", "tpulc_torch.codecs.lzss.encode",
             "tpulc_torch.codecs.lzss.decode", "tpulc_torch.codecs.lzss.driver",
             "tpulc_torch.primitives.parallel",
             "tpulc_torch.primitives.histogram",
             "tpulc_torch.primitives.suffix", "tpulc_torch.primitives.dc3",
             "tpulc_torch.primitives.dc3_device",
             "tpulc_torch.primitives.cudpp_aux",
             "tpulc_torch.gold.lzss_gold", "tpulc_torch.gold.culzss_gold",
             "tpulc_torch.codecs.lzss.culzss",
             "tpulc_torch.codecs.lzss.culzss_driver", "tpulc_torch.dist",
             "tpulc_torch.dist.mesh", "tpulc_torch.dist.sharded",
             "tpulc_torch.dist.multihost", "tpulc_torch.dist.dryrun"]


def test_import_pulls_in_no_jax_triton_or_tpulc():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert "BUILT False" in r.stdout  # nothing compiles at import
    assert "LZP_BUILT False" in r.stdout
    assert "GROUP False" in r.stdout    # importing tpulc_torch.dist
    for name in BSC_SLICE:
        assert repr(name) in r.stdout, name


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve("cuda")
    with pytest.raises(RuntimeError):
        driver.compress(b"abc", block_size=1024)
    with pytest.raises(RuntimeError):
        store.decompress(store.compress(b"abc", device="cpu"))
    from tpulc_torch.codecs.bsclike import driver as bsc

    with pytest.raises(RuntimeError):
        bsc.compress(b"abc", coder=2)
    from tpulc_torch.codecs.bwt import bzip2_codec
    from tpulc_torch.codecs.lzss import culzss_driver as culzss
    from tpulc_torch.codecs.lzss import driver as lzss

    for call in (lambda: bzip2_codec.compress(b"abc"),
                 lambda: bzip2_codec.decompress(
                     bzip2_codec.compress(b"abc", device="cpu")),
                 lambda: lzss.compress(b"abc"),
                 lambda: lzss.decompress(lzss.compress(b"abc", device="cpu")),
                 lambda: culzss.compress(b"abc"),
                 lambda: culzss.decompress(
                     culzss.compress(b"abc", device="cpu"))):
        with pytest.raises(RuntimeError):
            call()
    from tpulc_torch.primitives import cudpp_aux

    for call in (lambda: cudpp_aux.md5_rand(4, 1),
                 lambda: cudpp_aux.CuckooTable([1, 2], [3, 4])):
        with pytest.raises(RuntimeError):
            call()
    assert device_mod.resolve("cpu").type == "cpu"
