"""The tracer's count of waits against PyTorch's own report of the
synchronising calls, on the card (marked `cuda`; skips without one).
It imports no JAX.  On the card:
`python -m pytest --noconftest -q -m cuda tests/test_torch_timing_cuda.py`.

One round trip of each codec the benchmark's cells run, at its
configuration (`portbench/configs/`) on an object of its traffic, with
the timer on and `torch.cuda.set_sync_debug_mode("warn")`: each warning
is put to the innermost line of the port outside the tracer, which is
where the tracer keys the wait, and the two counts must agree site by
site."""

import collections
import os
import traceback
import warnings

import pytest
import torch

from portbench.run import ROOT, cell_spec
from portbench.traffic import generate
from tpulc_torch.pipeline.registry import get_codec
from tpulc_torch.utils import timing

CELLS = ("bz.words-25m", "bsc-e1.words-25m", "huffman-1m.words-100m",
         "culzss-1m.words-100m")
SEED = 2**31 + 2021
TIMER_SYNC = "(the timer's own synchronisation)"
OUTSIDE = "(outside the port)"


def _site(stack) -> str:
    """The innermost frame of the port outside the tracer, keyed as the
    tracer keys its sites; the timer's own synchronisations apart."""
    here = os.path.abspath(timing.__file__)
    for fr in reversed(stack):
        path = os.path.abspath(fr.filename)
        if path == here and fr.name == "_timer_sync":
            return TIMER_SYNC
        if path.startswith(timing._PACKAGE + os.sep) and path != here:
            return f"{os.path.relpath(path, timing._PACKAGE)}:{fr.lineno}"
    return OUTSIDE


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_synchronising_calls_equal_the_tracer_waits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, config, mix = cell_spec(cell)
    obj = generate.objects(mix, SEED, ROOT)[0]
    codec = get_codec(config["codec"])
    kw = config["compress"]
    # a first round trip builds and loads the kernels
    codec.decompress(codec.compress(obj, device="cuda", **kw), device="cuda")
    torch.cuda.synchronize()
    seen = collections.Counter()
    strays = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()
            site = _site(stack)
            seen[site] += 1
            if site == OUTSIDE:
                strays.append(" <- ".join(
                    f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                    for f in reversed(stack[-8:])))

    timer = timing.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            # setting the mode can report a synchronisation of its own
            torch.cuda.set_sync_debug_mode("warn")
            warnings.showwarning = hook
            try:
                out = codec.decompress(
                    codec.compress(obj, device="cuda", **kw), device="cuda")
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        timing.disable()
    assert out == obj.tobytes()
    counted = collections.Counter(
        {site: row[0] for site, row in timer.sites.items()})
    syncs = sum(1 for s in timer.spans if s.name == timing.SYNC)
    assert syncs > 0
    timer_warnings = seen.pop(TIMER_SYNC, 0)
    for site in sorted(set(seen) | set(counted)):
        print(f"{cell} {site}: synchronising calls {seen[site]}, "
              f"waits {counted[site]}")
    print(f"{cell}: timer syncs {syncs}, their warnings {timer_warnings}")
    for stack in strays:
        print(f"{cell} {OUTSIDE}: {stack}")
    assert seen == counted
    # torch.cuda.synchronize is not among the calls the mode reports
    assert timer_warnings == 0
