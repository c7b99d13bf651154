"""The comparison that decides `correct`: a sound run is correct, and a
run with the control or any planted fault in the program's place is not
(the run's own path, the card's look skipped, on the port's plain
PyTorch path at a small size)."""

import pytest
import torch

from portbench import control, run

SMALL = {
    "bsc-e1.words-25m": {"compress": {"block_size": 32_768},
                        "traffic": {"size": 50_000, "objects": 2}},
    "bz.pg-x6": {"compress": {"block_size": 65_536},
                 "traffic": {"tile": 1, "objects": 2}},
}
SEED = 2**31 + 4242


def one_run(cell, wrap=None, seconds=0.3, device="cpu", overrides=None):
    code, res = run.run_cell(cell, SEED, seconds, 0, device=device,
                             codec_wrap=wrap,
                             overrides=SMALL[cell] if overrides is None
                             else overrides)
    assert code == 0
    return res


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    res = one_run(cell)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault):
    res = one_run(cell, lambda c: control.Faulty(c, fault, SEED))
    assert not res["correct"]
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.cuda
def test_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = one_run("bz.pg-x6", lambda c: control.Faulty(c, "lossy", SEED),
                  seconds=2.0, device="cuda", overrides={})
    assert not res["correct"]
    assert res["checks"]["containers_wrong"]["value"] >= 1
