"""What a run loads and how it ends without a card: no module whose
top-level name is jax, jaxlib, flax or tpulc (compared whole, so that
tpulc_torch is not tpulc)."""

import os
import shutil
import subprocess
import sys

from portbench import run

SCRIPT = """
import sys
from portbench import run
code, res = run.run_cell("bsc-e1.pg-x6", 5, 0.3, 0, device="cpu",
                         overrides={"compress": {"block_size": 65536},
                                    "traffic": {"tile": 1, "objects": 1}})
assert code == 0 and res["correct"], res
print(" ".join(sorted({k.split(".")[0] for k in sys.modules})))
"""


def test_run_loads_no_jax_nor_tpulc():
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(r.stdout.split())
    assert "tpulc_torch" in top and "portbench" in top
    assert not top & set(run.FORBIDDEN)


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "bz.pg-x6", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=run.ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "bz.pg-x6", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0 and r.stdout == ""
