"""BENCHMARK.json against the contract it is written to, and a cell, a
traffic mix and a per-layer metric added from files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"device", "kernels", "transforms", "entropy coders", "host stages"}


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cells_match_their_files():
    for w in BENCH["workloads"]:
        cell, config, mix = run.cell_spec(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert config["name"] == w["config"]
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        conf = run.load_json(run.ROOT, c["file"])
        assert conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics_have_readers_and_cells_report_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(f"{run.HERE}/metrics/{m['name']}.py")
    for m in BENCH["per_layer"]:
        assert m["layer"] in LAYERS and m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)
    for c in cells:
        assert len(run.cell_metrics(c, 0)) >= 2
        assert run.cell_metrics(c, 1)


def test_no_old_benchmark_is_read():
    for dirpath, _, files in os.walk(run.HERE):
        if dirpath.endswith("tests"):
            continue
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for word in ("bench.py", "bench_scaling", "BENCH_",
                             "import jax", "from jax", "import tpulc\n",
                             "from tpulc "):
                    assert word not in text, (f, word)
    for f in os.listdir(f"{run.HERE}/reference"):
        if f.endswith(".py"):
            assert "tpulc_torch" not in open(f"{run.HERE}/reference/{f}").read()


NEW_CELL_SCRIPT = """
import json
from portbench import run
for cell in ("bz.pg-x1", "store.pg-x1"):
    code, res = run.run_cell(cell, 11, 0.3, {trace}, device="cpu",
                             overrides={{"compress": {{"block_size": 65536}}}})
    assert code == 0, cell
    print(json.dumps(res))
"""

# a codec that no configuration used before: its plain decoder is a new
# module of `reference/`, found by the codec's name
STORE_REFERENCE = """
import numpy as np

from portbench.reference.common import join_blocks, parse_container


def decode(container, device="cpu"):
    n, _, payloads, adler = parse_container(container, 0)
    return join_blocks([np.frombuffer(p, np.uint8) for p in payloads], n,
                       adler)
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_and_metric_from_files_alone(tmp_path, trace):
    """A traffic mix, a configuration with a codec of its own (and that
    codec's plain decoder), two cells and a per-layer metric, added as
    files and BENCHMARK.json entries: both cells run and are correct."""
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(run.ROOT, "tpulc_torch"), tmp_path / "tpulc_torch")
    pb = tmp_path / "portbench"
    (pb / "traffic" / "pg-x1.json").write_text(json.dumps(
        {"kind": "rotate_tile", "file": "portbench/data/pg1661.txt",
         "tile": 1, "objects": 1}))
    (pb / "configs" / "store-1m.json").write_text(json.dumps(
        {"name": "store-1m", "codec": "store",
         "compress": {"block_size": 1 << 20}, "reduced": []}))
    (pb / "reference" / "store.py").write_text(STORE_REFERENCE)
    (pb / "cells" / "bz.pg-x1.json").write_text(json.dumps(
        {"config": "bz-900k", "traffic": "pg-x1", "chips": 1}))
    (pb / "cells" / "store.pg-x1.json").write_text(json.dumps(
        {"config": "store-1m", "traffic": "pg-x1", "chips": 1}))
    (pb / "metrics" / "stages_seen.compress.py").write_text(
        "def read(run):\n"
        "    s = run.get('stages', {}).get('compress')\n"
        "    return float(len(s)) if s else None\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [
        {"name": "store-1m", "source": "https://github.com/IlyaGrebnov/libbsc",
         "file": "portbench/configs/store-1m.json", "reduced": [],
         "why": "the store fallback"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "bz.pg-x1", "config": "bz-900k", "traffic": "pg-x1",
         "chips": 1, "why": "added from files alone"},
        {"name": "store.pg-x1", "config": "store-1m", "traffic": "pg-x1",
         "chips": 1, "why": "a codec added from files alone"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "stages_seen.compress", "unit": "stages", "better": "lower",
         "source": "program_span", "layer": "transforms",
         "moves": "compress_MBps", "workloads": ["bz.pg-x1"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = subprocess.run([sys.executable, "-c",
                        NEW_CELL_SCRIPT.format(trace=trace)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    bz, store = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    assert bz["correct"] and store["correct"]
    assert store["attempted"] >= 1
    if trace:
        assert bz["metrics"]["stages_seen.compress"]["value"] >= 3
        assert "stages_seen.compress" not in store["metrics"]
    else:
        for res in (bz, store):
            assert set(res["metrics"]) == {m["name"]
                                           for m in BENCH["end_to_end"]}
