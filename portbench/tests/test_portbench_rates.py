"""The end-to-end readers: a rate is all the bytes over all the time of
its direction's calls (not a median of calls), the ratio all bytes in
over all container bytes."""

import numpy as np
import pytest

from portbench import run


def trips(times, sizes, csizes):
    objs = [np.zeros(s, np.uint8) for s in sizes]
    out = []
    for i, ((tc, td), cs) in enumerate(zip(times, csizes)):
        t = run.RoundTrip(i)
        t.container_bytes, t.output_bytes = cs, sizes[i]
        t.compress_s, t.decompress_s = tc, td
        out.append(t)
    return out, objs


@pytest.mark.parametrize("name", ["compress_MBps", "decompress_MBps"])
def test_rate_is_total_over_total(name):
    # one slow call among fast ones: the median would read 10 MB/s
    times = [(0.1, 0.1), (0.1, 0.1), (1.0, 1.0)]
    t, objs = trips(times, [1_000_000] * 3, [100] * 3)
    rec = {"window": run.window_totals(t, objs)}
    got = run.reader(name)(rec)
    assert got == pytest.approx(3.0 / 1.2)


def test_ratio_is_total_over_total():
    t, objs = trips([(1, 1)] * 2, [1000, 3000], [100, 900])
    rec = {"window": run.window_totals(t, objs)}
    assert run.reader("ratio")(rec) == pytest.approx(4000 / 1000)


def test_failed_calls_are_not_timed():
    t, objs = trips([(0.5, 0.5)] * 2, [1000] * 2, [10] * 2)
    t[1].decompress_s, t[1].output_bytes = None, None
    w = run.window_totals(t, objs)
    assert w["compress"]["calls"] == 2 and w["decompress"]["calls"] == 1
    assert w["decompress"]["seconds"] == 0.5


def test_readers_without_data_return_none():
    for m in run.load_json(run.ROOT, "BENCHMARK.json")["per_layer"]:
        assert run.reader(m["name"])({}) is None
