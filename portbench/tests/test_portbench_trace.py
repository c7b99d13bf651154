"""Reading the profiler's events: the union of device intervals inside
the timed calls, annotations left out, idle gaps named by the innermost
stage, the hand kernels' records grouped by the kernels they launch, and
a bound scaled down where the profiler lost records."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import trace

KERNELS = trace.kernel_modules()


def ev(a, b, name, dev=True):
    return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b),
                           name=name, device_type=DeviceType.CUDA if dev
                           else DeviceType.CPU)


def prof(events):
    return SimpleNamespace(events=lambda: events)


EVENTS = [
    ev(0, 1000, trace.CALL + "compress", dev=False),
    ev(100, 600, trace.STAGE + "bz.transform", dev=False),
    ev(600, 900, trace.STAGE + "bz.pull", dev=False),
    ev(0, 1000, trace.CALL + "compress"),            # annotation
    ev(100, 600, trace.STAGE + "bz.transform"),      # annotation
    ev(200, 300, "void scan_kernel<long, true, false>(long const*)"),
    ev(250, 400, "void scan_kernel<long, false, true>(long const*)"),
    ev(500, 550, "void mtf_recency_kernel<32>(int const*)"),
    ev(700, 720, "Memcpy DtoH (Device -> Pageable)"),
    ev(1000, 2000, trace.CALL + "decompress", dev=False),
    ev(1100, 1600, "void anchored_walk_kernel<2>(unsigned const*)"),
    ev(1600, 1700, "void count_kernel(unsigned char const*)"),
]


def test_busy_idle_and_gaps():
    p = trace.read_profile(prof(EVENTS), KERNELS)
    c, d = p["directions"]["compress"], p["directions"]["decompress"]
    assert c["wall_s"] == pytest.approx(1000e-6)
    assert c["busy_s"] == pytest.approx((200 + 50 + 20) * 1e-6)
    assert d["busy_s"] == pytest.approx(600e-6)
    gaps = dict(p["idle_gaps"])
    # each part of a gap goes to the innermost stage open over it
    assert gaps["compress:bz.transform"] == pytest.approx((100 + 150) * 1e-6)
    assert gaps["compress:bz.pull"] == pytest.approx(280e-6)
    assert gaps["compress:(between stages)"] == pytest.approx(200e-6)
    assert not any(n.startswith(trace.ANNOTATIONS) for n, _ in p["device_ops"])
    assert c["kernels"]["scan_kernel"] == [2, pytest.approx(250e-6)]
    assert d["kernels"]["anchored_walk_kernel+count_kernel"] == \
        [2, pytest.approx(600e-6)]


def test_roofline_groups_and_lost_records():
    p = trace.read_profile(prof(EVENTS), KERNELS)
    bounds = {("running_max", "compress"): [1, 1, 100e-6],
              ("running_min", "compress"): [1, 1, 50e-6],
              ("mtf_recency", "compress"): [2, 2, 40e-6],   # one record lost
              ("anchored_walk", "decompress"): [1, 1, 60e-6]}
    lines = []
    r = trace.roofline(p["directions"], bounds, KERNELS, lines.append)
    assert r["compress"]["bound_s"] == pytest.approx(150e-6 + 20e-6)
    assert r["compress"]["device_s"] == pytest.approx(300e-6)
    assert r["decompress"]["bound_s"] == pytest.approx(60e-6)
    assert any("expected 2 recorded 1" in line for line in lines)


def test_a_gap_is_split_at_stage_edges():
    events = [ev(0, 100, trace.CALL + "decompress", dev=False),
              ev(50, 100, trace.STAGE + "bsc.lzp.decode", dev=False),
              ev(60, 90, trace.STAGE + "inner", dev=False),
              ev(10, 20, "void scan_kernel<int, true, true>(int const*)")]
    gaps = dict(trace.read_profile(prof(events), KERNELS)["idle_gaps"])
    assert gaps == {"decompress:(between stages)": pytest.approx(40e-6),
                    "decompress:bsc.lzp.decode": pytest.approx(20e-6),
                    "decompress:inner": pytest.approx(30e-6)}
