#!/usr/bin/env python3
"""Prove the PyTorch/CUDA port (tpulc_torch) runs on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit (nvidia-smi); CUDA must be present;
2. build the hand-written kernels from tpulc_torch/csrc (nvcc, sm_90a);
3. each kernel (K1, K2, K4 MTF; K3 Huffman walk) against its plain
   PyTorch version on the card at the main path's shapes (7,032 chunks
   x 128 from a real 900 KB block; K3 on that block's real stream):
   bit-identical, timed with CUDA events (median of 5 after warm-up);
4. the bz main path: bz compress + decompress of pg1661 x 6 (3,569,598
   B, 900,000 B blocks) through the codec entry points on the card, with
   every kernel's launch count reset before and read after; exact round
   trip, ratio 4.145, each kernel launched, the container byte-identical
   to the port's CPU path on a small input; MB/s from warm repeats;
5. the huffman kernels (K3 packed, K7 v1, K8 flat) against their plain
   versions at the huffman path's full width: the 100 MB group of 96
   blocks x 8,192 chunks x 128 symbols from its real streams;
   bit-identical, timed as in phase 3;
6. the huffman main path: compress + decompress of 100,000,000 B of
   pg1661 at 1 MiB blocks, counted as in phase 4: exact round trip, the
   container's size and sha256 equal to tpulc's, K3 launched; decoded
   again with kernel="v1" and "flat" (K7 and K8 counted the same way);
   pg1661 x 6 at 1 MiB equal to tpulc's container; MB/s from warm
   repeats, decode-only GB/s per decoder on device-resident parsed
   input, the self-sync decode's time, and peak device memory.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

CORPUS_SIZE = 3_569_598  # pg1661.txt x 6, bench.py's corpus
BLOCK = 900_000
RATIO = 4.145
# tpulc's container for the same input (JAX reference, CPU run)
TPULC_SHA256 = "e8895df92c8f65d717206d88007f6ffc6a957b68b14341026371e1afa5dd724e"
# huffman, bench.py's huffman_decode_100MB input at 1 MiB blocks, and
# pg1661 x 6 at 1 MiB: tpulc's containers (JAX reference, CPU run)
HUFF_SIZE = 100_000_000
HUFF_BLOCK = 1 << 20
HUFF_MAX_LEN = 12
HUFF_BYTES = 59_030_504
HUFF_SHA256 = "65530b4906eaf5f8098dbc2a2866e6ce41d43294cdbe438098a7428e78a555fb"
HUFF_X6_SHA256 = "8ad209108c27f84d686c37ec34076dba64b2394f48f855d66632d9b582a88282"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def corpus(here: str, size: int = CORPUS_SIZE) -> bytes:
    """pg1661.txt repeated to `size` bytes (bench.py's make_corpus)."""
    with open(os.path.join(here, "tests", "data", "pg1661.txt"), "rb") as f:
        raw = f.read()
    return (raw * (size // len(raw) + 1))[:size]


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(torch, got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max())


def check_kernels(torch, checks) -> list[dict]:
    """Each (name, source, replaces, kernel, plain, args, shape) against
    its plain version on the same card tensors; launches are filled in
    from the main path's run later."""
    kernels = []
    for name, src, replaces, kern, plain, args, shape in checks:
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        del got, want
        ms = time_ms(torch, lambda: kern(*args))
        plain_ms = time_ms(torch, lambda: plain(*args))
        print(f"kernel {name}: shape {shape} max_abs_err {err} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
        require(err == 0, f"{name} disagrees with its plain version")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return kernels


def synced(torch, fn):
    """(fn(), host seconds) with the device synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(torch, wrappers: dict, fn):
    """Run fn() with every wrapper's launch count reset just before;
    -> (fn(), host seconds, {name: launches})."""
    for w in wrappers.values():
        w.launches = 0
    out, dt = synced(torch, fn)
    return out, dt, {k: w.launches for k, w in wrappers.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.bwt import driver
    from tpulc_torch.codecs.bwt.rotsort import bwt_encode_anchored
    from tpulc_torch.codecs.huffman import decode_kernels as dk
    from tpulc_torch.pipeline.container import Container
    from tpulc_torch.primitives import mtf_kernels as mk
    from tpulc_torch.primitives.mtf import start_tables

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{' '.join(cuda_lib.NVCC_FLAGS)})", flush=True)

    # 3. kernels vs plain at the main path's shapes
    data = corpus(here)
    cap = driver._cap_for(BLOCK)
    block = torch.zeros(cap, dtype=torch.uint8)
    block[:BLOCK] = torch.frombuffer(bytearray(data[:BLOCK]), dtype=torch.uint8)
    last, _, _, _ = bwt_encode_anchored(block.to(dev), driver.ANCHOR_STRIDE)
    d = last.to(torch.int32).reshape(-1, 128).contiguous()
    rec = mk.mtf_recency(d)
    table0 = start_tables(rec, 128)
    ranks, _ = mk.mtf_encode_lockstep(table0, d)
    payload = Container.from_bytes(
        driver.compress(data[:BLOCK], block_size=BLOCK, device="cuda")
    ).payloads[0]
    _, walk, _, _ = driver.walk_args(payload, cap, dev)
    mtf_shape = "x".join(map(str, d.shape))
    kernels = check_kernels(torch, [
        ("mtf_recency", "tpulc_torch/csrc/mtf.cu",
         "tpulc/primitives/mtf_pallas.py:215",
         mk.mtf_recency, mk.mtf_recency_plain, (d,), mtf_shape),
        ("mtf_encode_lockstep", "tpulc_torch/csrc/mtf.cu",
         "tpulc/primitives/mtf_pallas.py:156",
         mk.mtf_encode_lockstep, mk.mtf_encode_lockstep_plain, (table0, d),
         mtf_shape),
        ("huffman_walk", "tpulc_torch/csrc/huffman_walk.cu",
         "tpulc/codecs/huffman/pallas_decode.py:362",
         dk.huffman_walk, dk.huffman_walk_plain, walk,
         f"{walk[2].shape[0]}x{walk[6]}"),
        ("mtf_lockstep", "tpulc_torch/csrc/mtf.cu",
         "tpulc/primitives/mtf_pallas.py:89",
         mk.mtf_lockstep, mk.mtf_lockstep_plain, (table0, ranks), mtf_shape),
    ])

    # 4. the main path, counted
    wrappers = {"mtf_recency": mk.mtf_recency,
                "mtf_encode_lockstep": mk.mtf_encode_lockstep,
                "huffman_walk": dk.huffman_walk,
                "mtf_lockstep": mk.mtf_lockstep}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = driver.compress(data, block_size=BLOCK, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = driver.decompress(comp, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: w.launches for k, w in wrappers.items()}
    for k in kernels:
        k["launches"] = counts[k["name"]]
    ratio = len(data) / len(comp)
    sha = hashlib.sha256(comp).hexdigest()
    print(f"main path (first run): compress {t1 - t0:.3f} s, decompress "
          f"{t2 - t1:.3f} s, launches {counts}", flush=True)
    require(back == data, "round trip is not exact")
    require(round(ratio, 3) == RATIO, f"ratio {ratio} != {RATIO}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the path never launched: {counts}")

    # the container does not depend on the device (small input)
    small = data[:150_000]
    on_card = driver.compress(small, block_size=1 << 16, device="cuda")
    on_cpu = driver.compress(small, block_size=1 << 16, device="cpu")
    require(on_card == on_cpu, "card and CPU containers differ")
    require(driver.decompress(on_cpu, device="cuda") == small,
            "card fails to decode the CPU container")

    cs, ds = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = driver.compress(data, block_size=BLOCK, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        driver.decompress(c, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        require(c == comp, "compress is not deterministic")
        cs.append(t1 - t0)
        ds.append(t2 - t1)
    c_s, d_s = statistics.median(cs), statistics.median(ds)
    mb = len(data) / 1e6
    print(json.dumps({
        "bz_pg1661x6": {
            "input_bytes": len(data), "container_bytes": len(comp),
            "ratio": ratio, "sha256": sha,
            "sha256_equals_tpulc": sha == TPULC_SHA256,
            "compress_s": c_s, "decompress_s": d_s,
            "compress_MBps": mb / c_s, "decompress_MBps": mb / d_s,
            "roundtrip_MBps": mb / (c_s + d_s),
            "timing": "median of 3 warm runs, host clock, synchronized",
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }}))
    huffman_phases(torch, here, dev, kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def huffman_phases(torch, here: str, dev, kernels: list) -> None:
    """Phases 5 and 6; appends K3 packed, K7 and K8 to `kernels`."""
    from functools import partial

    from tpulc_torch.codecs.huffman import decode as hdec
    from tpulc_torch.codecs.huffman import decode_kernels as dk
    from tpulc_torch.codecs.huffman import driver as hdrv
    from tpulc_torch.pipeline.container import Container

    L = HUFF_MAX_LEN
    big = corpus(here, HUFF_SIZE)
    mb = HUFF_SIZE / 1e6

    # 5. kernels vs plain on the full 100 MB group's real streams
    comp0, cold_c = synced(torch, lambda: hdrv.compress(
        big, block_size=HUFF_BLOCK, device="cuda"))
    payloads = Container.from_bytes(comp0).payloads
    words, tbits, lens, offs, ns, chunk = hdrv._parse_aligned_group(
        payloads, HUFF_BLOCK)
    nblocks = -(-HUFF_SIZE // HUFF_BLOCK)          # 96: one group
    require(len(payloads) == nblocks and chunk == 128
            and offs.shape == (nblocks, HUFF_BLOCK // 128)
            and ns[-1] == HUFF_SIZE - (nblocks - 1) * HUFF_BLOCK,
            f"unexpected group shape {offs.shape}, chunk {chunk}")
    group = hdrv._to_device(words, tbits, lens, offs, dev)
    wargs, _ = hdec.walk_args(*group, chunk, L)
    fargs, _ = hdec.flat_args(*group, chunk, L)
    shape = f"{wargs[2].shape[0]}x{chunk}"
    kernels += check_kernels(torch, [
        ("huffman_walk_packed", "tpulc_torch/csrc/huffman_walk.cu",
         "tpulc/codecs/huffman/pallas_decode.py:362",
         partial(dk.huffman_walk, packed=True),
         partial(dk.huffman_walk_plain, packed=True), wargs, shape),
        ("huffman_walk_v1", "tpulc_torch/csrc/huffman_v1.cu",
         "tpulc/codecs/huffman/pallas_decode.py:143",
         dk.huffman_walk_v1, dk.huffman_walk_v1_plain, wargs, shape),
        ("huffman_walk_flat", "tpulc_torch/csrc/huffman_flat.cu",
         "tpulc/codecs/huffman/pallas_decode.py:560",
         dk.huffman_walk_flat, dk.huffman_walk_flat_plain, fargs,
         f"{fargs[1].shape[0]}x{chunk}"),
    ])
    del wargs, fargs

    # 6. the huffman main path, counted; then v1 and flat, each counted
    torch.cuda.reset_peak_memory_stats()
    path = {"huffman_walk": dk.huffman_walk,
            "huffman_walk_v1": dk.huffman_walk_v1,
            "huffman_walk_flat": dk.huffman_walk_flat}
    def round_trip():
        c = hdrv.compress(big, block_size=HUFF_BLOCK, device="cuda")
        return c, hdrv.decompress(c, device="cuda")

    (comp, back), dt, counts = counted(torch, path, round_trip)
    sha = hashlib.sha256(comp).hexdigest()
    print(f"huffman main path: {dt:.3f} s, {len(comp)} B, sha256 {sha}, "
          f"launches {counts}", flush=True)
    require(back == big, "huffman round trip is not exact")
    require(len(comp) == HUFF_BYTES and sha == HUFF_SHA256,
            "huffman container differs from tpulc's")
    require(comp == comp0, "huffman compress is not deterministic")
    require(counts["huffman_walk"] > 0, f"K3 packed never launched: {counts}")
    launches = {"huffman_walk_packed": counts["huffman_walk"]}
    for kern, name in (("v1", "huffman_walk_v1"),
                       ("flat", "huffman_walk_flat")):
        out, _, cnt = counted(torch, path, lambda: hdrv.decompress(
            comp, device="cuda", kernel=kern))
        require(out == big, f"decode with kernel={kern} differs")
        require(cnt[name] > 0, f"{name} never launched: {cnt}")
        launches[name] = cnt[name]
    for k in kernels:
        k["launches"] = launches.get(k["name"], k["launches"])
    x6 = corpus(here)
    require(hashlib.sha256(hdrv.compress(
        x6, block_size=HUFF_BLOCK, device="cuda")).hexdigest()
        == HUFF_X6_SHA256, "pg1661 x 6 container differs from tpulc's")

    cs, ds = [], []
    for _ in range(3):
        c, tc = synced(torch, lambda: hdrv.compress(
            big, block_size=HUFF_BLOCK, device="cuda"))
        _, td = synced(torch, lambda: hdrv.decompress(c, device="cuda"))
        cs.append(tc)
        ds.append(td)
    c_s, d_s = statistics.median(cs), statistics.median(ds)
    decode_gbps = {}
    for kern in hdrv.KERNELS:   # bench.py:138-155's protocol, on the card
        synced(torch, lambda: hdrv.decode_batch_device(
            *group, chunk, L, kernel=kern))
        reps = [synced(torch, lambda: hdrv.decode_batch_device(
            *group, chunk, L, kernel=kern))[1] for _ in range(3)]
        decode_gbps[kern] = HUFF_SIZE / 1e9 / statistics.median(reps)
    peak = torch.cuda.max_memory_allocated()
    ss_comp = hdrv.compress(x6, block_size=HUFF_BLOCK, aligned=False,
                            device="cuda")
    ss_back, ss_s = synced(torch, lambda: hdrv.decompress(ss_comp,
                                                          device="cuda"))
    require(ss_back == x6, "self-sync round trip is not exact")
    print(json.dumps({"huffman_100MB": {
        "input_bytes": HUFF_SIZE, "block_size": HUFF_BLOCK,
        "container_bytes": len(comp), "ratio": HUFF_SIZE / len(comp),
        "sha256": sha, "sha256_equals_tpulc": sha == HUFF_SHA256,
        "first_compress_s": cold_c,
        "compress_s": c_s, "decompress_s": d_s,
        "compress_MBps": mb / c_s, "decompress_MBps": mb / d_s,
        "roundtrip_MBps": mb / (c_s + d_s),
        "decode_only_GBps": decode_gbps,
        "selfsync_pg1661x6_decompress_s": ss_s,
        "timing": "median of 3 warm runs, host clock, synchronized",
        "peak_mem_bytes": peak,
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
