"""The multi-chip dry run on the port (the twin of tpulc's
`__graft_entry__.py:dryrun_multichip`), and the launcher of ranks.

`dryrun_multichip(n, device="cuda")` runs tpulc's seven checks on the
port's sharded steps at tpulc's shapes (2 blocks a rank of 512 bytes,
culzss at one packet a block): in the caller's process group when one
is initialised, else in n ranks that it starts with
`torch.multiprocessing.spawn`: one a card over NCCL, or, with
device="cpu", n CPU processes over gloo.

`spawn_ranks(n, backend, fn, *args)` runs fn(*args) in n fresh
processes joined by a group of that backend on a free localhost port
(an NCCL rank r on card r); the ranks import only what fn's module
imports.  `record_steps` is such an fn: each CPU rank writes every
sharded step's outputs and `compress_multihost`'s containers to an
.npz, for comparison with tpulc.
"""

from __future__ import annotations

import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpulc_torch.device import resolve

BLOCK = 512


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, backend: str, fn,
               args) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(n: int, backend: str, fn, *args,
                timeout: float = 600.0) -> None:
    """fn(*args) on n ranks of a `backend` group ("gloo": CPU processes;
    "nccl": rank r on card r); raises when a rank fails, and kills them
    all past `timeout` seconds."""
    ctx = mp.start_processes(
        _rank_main, args=(n, free_port(), backend, fn, args), nprocs=n,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n} {backend} ranks still running after "
                               f"{timeout} s")


def _require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _checks(n: int, device_type: str) -> None:
    from tpulc_torch.codecs.lzss.culzss import PCKT
    from tpulc_torch.dist.mesh import make_mesh
    from tpulc_torch.dist.sharded import (
        sharded_abc_roundtrip,
        sharded_bsc_rans_forward,
        sharded_bz_forward,
        sharded_bz_roundtrip,
        sharded_culzss_roundtrip,
        sharded_grc_roundtrip,
        sharded_huffman_roundtrip_step,
    )

    mesh = make_mesh(n, device_type)
    B = 2 * n

    def same(got, want) -> bool:
        return np.array_equal(got.cpu().numpy(), np.asarray(want))

    step, make_args = sharded_bz_forward(mesh, BLOCK)
    syms, *_, sizes = step(*make_args(B))
    _require(sizes.shape == (B,) and syms.shape[0] == B, "bz forward shapes")

    step, make_args = sharded_huffman_roundtrip_step(mesh, BLOCK)
    ghist, _, bits = step(*make_args(B))
    _require(int(ghist.sum()) == B * BLOCK and bits.shape == (B,),
             "huffman step: histogram or bit counts")

    step, make_args = sharded_bz_roundtrip(mesh, BLOCK)
    args = make_args(B)
    back, _ = step(*args)
    _require(same(back, args[0]), "bz round trip differs from its input")

    step, make_args = sharded_bsc_rans_forward(mesh, BLOCK)
    _, ms = step(*make_args(B))
    _require(ms.shape == (B,), "bsc forward shapes")

    step, make_args = sharded_abc_roundtrip(mesh, BLOCK)
    args = make_args(B)
    out, words = step(*args)
    _require(same(out, args[0]) and words.shape == (B,),
             "adaptive coder round trip differs from its input")

    step, make_args = sharded_grc_roundtrip(mesh, BLOCK)
    args = make_args(B)
    out, words = step(*args)
    _require(same(out, args[0]) and words.shape == (B,),
             "group-rank coder round trip differs from its input")

    step, make_args = sharded_culzss_roundtrip(mesh, PCKT)
    args = make_args(B)
    out, sizes = step(*args)
    _require(same(out, args[0]) and sizes.shape == (B,),
             "culzss round trip differs from its input")


def dryrun_multichip(n: int, device: str | torch.device | None = None) -> None:
    """tpulc's seven sharded checks on n ranks, on the card unless
    device="cpu": in the caller's group when one is initialised (its
    world size must be n), else on n spawned ranks, one a card over NCCL
    (raises when the machine has fewer than n cards) or n CPU processes
    over gloo."""
    dev = resolve(device)
    if dist.is_initialized():
        _checks(n, dev.type)
    elif dev.type == "cpu":
        spawn_ranks(n, "gloo", _checks, n, "cpu")
    else:
        cards = torch.cuda.device_count()
        if cards < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) on the card needs {n} cards, one a "
                f"rank, and this machine has {cards} (device='cpu' runs "
                "CPU ranks over gloo)")
        spawn_ranks(n, "nccl", _checks, n, "cuda")


def record_steps(path: str, n_blocks: int, seed: int, data: bytes,
                 block_size: int) -> None:
    """Every sharded step on make_args(n_blocks, seed) at tpulc's
    shapes, and `compress_multihost(data, block_size)` for huffman, bz
    and culzss, on the CPU ranks of the caller's group; rank r writes
    its outputs to `path`/rank{r}.npz with the modules it imported
    (`jax`, `conftest`: 1 when present)."""
    from tpulc_torch.codecs.lzss.culzss import PCKT
    from tpulc_torch.dist import sharded
    from tpulc_torch.dist.mesh import make_mesh
    from tpulc_torch.dist.multihost import compress_multihost

    mesh = make_mesh(device_type="cpu")
    out = {}
    for name, size in (("huffman_roundtrip_step", BLOCK),
                       ("bz_forward", BLOCK), ("bz_roundtrip", BLOCK),
                       ("bsc_rans_forward", BLOCK), ("abc_roundtrip", 1024),
                       ("grc_roundtrip", BLOCK), ("culzss_roundtrip", PCKT)):
        step, make_args = getattr(sharded, "sharded_" + name)(mesh, size)
        for j, x in enumerate(step(*make_args(n_blocks, seed))):
            out[f"{name}/{j}"] = x.numpy()
    _, make_args = sharded.sharded_huffman_roundtrip_step(mesh, BLOCK)
    blocks, ns, codes, lengths = make_args(n_blocks, seed)
    ns[-1] = 100
    out["global_histogram/0"] = sharded.global_histogram(
        mesh, blocks, ns).numpy()
    words, bits = sharded.sharded_huffman_encode(
        mesh, blocks, ns, codes, lengths, BLOCK * 8 // 32 + 1)
    out["huffman_encode/0"], out["huffman_encode/1"] = (words.numpy(),
                                                        bits.numpy())
    for codec in ("huffman", "bz", "culzss"):
        c = compress_multihost(data, block_size, codec, device="cpu")
        if c is not None:
            out[f"multihost/{codec}"] = np.frombuffer(c, np.uint8)
    out["imported/jax"] = np.array(int("jax" in sys.modules))
    out["imported/conftest"] = np.array(int("conftest" in sys.modules))
    np.savez(os.path.join(path, f"rank{dist.get_rank()}.npz"), **out)
