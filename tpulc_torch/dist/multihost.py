"""Block-striped compression over the ranks of a process group, with
rank-0 container assembly (port of `tpulc/dist/multihost.py`; the same
container).

Each rank compresses the blocks it owns (block b belongs to rank b % W,
tpulc's static stripe), and the payloads gather to every rank for rank
0 to assemble in block order.  tpulc gathers through
`process_allgather` of (counts, sizes, padded bytes); here they are
three `all_gather`s over the default group (no pickled objects).  A run
without a group, or with one rank, gathers nothing.  Every rank must
call `compress_multihost` with the same arguments.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpulc_torch.pipeline.container import Container
from tpulc_torch.primitives.checksum import adler32_np


def block_owner(block_idx: int, n_procs: int) -> int:
    """Block b belongs to rank b % n_procs (round-robin stripes balance
    a block count that the rank count does not divide)."""
    return block_idx % n_procs


def local_block_indices(n_blocks: int, proc: int, n_procs: int) -> list[int]:
    return [b for b in range(n_blocks) if block_owner(b, n_procs) == proc]


def assemble_container(codec_id: int, orig_len: int, block_size: int,
                       n_blocks: int, per_proc_payloads: list[list[bytes]],
                       data_adler: int) -> bytes:
    """Order per-rank payload lists back into block order and build the
    container (flags 0, as tpulc's)."""
    n_procs = len(per_proc_payloads)
    cursors = [0] * n_procs
    ordered = []
    for b in range(n_blocks):
        p = block_owner(b, n_procs)
        if cursors[p] >= len(per_proc_payloads[p]):
            raise ValueError(f"rank {p} holds no payload for block {b}")
        ordered.append(per_proc_payloads[p][cursors[p]])
        cursors[p] += 1
    return Container(
        codec_id=codec_id, flags=0, orig_len=orig_len, block_size=block_size,
        comp_sizes=[len(p) for p in ordered], payloads=ordered,
        data_adler=data_adler,
    ).to_bytes()


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.stack(parts)


def _gather_payload_lists(local: list[bytes]) -> list[list[bytes]]:
    """Every rank's payload list, on every rank: an `all_gather` of the
    counts, then of the sizes, then of the byte buffers padded to the
    largest payload."""
    _, n_procs = _world()
    if n_procs == 1:
        return [local]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    counts = _all_gather(torch.tensor([len(local)], device=dev)).reshape(-1)
    max_count = int(counts.max())
    sizes = torch.zeros(max_count, dtype=torch.int64, device=dev)
    sizes[: len(local)] = torch.tensor([len(p) for p in local],
                                       dtype=torch.int64)
    all_sizes = _all_gather(sizes).cpu().numpy()
    buf = np.zeros((max_count, int(all_sizes.max())), np.uint8)
    for i, p in enumerate(local):
        buf[i, : len(p)] = np.frombuffer(p, np.uint8)
    all_buf = _all_gather(torch.from_numpy(buf).to(dev)).cpu().numpy()
    return [[all_buf[p, i, : all_sizes[p, i]].tobytes()
             for i in range(int(counts[p]))] for p in range(n_procs)]


def compress_multihost(data: bytes | np.ndarray, block_size: int = 900_000,
                       codec_name: str = "bz",
                       device: str | torch.device | None = None
                       ) -> bytes | None:
    """Compress `data`, each rank its block stripe on `device` (default
    "cuda", the rank's card).  Returns the container on rank 0 and None
    on the others."""
    from tpulc_torch.codecs.lzss.driver import _as_array
    from tpulc_torch.pipeline.registry import available_codecs, get_codec

    arr = _as_array(data)
    n = arr.shape[0]
    n_blocks = max(1, -(-n // block_size))
    proc, n_procs = _world()
    codec = get_codec(codec_name)
    local = []
    for b in local_block_indices(n_blocks, proc, n_procs):
        chunk = arr[b * block_size: (b + 1) * block_size]
        sub = Container.from_bytes(codec.compress(
            chunk.tobytes(), block_size=block_size, device=device))
        if len(sub.payloads) != 1:
            raise RuntimeError(f"{codec_name} wrote {len(sub.payloads)} "
                               "payloads for one block")
        local.append(sub.payloads[0])
    gathered = _gather_payload_lists(local)
    if proc != 0:
        return None
    return assemble_container(available_codecs()[codec_name], n, block_size,
                              n_blocks, gathered, adler32_np(arr))
