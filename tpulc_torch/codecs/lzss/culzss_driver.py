"""CULZSS codec driver: container payloads with a per-packet size table
(port of `tpulc/codecs/lzss/culzss_driver.py`; the same bytes).

Payload layout per block (little-endian), tpulc's form of CULZSS's
bookkeeping header (`culzss.c:220-264`):

    npackets  u32
    sizes     u16 * npackets   (bit 15 set = raw 4096-byte packet, the
                                "compression took more" fallback)
    packets   back to back

Each block is zero-padded to its packet grid, and the zeros are part of
the last packet's bytes.  Every block's packets go through one encode
pass and one decode pass (`culzss.py`, in groups of packets); tpulc
also pads the packet count to a power of two, an XLA compile-cache
device whose extra packets are thrown away, which the port does not
copy.  The packets' bodies are compacted on the device and pulled once.

Spans (`utils/timing.py`): the roots `culzss.compress` and
`culzss.decompress`; `culzss.group` a group of packets (`culzss.py`;
block index: its first packet); the coarse stages `culzss.grid`,
`culzss.pull` and `culzss.container` here and `culzss.doubling` (the
match search; on the CPU `culzss.candidates` before it),
`culzss.parse` and `culzss.pack` in an encode group; `culzss.payloads`, `culzss.out` and `culzss.verify` here and
`culzss.records` and `culzss.rounds` in a decode group.  Every blocking
read of the card goes through `timing.wait` or `timing.upload`.  While
the timer is on, compress adds `#culzss_packets`,
`#culzss_raw_packets`, and the tokens and matches of the packets it
stores coded (`#culzss_tokens`, `#culzss_matches`) to its totals, and
decompress the pointer-doubling rounds of its groups
(`#culzss_rounds`).

Where tpulc `assert`s the codec id (dropped by `python -O`) and lets a
packet that decodes to the wrong length pass to the adler32 check, the
port raises ValueError: a wrong codec id, a size table or bodies that
overrun the payload, a packet count that does not cover the block, a
raw entry other than 4096 B, a coded entry longer than a packet's
encoded bound, a packet that decodes to another length than 4096 (or
the block's tail, for its last packet), and a zero-length match.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tpulc_torch.codecs.lzss.culzss import (
    CAP_OUT,
    PCKT,
    culzss_decode_block,
    culzss_encode_block,
)
from tpulc_torch.codecs.lzss.driver import _as_array
from tpulc_torch.device import resolve
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_LZSS_CULZSS
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.utils import timing

RAW_FLAG = 0x8000


def _npackets(nbytes: int) -> int:
    """Packets of a block of `nbytes` (an empty block is one packet)."""
    return -(-max(nbytes, 1) // PCKT)


def block_packets(nbytes: int, block_size: int) -> list[int]:
    """Packets of each block of `block_size` bytes of an input of
    `nbytes` (an empty input is one block)."""
    return [_npackets(min(nbytes - s, block_size))
            for s in range(0, max(nbytes, 1), block_size)]


def packet_grid(arr: np.ndarray, block_size: int,
                counts: list[int]) -> np.ndarray:
    """uint8[sum(counts) * PCKT]: arr's blocks back to back, each
    zero-padded to its `counts` packets (`block_packets`)."""
    grid = np.zeros(sum(counts) * PCKT, np.uint8)
    o = 0
    for s, c in zip(range(0, arr.shape[0], block_size), counts):
        chunk = arr[s: s + block_size]
        grid[o: o + chunk.shape[0]] = chunk
        o += c * PCKT
    return grid


def compress(data: bytes | np.ndarray, block_size: int = 1 << 20,
             device: str | torch.device | None = None) -> bytes:
    with timing.stage("culzss.compress"):
        dev = resolve(device)
        arr = _as_array(data)
        n = arr.shape[0]
        counts = block_packets(n, block_size)
        with timing.stage("culzss.grid"):
            grid = packet_grid(arr, block_size, counts)
            packets = timing.upload(grid, dev)
        out, sizes, ntokens = culzss_encode_block(packets)
        counting = timing.counting()
        with timing.stage("culzss.pull"):
            raw = sizes >= PCKT      # incompressible packet: store raw
            blen = torch.where(raw, PCKT, sizes)
            out[:, :PCKT] = torch.where(raw[:, None],
                                        packets.reshape(-1, PCKT),
                                        out[:, :PCKT])
            keep = torch.arange(CAP_OUT, device=dev)[None, :] < blen[:, None]
            bodies = timing.wait(torch.Tensor.cpu, timing.wait(
                torch.Tensor.__getitem__, out, keep, nbytes=8)).numpy()
            # the token counts ride along with the sizes only while the
            # timer counts
            meta = timing.wait(torch.Tensor.cpu, torch.stack(
                [sizes, ntokens]) if counting else sizes[None]).numpy()
            sizes = meta[0]
        if counting:
            coded = sizes < PCKT
            toks = meta[1][coded]
            timing.add_totals(
                ("#culzss_packets", "#culzss_raw_packets", "#culzss_tokens",
                 "#culzss_matches"),
                (sizes.shape[0], int((~coded).sum()), int(toks.sum()),
                 int((sizes[coded] - toks - ((toks + 7) >> 3)).sum())))
        with timing.stage("culzss.container"):
            table = np.where(sizes >= PCKT, RAW_FLAG | PCKT,
                             sizes).astype("<u2")
            ends = np.cumsum(np.minimum(sizes, PCKT))
            payloads = []
            p = 0
            for c in counts:
                b0 = int(ends[p - 1]) if p else 0
                payloads.append(struct.pack("<I", c)
                                + table[p: p + c].tobytes()
                                + bodies[b0: int(ends[p + c - 1])].tobytes())
                p += c
            return Container(
                codec_id=CODEC_LZSS_CULZSS, flags=0, orig_len=n,
                block_size=block_size,
                comp_sizes=[len(x) for x in payloads], payloads=payloads,
                data_adler=adler32_np(arr),
            ).to_bytes()


def _parse(payload: bytes, raw_size: int):
    """One block's payload -> (sizes int64[P] (0 for a raw packet),
    raw bool[P], coded bytes, raw packets uint8[R, PCKT])."""
    if len(payload) < 4:
        raise ValueError("corrupt culzss block: no packet count")
    (P,) = struct.unpack("<I", payload[:4])
    if P != _npackets(raw_size):
        raise ValueError(f"corrupt culzss block: {P} packets for "
                         f"{raw_size} bytes")
    if 4 + 2 * P > len(payload):
        raise ValueError("corrupt culzss block: the size table overruns "
                         "its payload")
    entry = np.frombuffer(payload, "<u2", count=P, offset=4).astype(np.int64)
    raw = (entry & RAW_FLAG) != 0
    lens = entry & 0x7FFF
    if np.any(raw & (lens != PCKT)):
        raise ValueError("corrupt culzss block: a raw packet entry other "
                         f"than {PCKT} B")
    if np.any(~raw & (lens > CAP_OUT)):
        raise ValueError("corrupt culzss block: a packet size past its "
                         "encoded bound")
    body = np.frombuffer(payload, np.uint8, offset=4 + 2 * P)
    if int(lens.sum()) > body.shape[0]:
        raise ValueError("corrupt culzss block: packets overrun the payload")
    raw_byte = np.repeat(raw, lens)
    body = body[: raw_byte.shape[0]]
    return (np.where(raw, 0, lens), raw, body[~raw_byte],
            body[raw_byte].reshape(-1, PCKT))


def decompress(buf: bytes,
               device: str | torch.device | None = None) -> bytes:
    with timing.stage("culzss.decompress"):
        dev = resolve(device)
        c = Container.from_bytes(buf)
        if c.codec_id != CODEC_LZSS_CULZSS:
            raise ValueError(
                f"not a culzss container (codec id {c.codec_id})")
        with timing.stage("culzss.payloads"):
            parts = [_parse(p, info.raw_size)
                     for p, info in zip(c.payloads, c.block_infos())]
            psizes = np.concatenate([x[0] for x in parts])
            raw = np.concatenate([x[1] for x in parts])
            # bytes each packet must give: PCKT, but its tail for a
            # block's last
            want = np.full(psizes.shape[0], PCKT, np.int64)
            ends = np.cumsum([x[0].shape[0] for x in parts]) - 1
            want[ends] = [info.raw_size - (x[0].shape[0] - 1) * PCKT
                          for x, info in zip(parts, c.block_infos())]
            psz = timing.upload(psizes, dev)
            pbuf = torch.zeros((psizes.shape[0], CAP_OUT), dtype=torch.uint8,
                               device=dev)
            timing.wait(torch.Tensor.__setitem__, pbuf,
                        torch.arange(CAP_OUT, device=dev)[None, :]
                        < psz[:, None],
                        timing.upload(np.concatenate([x[2] for x in parts]),
                                      dev), nbytes=8)
        out, outl = culzss_decode_block(pbuf, psz)
        with timing.stage("culzss.out"):
            want_t = timing.upload(want, dev)
            raw_t = timing.upload(raw, dev)
            last = torch.zeros_like(raw_t)
            # a scalar put: its value is copied to the card, a wait
            timing.wait(torch.Tensor.__setitem__, last,
                        timing.upload(ends, dev), True, nbytes=1)
            bad = ~raw_t & (outl != PCKT) & ~(last & (outl == want_t))
            if timing.wait(bool, bad.any()):
                j = int(torch.nonzero(bad)[0])
                raise ValueError(f"corrupt culzss packet {j}: decodes to "
                                 f"{int(outl[j])} bytes, not {int(want[j])}")
            if raw.any():
                timing.wait(torch.Tensor.__setitem__, out, raw_t,
                            timing.upload(np.concatenate(
                                [x[3] for x in parts]), dev), nbytes=8)
            keep = torch.arange(PCKT, device=dev)[None, :] < want_t[:, None]
            got = timing.wait(torch.Tensor.cpu, timing.wait(
                torch.Tensor.__getitem__, out, keep,
                nbytes=8)).numpy()[: c.orig_len]
        with timing.stage("culzss.verify"):
            if not c.verify_data(got):
                raise ValueError("data checksum mismatch after decompress")
            return got.tobytes()
