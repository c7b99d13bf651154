"""Plain decoder of the culzss container (codec 3): CULZSS's packets
(Ozsoy and Swany, IEEE Cluster 2011; the format its decoder,
`gpu_decompress.cu`, reads).

Block payload, little-endian: npackets (u32), one u16 size a packet
(bit 15 set: the packet is stored raw, and its size must be 4096), then
the packets back to back, filling the payload.  A block of n bytes has
ceil(max(n, 1) / 4096) packets; each decodes to 4096 bytes (a block's
last packet: 4096, or the block's tail), and the block's bytes are cut
to n.

A coded packet is a stream of tokens: a flag byte before each run of
8 tokens, read LSB first, a set bit a literal (1 byte) and a clear bit
a match (2 bytes: its length, then a ring offset).  Each packet has a
ring of 128 bytes, all spaces at first, in which output byte p lands at
slot p mod 128; a match of length L at offset o gives the bytes at
slots o, o + 1, ..., o + L - 1 (mod 128) as the ring stood before the
token.  A packet ends exactly at its last token's last byte; a match of
length 0 is no token.

Each packet is walked serially, a token a step, as the reference's one
thread a packet walks it; every packet of the container takes its step
together, on the device given.  A match copies at most `COPY` bytes a
step and goes on in the next.  On the card the steps run as a CUDA
graph, replayed CHECK steps at a time.  Written from the format in NumPy and
plain PyTorch; nothing here imports the program under test.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from portbench.reference.common import FormatError, join_blocks, parse_container

CODEC = 3
PCKT = 4096
WIN = 128
RAW = 0x8000
COPY = 32      # bytes of a match copied a step
TRASH = PCKT + COPY   # the output column that takes masked-off writes
CHECK = 64     # steps between looks at whether any packet still walks


def parse_block(payload: bytes, raw_size: int):
    """-> (sizes int64[P], raw bool[P], the coded packets' bytes back to
    back, the raw packets uint8[R, PCKT], the bytes the last packet
    gives)."""
    if len(payload) < 4:
        raise FormatError("culzss block: no packet count")
    (P,) = struct.unpack_from("<I", payload)
    if P != -(-max(raw_size, 1) // PCKT):
        raise FormatError(f"culzss block: {P} packets for {raw_size} bytes")
    head = 4 + 2 * P
    if head > len(payload):
        raise FormatError("culzss size table overruns its payload")
    entry = np.frombuffer(payload, "<u2", P, 4).astype(np.int64)
    raw = (entry & RAW) != 0
    sizes = entry & (RAW - 1)
    if np.any(raw & (sizes != PCKT)):
        raise FormatError(f"culzss raw packet other than {PCKT} B")
    if head + int(sizes.sum()) != len(payload):
        raise FormatError("culzss packets do not fill their payload")
    body = np.frombuffer(payload, np.uint8, offset=head)
    raw_byte = np.repeat(raw, sizes)
    return (sizes, raw, body[~raw_byte], body[raw_byte].reshape(-1, PCKT),
            raw_size - (P - 1) * PCKT)


class _Walk:
    """Every coded packet's serial walk: its state, one row a packet,
    updated in place by `step`, so that on the card a run of steps can
    be captured once as a CUDA graph and replayed."""

    def __init__(self, buf: torch.Tensor, size: torch.Tensor):
        L, self.W = buf.shape
        dev = buf.device
        self.buf, self.size = buf, size

        def zeros(dtype=torch.int64):
            return torch.zeros(L, dtype=dtype, device=dev)

        self.bp, self.op, self.k, self.flag = (zeros() for _ in range(4))
        # the match being copied: bytes left, its start, ring offset,
        # bytes done
        self.rem, self.t0, self.off, self.done = (zeros() for _ in range(4))
        self.short, self.empty = zeros(torch.bool), zeros(torch.bool)
        self.out = torch.zeros((L, TRASH + 1), dtype=torch.uint8, device=dev)
        self.j = torch.arange(COPY, device=dev)[None, :]

    def _stopped(self) -> torch.Tensor:
        """Packets that broke the format or ran past PCKT."""
        return self.short | self.empty | (self.op > PCKT)

    def walking(self) -> torch.Tensor:
        return (((self.rem > 0) | (self.bp < self.size))
                & ~self._stopped()).any()

    def step(self) -> None:
        stop = self._stopped()
        self.rem.masked_fill_(stop, 0)
        # a packet with no match to go on with reads its next token
        fresh = (self.rem == 0) & (self.bp < self.size) & ~stop
        grp = fresh & ((self.k & 7) == 0)
        here = self.bp.clamp(max=self.W - 1)[:, None]
        self.flag.copy_(torch.where(
            grp, self.buf.gather(1, here)[:, 0].to(torch.int64), self.flag))
        self.bp += grp
        lit = ((self.flag >> (self.k & 7)) & 1) == 1
        need = torch.where(lit, 1, 2)
        self.short |= fresh & (self.bp + need > self.size)
        fresh &= self.bp + need <= self.size
        here = self.bp.clamp(max=self.W - 2)[:, None]
        b0 = self.buf.gather(1, here)[:, 0].to(torch.int64)
        b1 = self.buf.gather(1, here + 1)[:, 0].to(torch.int64)
        match = fresh & ~lit
        self.empty |= match & (b0 == 0)
        self.rem.copy_(torch.where(match, b0, self.rem))
        self.t0.copy_(torch.where(match, self.op, self.t0))
        self.off.copy_(torch.where(match, b1, self.off))
        self.done.masked_fill_(match, 0)
        self.bp += torch.where(fresh, need, 0)
        self.k += fresh
        # copy: a literal's byte, or up to COPY bytes of a match read
        # from the ring as it stood at the match's start t0
        new_lit = fresh & lit
        n = torch.where(new_lit, 1, self.rem.clamp(max=COPY))
        j = self.j
        slot = (self.off[:, None] + self.done[:, None] + j) % WIN
        t0 = self.t0[:, None]
        q = t0 - 1 - ((t0 - 1 - slot) % WIN)
        val = torch.where(q >= 0, self.out.gather(1, q.clamp(min=0)), 32)
        val = torch.where(new_lit[:, None] & (j == 0),
                          b0[:, None].to(torch.uint8), val)
        pos = torch.where(j < n[:, None], self.op[:, None] + j, TRASH)
        self.out.scatter_(1, pos.clamp(max=TRASH), val)
        self.op += n
        moved = torch.where(new_lit, 0, n)
        self.done += moved
        self.rem -= moved


def _steps(walk: _Walk):
    """-> a function that takes CHECK steps of the walk: on the card a
    CUDA graph of them (after one step taken to warm up), else a loop."""
    if walk.buf.device.type != "cuda":
        return lambda: [walk.step() for _ in range(CHECK)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        walk.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CHECK):
            walk.step()
    return graph.replay


def decode_packets(coded: np.ndarray, sizes: np.ndarray, tails: np.ndarray,
                   dev) -> np.ndarray:
    """The coded packets (their bytes back to back, `sizes` each) ->
    uint8[len(sizes), PCKT]; packet i must give PCKT or tails[i] bytes
    (the bytes after them are zeros)."""
    L = sizes.shape[0]
    if L == 0:
        return np.zeros((0, PCKT), np.uint8)
    W = int(sizes.max()) + 2

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    size = put(sizes)
    buf = torch.zeros((L, W), dtype=torch.uint8, device=dev)
    buf[torch.arange(W, device=dev)[None, :] < size[:, None]] = put(coded)
    walk = _Walk(buf, size)
    steps = _steps(walk)
    while bool(walk.walking()):
        steps()
    if bool(walk.empty.any()):
        raise FormatError("culzss match of length 0")
    if bool(walk.short.any()):
        raise FormatError("culzss packet ends inside a token")
    if bool(((walk.op != PCKT) & (walk.op != put(tails))).any()):
        raise FormatError("culzss packet decodes to the wrong length")
    return walk.out[:, :PCKT].cpu().numpy()


def decode(container: bytes, device="cpu") -> bytes:
    """A culzss container -> the bytes it holds; raises FormatError."""
    orig_len, block_size, payloads, adler = parse_container(container, CODEC)
    raw_sizes = [max(0, min(block_size, orig_len - i * block_size))
                 for i in range(len(payloads))]
    blocks = [parse_block(p, n) for p, n in zip(payloads, raw_sizes)]
    sizes = np.concatenate([b[0] for b in blocks])
    raw = np.concatenate([b[1] for b in blocks])
    tails = np.full(sizes.shape[0], PCKT, np.int64)
    tails[np.cumsum([b[0].shape[0] for b in blocks]) - 1] = \
        [b[4] for b in blocks]
    decoded = np.zeros((sizes.shape[0], PCKT), np.uint8)
    decoded[~raw] = decode_packets(np.concatenate([b[2] for b in blocks]),
                                   sizes[~raw], tails[~raw],
                                   torch.device(device))
    if raw.any():
        decoded[raw] = np.concatenate([b[3] for b in blocks])
    out, p = [], 0
    for b, n in zip(blocks, raw_sizes):
        P = b[0].shape[0]
        out.append(decoded[p: p + P].reshape(-1)[:n])
        p += P
    return join_blocks(out, orig_len, adler)
