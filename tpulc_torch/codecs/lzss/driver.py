"""LZSS codec driver: container integration and the bare reference
format (port of `tpulc/codecs/lzss/driver.py`; the same bytes).

A block's payload is the Dipperstein bitstream alone (the self-sync
decode needs no metadata).  `compress_raw` / `decompress_raw` write and
read the bare reference format (lzss-0.6.2's comp/decomp output).

Like tpulc, a tail block is zero-padded to a power-of-two bucket
(`_bucket_cap`) and encoded with `n_valid`.  tpulc does it so that XLA
compiles one encode program a bucket; the port keeps it because the
padding is part of the bytes: at the block's own length, a last match
that tpulc lets run on into the zeros (where the same bytes once came
before zeros) ends as literals instead.  tpulc `assert`s on the codec
id of the container it decodes, which `python -O` drops; the port
raises ValueError.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.codecs.lzss.decode import lzss_decode_device
from tpulc_torch.codecs.lzss.encode import lzss_encode_device
from tpulc_torch.device import resolve
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_LZSS
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.utils import timing

# 16 exact-3-gram chains + 8 7-gram chains (tpulc's choice: ratio 1.9102
# against 1.9162 at k=32 on its bench corpus, at ~1.9x the encode speed)
K_CANDIDATES = 16


def _as_array(data: bytes | np.ndarray) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, np.uint8)
    return np.asarray(data, np.uint8)


def _bucket_cap(n: int, block_cap: int) -> int:
    """tpulc's power-of-two tail buckets: 4096, 8192, ... up to the
    block size; a full block is its own bucket."""
    if n >= block_cap:
        return block_cap
    cap = 4096
    while cap < n:
        cap *= 2
    return min(cap, block_cap)


def compress_block(block: np.ndarray, block_cap: int, dev: torch.device,
                   k_cand: int = K_CANDIDATES, exact: bool = False) -> bytes:
    """One block's bitstream, encoded on `dev`."""
    n = block.shape[0]
    cap = _bucket_cap(n, block_cap)
    padded = np.zeros(cap, np.uint8)
    padded[:n] = block
    # worst case 9 bits a byte
    out_words = -(-(cap * 9 + 64) // 32)
    words, total_bits = lzss_encode_device(
        torch.from_numpy(padded).to(dev), k_cand, out_words, exact, n)
    with timing.stage("lzss.pull"):
        nbytes = -(-int(total_bits) // 8)
        return words.cpu().numpy().astype(">u4").tobytes()[:nbytes]


def _words(payloads: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Payloads -> (uint32 words [B, W] zero-padded, bits [B]); W leaves
    at least one zero word after the longest stream, so a 17-bit peek
    near a stream's end reads zeros, as tpulc's padded rows do."""
    nw = max(-(-len(p) // 4) for p in payloads) + 1
    W = np.zeros((len(payloads), nw), np.uint32)
    for j, p in enumerate(payloads):
        buf = p + b"\x00" * (-len(p) % 4)
        W[j, : len(buf) // 4] = np.frombuffer(buf, ">u4")
    bits = np.array([8 * len(p) for p in payloads], np.int64)
    return W, bits


def _decode(payloads: list[bytes], n_out: int, dev: torch.device):
    """All blocks in one batched decode -> (uint8 [B, n_out] on the
    host, n_valid int [B])."""
    W, bits = _words(payloads)
    out, n_valid = lzss_decode_device(
        torch.from_numpy(W.astype(np.int64)).to(dev),
        torch.from_numpy(bits).to(dev), n_out)
    with timing.stage("lzss.pull"):
        return out.cpu().numpy(), n_valid.cpu().numpy()


def compress_raw(data: bytes | np.ndarray, k_cand: int = K_CANDIDATES,
                 exact: bool = False,
                 device: str | torch.device | None = None) -> bytes:
    """Bare reference-format bitstream (one stream, no container).

    exact=True finds true longest matches (the compressed size of the
    reference's brute-force encoder); the default uses hash chains."""
    arr = _as_array(data)
    return compress_block(arr, arr.shape[0], resolve(device), k_cand, exact)


def decompress_raw(payload: bytes, out_cap: int,
                   device: str | torch.device | None = None) -> bytes:
    """Decode a bare reference-format bitstream (e.g. lzss-0.6.2's);
    out_cap must bound the decoded size."""
    out, n_valid = _decode([payload], out_cap, resolve(device))
    return out[0, : int(n_valid[0])].tobytes()


def compress(data: bytes | np.ndarray, block_size: int = 1 << 20,
             k_cand: int = K_CANDIDATES, exact: bool = False,
             device: str | torch.device | None = None) -> bytes:
    dev = resolve(device)
    arr = _as_array(data)
    n = arr.shape[0]
    payloads = [compress_block(arr[s: s + block_size], block_size, dev,
                               k_cand, exact)
                for s in range(0, max(n, 1), block_size)]
    c = Container(
        codec_id=CODEC_LZSS, flags=0, orig_len=n, block_size=block_size,
        comp_sizes=[len(p) for p in payloads], payloads=payloads,
        data_adler=adler32_np(arr),
    )
    return c.to_bytes()


def decompress(buf: bytes,
               device: str | torch.device | None = None) -> bytes:
    dev = resolve(device)
    c = Container.from_bytes(buf)
    if c.codec_id != CODEC_LZSS:
        raise ValueError(f"not an lzss container (codec id {c.codec_id})")
    outs, n_valids = _decode(c.payloads, c.block_size, dev)
    parts = []
    for j, info in enumerate(c.block_infos()):
        if int(n_valids[j]) < info.raw_size:
            raise ValueError(
                "corrupt lzss block: decoded %d of %d bytes"
                % (int(n_valids[j]), info.raw_size))
        parts.append(outs[j, : info.raw_size])
    out = b"".join(x.tobytes() for x in parts)[: c.orig_len]
    if not c.verify_data(np.frombuffer(out, np.uint8)):
        raise ValueError("data checksum mismatch after decompress")
    return out
