"""CUHD drop-in interop: llhuff bitstream semantics (port of
`tpulc/codecs/huffman/cuhd_compat.py`; the same streams).

The reference demo (`cuhd-icpp/src/demo.cc:33-183`) compresses with the
length-limited llhuff encoder and writes the RAW unit stream — no
header, no table serialization; the decoder table lives in memory
(`demo.cc:110-117`).  Interop therefore means bitstream compatibility:

  - length-limited code lengths, max 11 bits (`MAX_CODEWORD_LENGTH`
    `include/cuhd_constants.h:5`), package-merge
    (`llhuffman_encoder.cc:18-158`);
  - canonical codeword assignment in increasing-length order with the
    reference's `code = (code + 1) << (next_len - len)` recurrence
    (`llhuffman_encoder.cc:183-196`);
  - MSB-first packing into 32-bit units, zero-padded tail
    (`encode_memory`, `llhuffman_encoder.cc:200-239`) — the convention
    of `tpulc_torch.primitives.bits`.

Within a length, symbols are ordered by ascending value (the reference
iterates an unordered_map).  Decode uses the self-synchronising decoder
(`decode.huffman_decode`) with the demo's 4-unit subsequences
(`demo.cc:25`).  Encode and decode run on `device` (default "cuda").
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.codecs.huffman.decode import huffman_decode
from tpulc_torch.codecs.huffman.tables import package_merge_lengths
from tpulc_torch.device import resolve
from tpulc_torch.primitives.bits import pack_bits

MAX_CODEWORD_LENGTH = 11  # cuhd_constants.h:5
SUBSEQ_UNITS = 4          # demo.cc:25 (SUBSEQ_SIZE)


def llhuff_symbol_lengths(data: np.ndarray) -> dict[int, int]:
    """Optimal length-limited code lengths (<= 11 bits) per symbol;
    ties resolved by ascending symbol value rather than hash order."""
    data = np.asarray(data, np.uint8)
    freqs = np.bincount(data, minlength=256).astype(np.int64)
    present = np.flatnonzero(freqs)
    if present.shape[0] == 0:
        return {}
    if present.shape[0] == 1:
        return {int(present[0]): 1}
    lens = package_merge_lengths(freqs, MAX_CODEWORD_LENGTH)
    return {int(s): int(lens[s]) for s in present}


def llhuff_encoder_table(lengths: dict[int, int]) -> dict[int, tuple[int, int]]:
    """(symbol -> (codeword, length)) with the reference's canonical
    recurrence (`llhuffman_encoder.cc:183-196`)."""
    items = sorted(lengths.items(), key=lambda kv: (kv[1], kv[0]))
    table: dict[int, tuple[int, int]] = {}
    code = 0
    cur_len = items[0][1]
    for i, (sym, ln) in enumerate(items):
        table[sym] = (code, cur_len)
        next_len = items[i + 1][1] if i + 1 < len(items) else cur_len
        code = (code + 1) << (next_len - cur_len)
        cur_len = next_len
    return table


def llhuff_encode(data: np.ndarray,
                  table: dict[int, tuple[int, int]] | None = None,
                  device: str | None = None) -> tuple[bytes, dict[int, int]]:
    """Encode to the raw cuhd unit stream (bit-identical to
    `encode_memory` given the same table).

    Returns (unit stream bytes — little-endian u32 units as the demo
    writes raw memory, lengths dict for the decoder).
    """
    dev = resolve(device)
    data = np.asarray(data, np.uint8)
    if table is None:
        lengths = llhuff_symbol_lengths(data)
        table = llhuff_encoder_table(lengths)
    else:
        lengths = {s: ln for s, (_, ln) in table.items()}
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    for s, (c, ln) in table.items():
        codes[s] = c
        lens[s] = ln
    total_bits = int(lens[data].sum())
    # ceil to bytes then to units (get_encoder_table:167-180)
    n_units = -(-((total_bits + 7) // 8) // 4)
    idx = torch.from_numpy(data.astype(np.int64)).to(dev)
    words, tb = pack_bits(torch.from_numpy(codes).to(dev)[idx],
                          torch.from_numpy(lens).to(dev)[idx],
                          max(1, n_units))
    if int(tb) != total_bits:
        raise RuntimeError("llhuff_encode: packed bit count mismatch")
    units = words[:n_units].cpu().numpy().astype("<u4")
    return units.tobytes(), lengths


def cuhd_decode(stream: bytes, lengths: dict[int, int], n_out: int,
                device: str | None = None) -> np.ndarray:
    """Decode a raw cuhd unit stream given the (symbol -> length) table,
    self-synchronising, with the demo's 128-bit subsequences
    (`cuhd_gpu_decoder.cu:422-520`)."""
    dev = resolve(device)
    table = llhuff_encoder_table(lengths)
    # the flat 2^11 LUT from the reference's canonical codes
    lut_sym = np.zeros(1 << MAX_CODEWORD_LENGTH, np.int64)
    lut_len = np.zeros(1 << MAX_CODEWORD_LENGTH, np.int64)
    for s, (c, ln) in table.items():
        shift = MAX_CODEWORD_LENGTH - ln
        lo = c << shift
        lut_sym[lo: lo + (1 << shift)] = s
        lut_len[lo: lo + (1 << shift)] = ln
    words = np.frombuffer(stream, "<u4").astype(np.int64)
    out, _ = huffman_decode(
        torch.from_numpy(words).to(dev), words.shape[0] * 32, n_out,
        torch.from_numpy(lut_sym), torch.from_numpy(lut_len),
        MAX_CODEWORD_LENGTH, sub_bits=SUBSEQ_UNITS * 32)
    return out[:n_out].cpu().numpy()


def compress_file(src: str, dst: str, device: str | None = None
                  ) -> dict[int, int]:
    """Demo-equivalent: read file, write raw compressed units; returns
    the lengths table (store it with `save_table`)."""
    data = np.fromfile(src, np.uint8)
    stream, lengths = llhuff_encode(data, device=device)
    with open(dst, "wb") as f:
        f.write(stream)
    return lengths


def save_table(lengths: dict[int, int], path: str) -> None:
    """256-byte sidecar: per-symbol code length (0 = absent)."""
    arr = np.zeros(256, np.uint8)
    for s, ln in lengths.items():
        arr[s] = ln
    arr.tofile(path)


def load_table(path: str) -> dict[int, int]:
    arr = np.fromfile(path, np.uint8)
    return {int(s): int(arr[s]) for s in np.flatnonzero(arr)}


def decompress_file(src: str, table_path: str, n_out: int, dst: str,
                    device: str | None = None) -> None:
    lengths = load_table(table_path)
    with open(src, "rb") as f:
        stream = f.read()
    out = cuhd_decode(stream, lengths, n_out, device=device)
    out.astype(np.uint8).tofile(dst)
