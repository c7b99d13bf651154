"""Serial gold for the CULZSS packet format (a copy of
`tpulc/gold/culzss_gold.py`; format authority:
`cuda-lzss-cluster/gpu_decompress.cu:120-244`)."""

from __future__ import annotations


PCKT = 4096
WIN = 128


def decode_packet(pbytes: bytes) -> bytes:
    """Reference-semantics serial decode of one packet."""
    window = bytearray(b" " * WIN)
    out = bytearray()
    flags = 0
    flags_used = 8
    i = 0
    nxt = 0
    n = len(pbytes)
    while True:
        if flags_used == 8:
            if i >= n:
                break
            flags = pbytes[i]
            i += 1
            flags_used = 0
        if flags & 1:
            if i >= n:
                break
            c = pbytes[i]
            i += 1
            out.append(c)
            window[nxt] = c
            nxt = (nxt + 1) % WIN
        else:
            if i + 1 >= n:
                break
            length = pbytes[i]
            off = pbytes[i + 1]
            i += 2
            tmp = bytes(window[(off + k) % WIN] for k in range(length))
            out.extend(tmp)
            for k in range(length):
                window[(nxt + k) % WIN] = tmp[k]
            nxt = (nxt + length) % WIN
        flags >>= 1
        flags_used += 1
    return bytes(out)


def encode_packet(packet: bytes) -> bytes:
    """Simple serial encoder (greedy, full window scan) in the format."""
    window = bytearray(b" " * WIN)
    out = bytearray()
    group: list[bytes] = []
    flags = 0
    p = 0
    n = len(packet)
    nxt = 0

    def flush():
        nonlocal flags, group
        if group:
            out.append(flags)
            for g in group:
                out.extend(g)
        flags = 0
        group = []

    while p < n:
        best_len, best_off = 0, 0
        for off in range(WIN):
            l = 0
            while (
                l < 127
                and p + l < n
                and window[(off + l) % WIN] == packet[p + l]
            ):
                l += 1
            # snapshot semantics: source may not overlap bytes being
            # written, which the ring expresses as length <= distance
            # from off to the write head along the ring
            dist = (nxt - off) % WIN
            if dist:
                l = min(l, dist)
            if l > best_len:
                best_len, best_off = l, off
        if best_len >= 3:
            group.append(bytes([best_len, best_off]))
            consumed = best_len
        else:
            flags |= 1 << len(group)
            group.append(packet[p: p + 1])
            consumed = 1
        for k in range(consumed):
            window[nxt] = packet[p + k]
            nxt = (nxt + 1) % WIN
        p += consumed
        if len(group) == 8:
            flush()
    flush()
    return bytes(out)
