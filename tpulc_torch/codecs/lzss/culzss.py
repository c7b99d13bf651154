"""CULZSS packet-format LZSS codec (port of `tpulc/codecs/lzss/culzss.py`;
the same packets).

Format (the reference decoder, `gpu_decompress.cu:120-244`): each
4096-byte packet is independent, with its own 128-byte ring window
initialised to spaces; a packet is a flag byte per 8 tokens (LSB first,
bit set = literal), a literal is 1 byte and a match 2, (length, ring
offset), copying from the window as it stood before the token.

Encode, a packet a row, in groups of `ENCODE_GROUP` packets:

  1. the match search (`culzss_match`): at each byte i and distance d
     in 1..128, the run of x[i + k] == x[i + k - d] from k = 0 (x after
     tpulc's 128 leading spaces, zeros past the packet), capped at 32:
     tpulc's arithmetic (five int8 doubling steps), so no match is
     longer than 32 bytes even though the length byte allows 127
     (`MAX_LEN`); the match at i is min(run, d, 127), the longest over
     d with the nearest distance winning ties.  On the card it is one
     hand kernel (`csrc/culzss_match.cu`); the plain version
     (`culzss_match_plain`, the CPU's) builds the equality rows by one
     broadcast compare of each packet against an `unfold` of itself
     (tpulc: 128 concatenates), [packets, 128, 4,128] int8 (0.54 GB a
     group of 1,024), runs the doubling steps and takes `max`, which
     returns the first maximum;
  2. the match is clamped to the packet's remainder; the greedy parse
     is the orbit of 0 under i -> i + token length
     (`orbit_flags_batched`);
  3. tokens and flag bytes scatter to prefix-summed byte offsets.

Decode, a packet a row: a flag byte's value alone fixes its group's
span (17 - popcount), so group starts are an orbit too; they are
compacted by a cumsum scatter (tpulc sorts them), their [G, 8] token
grid is read at once, records land at output positions from two prefix
sums, and the copy sources resolve by pointer doubling to a fixpoint
(at most 13 rounds, one host check a round, counted in
`culzss_decode_block.rounds` and, while the timer is on, in the total
`#culzss_rounds`).  A zero-length match, where tpulc lets two records
race for one slot, raises ValueError.  Each group of packets, encoded
or decoded, is a `culzss.group` span whose block index is its first
packet.
"""

from __future__ import annotations

import torch

from tpulc_torch import cuda_lib
from tpulc_torch.primitives.parallel import orbit_flags_batched
from tpulc_torch.utils import timing

PCKT = 4096
WIN = 128
MAX_LEN = 127          # length byte; the reference clamps to MAX_CODED-1
MIN_MATCH = 3
CAP_OUT = PCKT + PCKT // 8 + 8     # a packet's encoded bytes, at most
_DOUBLINGS = 5                     # tpulc's int8 steps: runs cap at 32
# columns of the equality rows: a run read at the packet's last byte
# looks 2^5 - 1 bytes on, into the zero padding (tpulc's rows run to
# WIN + PCKT + MAX_LEN + 8 = 4,359 columns; no run read reaches them)
_SPAN = PCKT + (1 << _DOUBLINGS)
_GROUPS = PCKT // 8 + 2
_ROUNDS = 13                       # ceil(log2(PCKT + WIN))
ENCODE_GROUP = 1024                # packets a pass (~0.54 GB an int8 row set)
DECODE_GROUP = 4096


def culzss_match_plain(packets: torch.Tensor):
    """uint8[G, PCKT] -> (best_len, best_i), both uint8[G, PCKT]: at
    each byte, the longest min(run, d, 127) over the distances d and
    d - 1 of the nearest d that gives it (module docstring, step 1).
    Row d - 1, column c of the int8 rows L holds min(32, the run of
    x[c + k] == x[c + k - d] from k = 0)."""
    G = packets.shape[0]
    with timing.stage("culzss.candidates"):
        padded = torch.zeros((G, WIN + _SPAN), dtype=torch.uint8,
                             device=packets.device)
        padded[:, :WIN] = 32
        padded[:, WIN: WIN + PCKT] = packets
        rows = padded.unfold(1, _SPAN, 1)   # row k: distance WIN - k
        eq = rows[:, :WIN] == rows[:, WIN:]
        L = torch.flip(eq.view(torch.int8), (1,))   # row d - 1
        del eq
    with timing.stage("culzss.doubling"):
        s = 1
        for _ in range(_DOUBLINGS):
            L[..., :-s] += L[..., s:] * (L[..., :-s] == s)
            s *= 2
        dcol = torch.arange(1, WIN + 1, device=packets.device).clamp(
            max=MAX_LEN).to(torch.int8)[:, None]
        best_len, best_i = torch.minimum(L[..., :PCKT], dcol).max(dim=1)
        del L
    return best_len.to(torch.uint8), best_i.to(torch.uint8)


def culzss_match(packets: torch.Tensor):
    """Kernel wrapper (see `culzss_match_plain`).  Given a CPU tensor it
    runs the plain version; given a CUDA tensor it launches
    `csrc/culzss_match.cu` inside the stage `culzss.doubling` (and adds
    one to `launches`) or raises: it never falls back."""
    cuda_lib.check_tensor("packets", packets, torch.uint8, (None, PCKT))
    dev = cuda_lib.device_of(packets)
    if dev.type == "cpu":
        return culzss_match_plain(packets)
    lib = cuda_lib.library()
    with timing.stage("culzss.doubling"):
        best_len = torch.empty_like(packets)
        best_i = torch.empty_like(packets)
        with torch.cuda.device(dev):
            cuda_lib.check(lib.tplc_culzss_match(
                packets.data_ptr(), best_len.data_ptr(), best_i.data_ptr(),
                packets.shape[0], cuda_lib.stream_of(packets)),
                "culzss_match")
    culzss_match.launches += 1
    return best_len, best_i


culzss_match.launches = 0


def _encode_group(packets: torch.Tensor):
    """uint8[G, PCKT] -> (bytes uint8[G, CAP_OUT], nbytes int64[G],
    ntokens int64[G]): tpulc's `_encode_packet` a row."""
    G = packets.shape[0]
    dev = packets.device
    best_len, best_i = culzss_match(packets)
    with timing.stage("culzss.parse"):
        i = torch.arange(PCKT, device=dev)
        best_len = torch.minimum(best_len.to(torch.int64), PCKT - i)
        src = (i + WIN - 1 - best_i) % WIN          # (pos - d) % WIN
        is_match = best_len >= MIN_MATCH
        jump = (i + torch.where(is_match, best_len, 1)).clamp(max=PCKT)
        jump_e = torch.cat([jump, jump.new_full((G, 1), PCKT)], dim=1)
        is_start = orbit_flags_batched(jump_e, PCKT, PCKT)
    with timing.stage("culzss.pack"):
        start = is_start.to(torch.int64)
        tok_bytes = torch.where(is_start, torch.where(is_match, 2, 1), 0)
        tok_idx = torch.cumsum(start, 1) - start
        group = tok_idx >> 3
        byte_off = torch.cumsum(tok_bytes, 1) - tok_bytes + group + 1
        ntokens = start.sum(1)
        total = tok_bytes.sum(1) + ((ntokens + 7) >> 3)
        trash = CAP_OUT
        out = torch.zeros((G, CAP_OUT + 1), dtype=torch.uint8, device=dev)
        lit = is_start & ~is_match
        mt = is_start & is_match
        out.scatter_(1, torch.where(lit, byte_off, trash), packets)
        out.scatter_(1, torch.where(mt, byte_off, trash),
                     best_len.to(torch.uint8))
        out.scatter_(1, torch.where(mt, byte_off + 1, trash),
                     src.to(torch.uint8))
        flag_bit = torch.where(lit, 1 << (tok_idx & 7), 0)
        flags = torch.zeros((G, _GROUPS), dtype=torch.int64, device=dev)
        flags.scatter_add_(1, torch.where(is_start, group, _GROUPS - 1),
                           flag_bit)
        first = is_start & ((tok_idx & 7) == 0)
        out.scatter_(1, torch.where(first, byte_off - 1, trash),
                     torch.gather(flags, 1, group).to(torch.uint8))
    return out[:, :CAP_OUT], total, ntokens


def culzss_encode_block(block: torch.Tensor):
    """uint8[N] (N a multiple of PCKT) -> (packet bytes uint8[P,
    CAP_OUT], sizes int64[P], ntokens int64[P]), P = N / PCKT, encoded
    `ENCODE_GROUP` packets at a time on the block's device."""
    packets = block.reshape(-1, PCKT)
    parts = []
    for g in range(0, packets.shape[0], ENCODE_GROUP):
        timing.next_block(g)
        with timing.stage("culzss.group"):
            parts.append(_encode_group(packets[g: g + ENCODE_GROUP]))
    return tuple(torch.cat(x) for x in zip(*parts))


_POPCOUNT = [bin(v).count("1") for v in range(256)]


def _decode_records(pbuf: torch.Tensor, psizes: torch.Tensor):
    """tpulc's `_decode_packet_records` a row: uint8[P, capb], int[P] ->
    (rec int64[P, PCKT+1] = is_lit<<16 | b1<<8 | b0 at each token's
    output position, start bool[P, PCKT+1], out_len int64[P],
    zero_len bool[P]: a match token of length 0)."""
    P, capb = pbuf.shape
    dev = pbuf.device
    idx = torch.arange(capb, device=dev)
    f = pbuf.to(torch.int64)
    ones = timing.upload(torch.tensor(_POPCOUNT), dev)[f]
    live = idx < psizes[:, None]
    # group-start chain: a group spans >= 9 bytes, so the orbit has at
    # most capb // 9 + 1 entries; positions past psize are dead ends
    jump = torch.where(live, idx + 17 - ones, capb).clamp(max=capb)
    jump_e = torch.cat([jump, jump.new_full((P, 1), capb)], dim=1)
    G = capb // 9 + 2
    is_grp = orbit_flags_batched(jump_e, capb, G) & live
    # compact the group starts in order (tpulc: a sort of the keys)
    rank = torch.cumsum(is_grp, 1) - 1
    gpos = torch.full((P, G + 1), capb, dtype=torch.int64, device=dev)
    gpos.scatter_(1, torch.where(is_grp, rank, G), idx.expand(P, capb))
    gpos = gpos[:, :G]
    g_ok = gpos < capb
    gposc = gpos.clamp(max=capb - 1)
    fg = torch.gather(f, 1, gposc)
    fk = (fg[..., None] >> torch.arange(8, device=dev)) & 1     # [P, G, 8]
    sz = 2 - fk
    t = gposc[..., None] + 1 + torch.cumsum(sz, 2) - sz          # token starts
    exists = g_ok[..., None] & (t + sz <= psizes[:, None, None])
    tc = t.clamp(max=capb - 2).reshape(P, -1)
    b0 = torch.gather(f, 1, tc).reshape(P, G, 8)
    b1 = torch.gather(f, 1, tc + 1).reshape(P, G, 8)
    out_b = torch.where(exists, torch.where(fk == 1, 1, b0), 0)
    grp_out = out_b.sum(2)
    outpos = ((torch.cumsum(grp_out, 1) - grp_out)[..., None]
              + torch.cumsum(out_b, 2) - out_b)
    code = (fk << 16) | (b1 << 8) | b0
    cap = PCKT + 1
    tgt = torch.where(exists, outpos.clamp(max=PCKT), cap).reshape(P, -1)
    rec = torch.zeros((P, cap + 1), dtype=torch.int64, device=dev)
    rec.scatter_(1, tgt, code.reshape(P, -1))
    start = torch.zeros((P, cap + 1), dtype=torch.bool, device=dev)
    start.scatter_(1, tgt, True)
    zero_len = (exists & (fk == 0) & (b0 == 0)).flatten(1).any(1)
    return rec[:, :cap], start[:, :cap], grp_out.sum(1), zero_len


def _decode_group(pbuf: torch.Tensor, psizes: torch.Tensor):
    """uint8[P, capb], int[P] -> (uint8[P, PCKT], out_len int64[P])."""
    with timing.stage("culzss.records"):
        rec, start, outl, zero_len = _decode_records(
            pbuf, psizes.to(torch.int64))
        if timing.wait(bool, zero_len.any()):
            raise ValueError("corrupt culzss packet: a zero-length match")
        P = pbuf.shape[0]
        dev = pbuf.device
        idx = torch.arange(PCKT, device=dev)[None, :]
        tok_start = torch.cummax(
            torch.where(start[:, :PCKT], idx, -1), dim=1).values.clamp(min=0)
        code = torch.gather(rec[:, :PCKT], 1, tok_start)
        is_lit = ((code >> 16) & 1) == 1
        b0 = code & 0xFF
        off = (code >> 8) & 0xFF
        # byte j of a match reads ring slot (off + j) % WIN as it stood
        # at the token's start: the latest earlier position in that slot
        w = (off + idx - tok_start) % WIN
        p_pad = tok_start + WIN
        q = p_pad - 1 - ((p_pad - 1 - w) % WIN)
        valid = idx < outl[:, None]
        lit = is_lit & valid
        val = torch.cat([
            torch.full((P, WIN), 32, dtype=torch.uint8, device=dev),
            torch.where(lit, b0, 32).to(torch.uint8)], dim=1)
        src = torch.cat([
            torch.arange(WIN, device=dev).expand(P, WIN),
            torch.where(~is_lit & valid, q, idx + WIN)], dim=1)
    with timing.stage("culzss.rounds"):
        rounds = 0
        for _ in range(_ROUNDS):
            nxt = torch.gather(src, 1, src)
            rounds += 1
            if timing.wait(torch.equal, nxt, src, nbytes=1):
                break
            src = nxt
        out = torch.gather(val, 1, src)[:, WIN:]
    culzss_decode_block.rounds += rounds
    if timing.counting():
        timing.add_totals(("#culzss_rounds",), (rounds,))
    return out, outl


def culzss_decode_block(pbuf: torch.Tensor, psizes: torch.Tensor):
    """pbuf uint8[P, cap], psizes int[P] -> (uint8[P, PCKT] decoded,
    out_len int64[P]), `DECODE_GROUP` packets at a time; missing bytes
    read as spaces, as in tpulc.  Raises ValueError on a zero-length
    match."""
    G = DECODE_GROUP
    parts = []
    for g in range(0, pbuf.shape[0], G):
        timing.next_block(g)
        with timing.stage("culzss.group"):
            parts.append(_decode_group(pbuf[g: g + G], psizes[g: g + G]))
    if not parts:
        return (torch.zeros((0, PCKT), dtype=torch.uint8, device=pbuf.device),
                torch.zeros(0, dtype=torch.int64, device=pbuf.device))
    return tuple(torch.cat(x) for x in zip(*parts))


culzss_decode_block.rounds = 0
