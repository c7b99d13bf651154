"""The port's LZP library (its own build of `tpulc_torch/gold/lzp.c`)
against tpulc's `gold.lzp` on the same bytes: equal streams, equal
`None` answers, and a round trip through the port's decoder.  The
decoder keeps its context in a register, so it is also held to tpulc's
on streams that reach each of its paths (checked by a Python walk of
the stream) and on mutated and truncated streams."""

import re

import numpy as np
import pytest
import torch

from tpulc.gold import lzp as tlzp
from tpulc_torch.gold import build
from tpulc_torch.gold import lzp as plzp

torch.set_num_threads(1)


def _pg(n=None):
    with open("tests/data/pg1661.txt", "rb") as f:
        raw = f.read()
    return raw * 2 if n is None else raw[:n]


def _inputs():
    rng = np.random.default_rng(7)
    return {
        "pg1661x2": _pg(),
        "random": rng.integers(0, 256, 50000).astype(np.uint8).tobytes(),
        "escapes": (b"\xf2" * 300 + _pg(20000)) * 2,
        "tiny": _pg(63),
        "ctx": _pg(64),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_lzp_equals_tpulc_and_round_trips(name):
    data = _inputs()[name]
    ours, theirs = plzp.lzp_encode(data), tlzp.lzp_encode(data)
    assert ours == theirs
    if len(data) < 64:
        assert ours is None
    if ours is not None:
        assert len(ours) < len(data)
        assert plzp.lzp_decode(ours, len(data)) == data
        assert plzp.lzp_decode(np.frombuffer(ours, np.uint8),
                               len(data)) == data


def test_lzp_decode_rejects_a_short_stream():
    with pytest.raises(ValueError):
        plzp.lzp_decode(b"abc", 100)


def test_lzp_library_is_built_from_the_port_sources():
    plzp._load()
    assert build.so_path(plzp._SRC).startswith(build._BUILD)
    assert "tpulc_torch" in plzp._SRC and "libtpulc_gold" not in plzp._SRC


ESC = 0xF2
TOKEN = re.compile(rb"[A-Za-z0-9']+[^A-Za-z0-9']*")


def _walk(stream, hash_bits=plzp.DEFAULT_HASH_BITS,
          min_len=plzp.DEFAULT_MIN_LEN):
    """A plain Python decode of a valid stream, and the set of paths it
    took: `overlap` (a match's source runs into its destination),
    `varint` (a length of more than one byte), `ends_on_match` (the
    stream's last step is a match) and `escape_after_match` (an escaped
    0xF2 literal at the step right after a match)."""
    out = bytearray(stream[:8])
    table, events, after_match, i = {}, set(), False, 8
    while i < len(stream):
        x = int.from_bytes(out[-8:], "little")
        h = ((x * 0x9E3779B97F4A7C15) & (2 ** 64 - 1)) >> (64 - hash_bits)
        q, p = table.get(h, -1), len(out)
        table[h] = p
        c = stream[i]
        i += 1
        if q >= 0 and c == ESC:
            b, i, nbytes = stream[i], i + 1, 1
            if b == 0:
                out.append(ESC)
                if after_match:
                    events.add("escape_after_match")
                after_match = False
                continue
            v = shift = 0
            while b & 0x80:
                v |= (b & 0x7F) << shift
                shift += 7
                b, i, nbytes = stream[i], i + 1, nbytes + 1
            v |= b << shift
            n = v - 1 + min_len
            if q + n > p:
                events.add("overlap")
            if nbytes > 1:
                events.add("varint")
            for k in range(n):
                out.append(out[q + k])
            after_match = True
            if i == len(stream):
                events.add("ends_on_match")
            continue
        out.append(c)
        after_match = False
    return bytes(out), events


def _letters(rng, n):
    return rng.integers(ord("a"), ord("z") + 1, n).astype(np.uint8).tobytes()


def _word_draw(size, seed):
    """`size` bytes of pg1661's tokens, each drawn as often as it occurs."""
    tokens = TOKEN.findall(_pg())
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < size:
        for k in rng.integers(len(tokens), size=size // 4):
            out.append(tokens[k])
            n += len(tokens[k])
    return b"".join(out)[:size]


def _decode_cases():
    """name -> (data, path the stream must take or None)."""
    rng = np.random.default_rng(22)
    period, tail = b"0123456789", _pg(3000)
    prefix, body = _letters(rng, 8), _letters(rng, 200)
    return {
        # a period of 10 < the match: each copied byte was just written
        "overlap": (_pg(1000) + period * 40 + tail, "overlap"),
        "ends_on_match": (_pg(4000) * 2, "ends_on_match"),
        # 4,000 bytes again: a length of 4,000 - 32 + 1 needs 2 bytes
        "varint": (_pg(4000) + b"#" + _pg(4000) + tail, "varint"),
        # the byte after the match is predicted ("x") but is 0xF2
        "escape_after_match": (tail + prefix + body + b"x" + tail[:500]
                               + prefix + body + b"\xf2" + tail[500:],
                               "escape_after_match"),
        "words_1mib": (_word_draw(1 << 20, 1661), None),
    }


def _both(stream, cap):
    """Each decoder's bytes, or ValueError where it raises."""
    got = []
    for mod in (plzp, tlzp):
        try:
            got.append(mod.lzp_decode(stream, cap))
        except ValueError:
            got.append(ValueError)
    return got


@pytest.mark.parametrize("name", list(_decode_cases()))
def test_lzp_decode_equals_tpulc(name):
    data, path = _decode_cases()[name]
    stream = tlzp.lzp_encode(data)
    assert stream is not None and len(stream) < len(data)
    if path is not None:
        walked, events = _walk(stream)
        assert walked == data and path in events
    ours, theirs = _both(stream, len(data))
    assert ours == theirs == data


@pytest.mark.parametrize("n", [0, 1, 7, 8])
def test_lzp_decode_of_a_context_alone(n):
    """A stream of 8 bytes is its own output; a shorter one raises."""
    stream, cap = _pg(n), 64
    ours, theirs = _both(stream, cap)
    assert ours == theirs
    assert ours == (stream if n == 8 else ValueError)


def _mutated(kind, k, base):
    rng = np.random.default_rng([22, k, len(kind)])
    s = bytearray(base)
    escapes = np.flatnonzero(np.frombuffer(base, np.uint8) == ESC)
    if kind == "truncate":
        return bytes(s[:int(rng.integers(0, len(s)))])
    # half the edits land on or just after an escape byte
    if k % 2 and escapes.size:
        at = int(rng.choice(escapes)) + int(rng.integers(0, 4))
    else:
        at = int(rng.integers(0, len(s)))
    at = min(at, len(s) - 1)
    if kind == "overwrite":
        s[at] = int(rng.integers(0, 256))
    elif kind == "insert":
        s[at:at] = bytes([ESC, int(rng.integers(0, 256))])
    else:
        del s[at:at + int(rng.integers(1, 4))]
    return bytes(s)


@pytest.mark.parametrize("kind", ["overwrite", "insert", "delete",
                                  "truncate"])
def test_lzp_decode_of_a_damaged_stream_equals_tpulc(kind):
    """50 seeded damaged streams a kind: the port returns tpulc's bytes
    or raises ValueError where tpulc does, through every `fail` exit."""
    data = (_pg(6000) + b"\xf2" * 40 + _pg(6000)) * 3
    base = tlzp.lzp_encode(data)
    assert base is not None and base.count(ESC) > 10
    outcomes = set()
    for k in range(50):
        ours, theirs = _both(_mutated(kind, k, base), len(data))
        assert ours == theirs, (kind, k)
        outcomes.add(ours is ValueError)
    assert outcomes == {True, False} or kind == "truncate"
