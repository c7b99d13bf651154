"""The port's LZP library (its own build of `tpulc_torch/gold/lzp.c`)
against tpulc's `gold.lzp` on the same bytes: equal streams, equal
`None` answers, and a round trip through the port's decoder.  The
encoder decides most steps from a fingerprint kept in its table entry
and compares 8 bytes at a time, so its cases reach each side of that
test (checked by a Python walk of the stream) at every `min_len` and
at several table sizes, and its counters are pinned.  The decoder keeps
its context in a register, so it is also held to tpulc's on streams
that reach each of its paths and on mutated and truncated streams."""

import functools
import re
import sys
import threading

import numpy as np
import pytest
import torch

from tpulc.gold import lzp as tlzp
from tpulc_torch.gold import build
from tpulc_torch.gold import lzp as plzp
from tpulc_torch.utils import timing

torch.set_num_threads(1)

HASH_BITS, MIN_LEN = plzp.DEFAULT_HASH_BITS, plzp.DEFAULT_MIN_LEN


def _pg(n=None):
    with open("tests/data/pg1661.txt", "rb") as f:
        raw = f.read()
    return raw * 2 if n is None else raw[:n]


def _probe(ref, probe, end=b"%"):
    """Letters in which one 8-byte context is followed first by `ref`
    (then "#") and later by `probe` (then `end`), after a 400-byte
    stretch said twice, a match that makes the stream shrink:
    (data, where the probe starts)."""
    rng = np.random.default_rng(26)
    ctx, pad = _letters(rng, 8), _letters(rng, 400)
    head = (_letters(rng, 100) + pad + pad + b"#" + _letters(rng, 100)
            + ctx + ref + b"#" + _letters(rng, 100) + ctx)
    return head + probe + end, len(head)


def _ref(n):
    return _letters(np.random.default_rng([26, n]), n)


def _changed(data, k):
    """`data` with its byte k replaced by another letter."""
    return data[:k] + bytes([(data[k] - 97 + 1) % 26 + 97]) + data[k + 1:]


def _with_bytes(case, k, b):
    """A probe case with bytes k... replaced by `b` (before the probe)."""
    data, at = case
    assert k + len(b) <= at
    return data[:k] + b + data[k + len(b):], at


def _mix():
    """Short word repeats, a 6,000-byte repeat and a run of 0xF2."""
    return _word_draw(1 << 16, 26) + (_pg(6000) + b"\xf2" * 40) * 2


def _rotated_tile():
    """pg1661 rotated and tiled twice, as the `pg-x6` traffic makes it."""
    return np.roll(np.frombuffer(_pg(), np.uint8), -123_457).tobytes()


def _at(length, event=None):
    """A check of a walked stream: the probe's step is a match of
    `length` bytes (None: its step is no match), and the walk took
    `event`'s path."""
    return lambda events, matches, at: (dict(matches).get(at) == length
                                        and event in events | {None})


def _inputs():
    """name -> (bytes or a probe case, hash_bits, min_len, check of the
    walked stream or None)."""
    rng = np.random.default_rng(7)
    ml = MIN_LEN
    cases = {
        "pg1661x2": (_pg(), HASH_BITS, ml, None),
        "random": (rng.integers(0, 256, 50000).astype(np.uint8).tobytes(),
                   HASH_BITS, ml, None),
        "escapes": ((b"\xf2" * 300 + _pg(20000)) * 2, HASH_BITS, ml, None),
        "tiny": (_pg(63), HASH_BITS, ml, None),
        "ctx": (_pg(64), HASH_BITS, ml, None),
    }
    # a match of exactly min_len - 1, min_len, min_len + 1 and 70,000
    for k in (ml - 1, ml, ml + 1):
        cases[f"match_{k}"] = (lambda k=k: _probe(_ref(80), _ref(80)[:k]),
                               HASH_BITS, ml, _at(k if k >= ml else None))
    cases["match_70000"] = (
        lambda: _probe(_ref(70_000), _ref(70_000)), HASH_BITS, ml,
        lambda events, matches, at: max(n for _, n in matches) >= 1 << 16)
    # the last match runs to the block's last byte; the last probe's
    # window crosses the end (p + min_len > n) or ends on it
    cases["match_to_the_end"] = (lambda: _probe(_ref(50), _ref(50), b""),
                                 HASH_BITS, ml, _at(50, "ends_on_match"))
    for k in (20, ml - 1, ml):
        cases[f"window_{k}_before_the_end"] = (
            lambda k=k: _probe(_ref(50), _ref(50)[:k], b""), HASH_BITS, ml,
            _at(k if k >= ml else None))
    # a reference that differs only in the tail the fingerprint reads
    # (min_len - 4 ... min_len - 1), or only before it
    for k in (ml - 4, ml - 1, 0, ml - 5):
        where = "tail" if k >= ml - 4 else "head"
        cases[f"differs_at_{k}_{where}"] = (
            lambda k=k: _probe(_ref(ml + 4), _changed(_ref(ml + 4), k)),
            HASH_BITS, ml, _at(None))
    # the first step's tail hashes to an all-ones fingerprint, which an
    # empty entry's bits pass: the entry is still no prediction
    cases["empty_entry_passes_the_fingerprint"] = (
        lambda: _with_bytes(_probe(_ref(80), _ref(80)[:40]), 8 + ml - 4,
                            (0xF174D0AF).to_bytes(4, "little")),
        HASH_BITS, ml, _at(40))
    # every min_len (below 4 the plain compare), then small tables
    for m in (1, 3, 4, 5, 31, 32, 33, 64):
        cases[f"min_len_{m}"] = (_mix, HASH_BITS, m, None)
    cases["min_len_5_tail"] = (lambda: _probe(_ref(9), _changed(_ref(9), 1)),
                               HASH_BITS, 5, _at(None))
    for b in (8, 12, 20):  # 18 is every other case's
        cases[f"hash_bits_{b}"] = (_mix, b, ml, None)
    cases["escape_after_match"] = (
        lambda: _decode_cases()["escape_after_match"][0], HASH_BITS, ml,
        lambda events, matches, at: "escape_after_match" in events)
    cases["words_1mib"] = (lambda: _word_draw(1 << 20, 1661), HASH_BITS, ml,
                           None)
    cases["rotated_tile"] = (_rotated_tile, HASH_BITS, ml, None)
    return cases


def _case(name):
    """(data, hash_bits, min_len, check, where the probe starts)."""
    data, hash_bits, min_len, check = _inputs()[name]
    at = None
    if callable(data):
        data = data()
        if isinstance(data, tuple):
            data, at = data
    return data, hash_bits, min_len, check, at


@pytest.mark.parametrize("name", list(_inputs()))
def test_lzp_equals_tpulc_and_round_trips(name):
    data, hash_bits, min_len, check, at = _case(name)
    ours = plzp.lzp_encode(data, hash_bits, min_len)
    theirs = tlzp.lzp_encode(data, hash_bits, min_len)
    assert ours == theirs
    if len(data) < 64:
        assert ours is None
    if check is not None:
        assert ours is not None
    if ours is not None:
        assert len(ours) < len(data)
        assert plzp.lzp_decode(ours, len(data), hash_bits, min_len) == data
        assert plzp.lzp_decode(np.frombuffer(ours, np.uint8), len(data),
                               hash_bits, min_len) == data
    if check is not None:
        walked, events, walk = _walk(ours, hash_bits, min_len)
        assert walked == data and check(events, walk["matches"], at)


# pg1661 x 2's counters: steps, predicted, compared, matches
PG_COUNTS = (594016, 410130, 606, 18)


def _counts(data):
    timer = timing.enable()
    try:
        stream = plzp.lzp_encode(data)
    finally:
        timing.disable()
    totals = timer.trace()["totals"]
    return stream, tuple(int(totals[k]) for k in plzp.COUNTERS)


def test_lzp_encode_counters():
    """The counters of pg1661 x 2: steps, predicted steps and matches
    are the stream's own (a walk of it finds them), the compared steps
    lie between the matches and the predicted steps."""
    stream, counts = _counts(_pg())
    steps, predicted, checked, matches = counts
    _, _, walk = _walk(stream)
    assert (steps, predicted, matches) == (
        walk["steps"], walk["predicted"], len(walk["matches"]))
    assert matches <= checked <= predicted <= steps
    assert counts == PG_COUNTS
    # an encode that fails (random bytes do not shrink) counts its steps
    # up to the one that failed
    data = _inputs()["random"][0]
    stream, counts = _counts(data)
    steps, predicted, checked, matches = counts
    assert stream is None and 0 < steps <= len(data) - 8
    assert matches <= checked <= predicted <= steps


def test_lzp_encode_records_nothing_with_the_timer_off():
    timer = timing.enable()
    timing.disable()
    assert not timing.counting()
    assert plzp.lzp_encode(_pg()) == tlzp.lzp_encode(_pg())
    assert not any(k.startswith("#lzp") for k in timer.stages)
    assert timer.trace()["totals"] == {}


def test_lzp_counters_add_up_across_threads():
    """24 threads encode at once (bsc's batched path runs LZP in a
    pool): the totals are the sum of every call's counters."""
    data, calls, threads = _pg(20_000) * 2, 4, 24
    _, one = _counts(data)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    timer = timing.enable()
    try:
        pool = [threading.Thread(target=lambda: [plzp.lzp_encode(data)
                                                 for _ in range(calls)])
                for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        timing.disable()
        sys.setswitchinterval(switch)
    totals = timer.trace()["totals"]
    assert tuple(int(totals[k]) for k in plzp.COUNTERS) == tuple(
        calls * threads * c for c in one)


ESC = 0xF2
TOKEN = re.compile(rb"[A-Za-z0-9']+[^A-Za-z0-9']*")


def test_lzp_decode_rejects_a_short_stream():
    with pytest.raises(ValueError):
        plzp.lzp_decode(b"abc", 100)


def test_lzp_library_is_built_from_the_port_sources():
    plzp._load()
    assert build.so_path(plzp._SRC).startswith(build._BUILD)
    assert "tpulc_torch" in plzp._SRC and "libtpulc_gold" not in plzp._SRC


def _walk(stream, hash_bits=HASH_BITS, min_len=MIN_LEN):
    """A plain Python decode of a valid stream, the set of paths it
    took: `overlap` (a match's source runs into its destination),
    `varint` (a length of more than one byte), `ends_on_match` (the
    stream's last step is a match) and `escape_after_match` (an escaped
    0xF2 literal at the step right after a match), and its steps,
    predicted steps and matches (output position, length)."""
    out = bytearray(stream[:8])
    table, events, after_match, i = {}, set(), False, 8
    walk = {"steps": 0, "predicted": 0, "matches": []}
    while i < len(stream):
        x = int.from_bytes(out[-8:], "little")
        h = ((x * 0x9E3779B97F4A7C15) & (2 ** 64 - 1)) >> (64 - hash_bits)
        q, p = table.get(h, -1), len(out)
        table[h] = p
        walk["steps"] += 1
        walk["predicted"] += q >= 0
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
            walk["matches"].append((p, n))
            after_match = True
            if i == len(stream):
                events.add("ends_on_match")
            continue
        out.append(c)
        after_match = False
    return bytes(out), events, walk


def _letters(rng, n):
    return rng.integers(ord("a"), ord("z") + 1, n).astype(np.uint8).tobytes()


@functools.lru_cache(maxsize=None)
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
        walked, events, _ = _walk(stream)
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
