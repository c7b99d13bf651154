"""The port's coder-1 rANS (`tpulc_torch/codecs/bsclike/rans.py`)
against tpulc's `rans.py` on the same numpy inputs, all bit-equal: the
frequency normalisation (an empty histogram, a one-symbol context, a
drift that lands on a tie), the tables and the slot table, the
contexts, the batched encode (B = 1, 2, 3 blocks whose valid lengths
differ and are not multiples of 512) and decode, the one-block pair,
the zero-word stream and the word rows; the plain walks on
`test_torch_walk_cases.RANS_CASES` (straddling blocks, a lane of the
most words, an f = 1 tail with zero-frequency gaps).  The tables the
card kernels stage are held to their rules here: the encode's
reciprocals give the exact quotient, and the decode's slot index
(`decode_index`, the kernel's staging in numpy) gives tpulc's slot
table's symbol for every slot.  tpulc's loops run through JAX on the
CPU; each is called once a module (fixtures)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_walk_cases import RANS_CASES, rans_case, rans_tables

from tpulc.codecs.bsclike import driver as td
from tpulc.codecs.bsclike import rans as tr
from tpulc_torch.codecs.bsclike import rans as pr

torch.set_num_threads(1)

CAP = 2048
MS = (1999, 733, 1537)   # valid lengths of the three blocks


def _syms(seed: int, B: int) -> np.ndarray:
    """RLE2-like symbols: geometric ranks, zeros past each block's m."""
    rng = np.random.default_rng(seed)
    s = np.minimum(rng.geometric(0.3, size=(B, CAP)) - 1, 256).astype(
        np.int32)
    for b in range(B):
        s[b, MS[b]:] = 0
    return s


def _tables(syms: np.ndarray, ctx: np.ndarray):
    """tpulc's tables of each block -> (fq, cum) int32[B * NCTX, 257]."""
    fqs = []
    for b in range(syms.shape[0]):
        h = np.zeros((tr.NCTX, 257), np.int64)
        np.add.at(h, (ctx[b, : MS[b]], syms[b, : MS[b]]), 1)
        fqs.append(tr.normalize_freqs_ctx(h))
    fq = np.concatenate(fqs)
    cum = np.concatenate([np.zeros((fq.shape[0], 1), np.int32),
                          np.cumsum(fq, 1)[:, :-1].astype(np.int32)], 1)
    return fq, cum


@pytest.mark.parametrize("name", ["empty", "one_symbol", "tie", "random"])
def test_normalize_freqs_equals_tpulc(name):
    h = np.zeros(257, np.int64)
    if name == "one_symbol":
        h[5] = 1234        # f = 2^14: a symbol that never emits
    elif name == "tie":
        h[:3] = (3, 3, 1)  # drift 2 lands on the first of two maxima
    elif name == "random":
        h = np.random.default_rng(1).integers(0, 50, 257) * \
            (np.random.default_rng(2).random(257) < 0.3)
    got = pr.normalize_freqs(h)
    assert np.array_equal(got, tr.normalize_freqs(h))
    assert got.sum() == pr.PROB_SCALE
    if name == "tie":
        assert got[0] == got[1] + 2
    if name == "one_symbol":
        assert got[5] == pr.PROB_SCALE


def test_tables_and_slot_table_equal_tpulc():
    syms = _syms(4, 2)
    ctx = np.stack([np.asarray(tr.ctx_of_stream(jnp.asarray(s)))
                    for s in syms])
    fq, cum = _tables(syms, ctx)
    for a, b in zip(pr.build_tables_ctx(fq), tr.build_tables_ctx(fq)):
        assert np.array_equal(a, b)
    want = np.asarray(td._lut_from_freqs(jnp.asarray(fq), jnp.asarray(cum)))
    got = pr.slot_table(torch.from_numpy(fq), torch.from_numpy(cum))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy().astype(np.int32), want)
    assert np.array_equal(want, tr.build_tables_ctx(fq[:32])[2].tolist()
                          + tr.build_tables_ctx(fq[32:])[2].tolist())


def test_ctx_of_stream_equals_tpulc():
    s = _syms(5, 1)[0]
    got = pr.ctx_of_stream(torch.from_numpy(s)).numpy()
    assert np.array_equal(got, np.asarray(tr.ctx_of_stream(jnp.asarray(s))))
    a = np.arange(257, dtype=np.int32)
    assert np.array_equal(pr.ctx_class(torch.from_numpy(a)).numpy(),
                          np.asarray(tr.ctx_class(jnp.asarray(a))))


@pytest.fixture(scope="module", params=[1, 2, 3], ids=["B1", "B2", "B3"])
def batch(request):
    """B blocks through tpulc's batched encode, compaction, expansion
    and decode (each called once)."""
    B = request.param
    syms = _syms(10 + B, B)
    ctx = np.stack([np.asarray(tr.ctx_of_stream(jnp.asarray(s)))
                    for s in syms])
    fq, cum = _tables(syms, ctx)
    gctx = ctx + (np.arange(B, dtype=np.int32) * tr.NCTX)[:, None]
    ms = np.asarray(MS[:B], np.int32)
    w, c, s = (np.array(a) for a in tr.rans_encode_ctx_batch(
        jnp.asarray(syms), jnp.asarray(gctx), jnp.asarray(ms),
        jnp.asarray(fq), jnp.asarray(cum)))
    flat = np.array(tr.compact_words(jnp.asarray(w), jnp.asarray(c),
                                     1 << 16))[: int(c.sum())]
    rows = np.array(tr.expand_words(jnp.asarray(flat), jnp.asarray(c)))
    lut = np.asarray(td._lut_from_freqs(jnp.asarray(fq), jnp.asarray(cum)))
    fctx = gctx.reshape(-1, tr.CHUNK)[:, 0]
    states = np.random.default_rng(B).integers(0, 1 << 32, s.shape[0],
                                               dtype=np.uint64)
    out = {}
    for tag, st in (("true", s), ("hostile", states.astype(np.uint32))):
        out[tag] = np.asarray(tr.rans_decode_ctx_batch(
            jnp.asarray(rows), jnp.asarray(c), jnp.asarray(st),
            jnp.asarray(fctx), jnp.asarray(ms), jnp.asarray(fq),
            jnp.asarray(cum), jnp.asarray(lut), B))
    return dict(B=B, syms=syms, gctx=gctx, ms=ms, fq=fq, cum=cum,
                words=w, counts=c, states=s, flat=flat, rows=rows,
                fctx=fctx, hostile=states.astype(np.int64), dec=out)


def test_encode_batch_equals_tpulc(batch):
    w, c, s = pr.rans_encode_ctx_batch(
        torch.from_numpy(batch["syms"]), torch.from_numpy(batch["gctx"]),
        batch["ms"], torch.from_numpy(batch["fq"]),
        torch.from_numpy(batch["cum"]))
    assert np.array_equal(c.numpy(), batch["counts"])
    assert np.array_equal(s.numpy(), batch["states"].astype(np.int64))
    assert np.array_equal(w.numpy().view(np.uint16), batch["words"])
    assert int(c.sum()) > 0


def test_word_rows_equal_tpulc(batch):
    w = torch.from_numpy(batch["words"].view(np.int16))
    c = torch.from_numpy(batch["counts"].astype(np.int64))
    flat = pr.compact_words(w, c)
    assert np.array_equal(flat.numpy().view(np.uint16), batch["flat"])
    rows = pr.expand_words(flat, c)
    assert np.array_equal(rows.numpy().view(np.uint16), batch["rows"])


@pytest.mark.parametrize("states", ["true", "hostile"])
def test_decode_batch_equals_tpulc(batch, states):
    st = batch["states"].astype(np.int64) if states == "true" \
        else batch["hostile"]
    fq, cum = (torch.from_numpy(batch[k]) for k in ("fq", "cum"))
    got = pr.rans_decode_ctx_batch(
        torch.from_numpy(batch["rows"].view(np.int16)),
        torch.from_numpy(batch["counts"]), torch.from_numpy(st),
        torch.from_numpy(batch["fctx"]), batch["ms"], fq, cum,
        pr.slot_table(fq, cum), batch["B"])
    assert np.array_equal(got.numpy(), batch["dec"][states])
    if states == "true":
        for b, m in enumerate(batch["ms"]):
            assert np.array_equal(got[b, :m].numpy(), batch["syms"][b, :m])


def test_one_block_pair_equals_tpulc():
    syms = _syms(20, 1)
    ctx = np.array(tr.ctx_of_stream(jnp.asarray(syms[0])))
    fq, cum = _tables(syms, ctx[None])
    m = MS[0]
    w, c, s = (np.asarray(a) for a in tr.rans_encode_ctx(
        jnp.asarray(syms[0]), jnp.asarray(ctx), jnp.int32(m),
        jnp.asarray(fq), jnp.asarray(cum)))
    pw, pc, ps = pr.rans_encode_ctx(
        torch.from_numpy(syms[0]), torch.from_numpy(ctx), m,
        torch.from_numpy(fq), torch.from_numpy(cum))
    assert np.array_equal(pw.numpy().view(np.uint16), w)
    assert np.array_equal(pc.numpy(), c)
    assert np.array_equal(ps.numpy(), s.astype(np.int64))
    lut = tr.build_tables_ctx(fq)[2]
    fctx = ctx.reshape(-1, tr.CHUNK)[:, 0]
    want = np.asarray(tr.rans_decode_ctx_chained(
        jnp.asarray(w), jnp.asarray(c), jnp.asarray(s), jnp.asarray(fctx),
        jnp.int32(m), jnp.asarray(fq), jnp.asarray(cum), jnp.asarray(lut)))
    got = pr.rans_decode_ctx_chained(
        pw, pc, ps, torch.from_numpy(fctx), m, torch.from_numpy(fq),
        torch.from_numpy(cum), torch.from_numpy(lut.astype(np.int16)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want[:m], syms[0, :m])


def test_zero_word_stream_equals_tpulc():
    """Every context holds one symbol (f = 2^14): no lane emits a word,
    and the decode reads only the states."""
    syms = np.zeros((1, CAP), np.int32)
    ctx = np.zeros((1, CAP), np.int32)
    fq, cum = _tables(syms, ctx)
    m = 1500
    w, c, s = pr.rans_encode_ctx(torch.from_numpy(syms[0]),
                                 torch.from_numpy(ctx[0]), m,
                                 torch.from_numpy(fq), torch.from_numpy(cum))
    tw, tc, ts = (np.asarray(a) for a in tr.rans_encode_ctx(
        jnp.asarray(syms[0]), jnp.asarray(ctx[0]), jnp.int32(m),
        jnp.asarray(fq), jnp.asarray(cum)))
    assert int(c.sum()) == 0 and np.array_equal(c.numpy(), tc)
    assert np.array_equal(s.numpy(), ts.astype(np.int64))
    assert np.array_equal(w.numpy().view(np.uint16), tw)
    flat = pr.compact_words(w, c)
    assert flat.shape[0] == 0
    rows = pr.expand_words(flat, c)
    want = np.asarray(tr.expand_words(jnp.zeros(0, jnp.uint16),
                                      jnp.asarray(tc)))
    assert np.array_equal(rows.numpy().view(np.uint16), want)
    fqt, cumt = torch.from_numpy(fq), torch.from_numpy(cum)
    got = pr.rans_decode_ctx_chained(rows, c, s, torch.zeros(4, dtype=torch.int64),
                                     m, fqt, cumt, pr.slot_table(fqt, cumt))
    assert not got.any()


def test_rcp_table_gives_the_exact_quotient():
    """For every f in 0..2^14 (divisor max(f, 1)) and 32-bit x at the
    edges of each quotient and at random, the encode kernel's step,
    q = (x * rcp[f]) >> 32 and one correction, gives tpulc's (x // f) <<
    14 + x % f + c mod 2^32."""
    rcp = pr.rcp_table().astype(np.uint64)
    assert rcp.shape == (pr.PROB_SCALE + 1,) and rcp.dtype == np.uint64
    f = np.arange(pr.PROB_SCALE + 1, dtype=np.uint64)[:, None]
    fx = np.maximum(f, 1)
    top = np.uint64(pr.M32) // fx * fx
    rng = np.random.default_rng(5)
    x = np.concatenate([
        np.broadcast_to(np.array([0, 1, 2, pr.M32 - 1, pr.M32], np.uint64),
                        (f.shape[0], 5)),
        fx - 1, fx, fx + 1, 2 * fx - 1, top - 1, top, top - fx,
        np.minimum(top + fx - 1, pr.M32),
        rng.integers(0, 1 << 32, (f.shape[0], 24), dtype=np.uint64)], 1)
    c = rng.integers(0, pr.PROB_SCALE, x.shape, dtype=np.uint64)
    q = (x * rcp[:, None]) >> np.uint64(32)
    g = (np.uint64(pr.PROB_SCALE) - fx) & np.uint64(pr.M32)
    xe = (x + c + q * g) & np.uint64(pr.M32)
    short = ((x - q * fx) & np.uint64(pr.M32)) >= fx
    got = np.where(short, (xe + g) & np.uint64(pr.M32), xe)
    want = (((x // fx) << np.uint64(pr.PROB_BITS)) + x % fx + c) \
        & np.uint64(pr.M32)
    assert ((x // fx - q) <= 1).all()
    assert np.array_equal(got, want)


def decode_index(freq: np.ndarray, cum: np.ndarray):
    """One context's slot index as `csrc/rans_ctx.cu`'s decode kernel
    stages it: the present symbols (f > 0) in symbol order, a 32-bit
    mask a 32-slot bucket (bit r: a present symbol starts at slot 32 u
    + r) and the starts before each bucket -> (present, mask, first)."""
    present = np.flatnonzero(freq > 0)
    mask = np.zeros(pr.PROB_SCALE >> 5, np.uint64)
    for s in present:
        mask[cum[s] >> 5] |= np.uint64(1) << np.uint64(cum[s] & 31)
    pops = np.array([bin(int(m)).count("1") for m in mask])
    first = np.concatenate([[0], np.cumsum(pops)[:-1]])
    return present, mask, first


def _index_symbols(freq, cum):
    """The symbol of every slot through `decode_index`: present[first[u]
    + popc(mask[u] & bits 0..r) - 1] for slot 32 u + r."""
    present, mask, first = decode_index(freq, cum)
    slot = np.arange(pr.PROB_SCALE)
    low = (np.uint64(1) << (slot & 31).astype(np.uint64) + np.uint64(1)) \
        - np.uint64(1)
    bits = mask[slot >> 5] & low
    pop = np.array([bin(int(b)).count("1") for b in bits])
    return present[first[slot >> 5] + pop - 1]


@pytest.mark.parametrize("name", ["gaps", "one_symbol", "all257", "tail",
                                  "data"])
def test_decode_index_gives_the_slot_tables_symbol(name):
    """The decode kernel's staged index gives tpulc's slot table's
    symbol (`_lut_from_freqs`) for every slot of every table: zero-
    frequency gaps, one symbol at f = 2^14, all 257 symbols present
    (256 at f = 1), an f = 1 tail with gaps, and real order-2 tables."""
    if name == "data":
        syms = _syms(4, 1)
        ctx = np.asarray(tr.ctx_of_stream(jnp.asarray(syms[0])))[None]
        fq = _tables(syms, ctx)[0]
    else:
        f = np.zeros(257, np.int32)
        if name == "gaps":
            f[[0, 3, 4, 90, 200, 256]] = (9000, 1, 2000, 3000, 2382, 1)
        elif name == "one_symbol":
            f[77] = pr.PROB_SCALE
        else:
            f = rans_tables("flat1" if name == "all257" else "tail")
        fq = f[None]
    assert (fq.sum(1) == pr.PROB_SCALE).all()
    cum = np.concatenate([np.zeros((fq.shape[0], 1), np.int32),
                          np.cumsum(fq, 1)[:, :-1].astype(np.int32)], 1)
    want = np.asarray(td._lut_from_freqs(jnp.asarray(fq), jnp.asarray(cum)))
    want = want.reshape(fq.shape[0], pr.PROB_SCALE)
    for k in range(fq.shape[0]):
        got = _index_symbols(fq[k], cum[k])
        assert np.array_equal(got, want[k])
        assert (fq[k][got] > 0).all() and (cum[k][got] <= np.arange(
            pr.PROB_SCALE)).all()


@pytest.fixture(scope="module", params=RANS_CASES)
def walk_case(request):
    """A `rans_case` through tpulc's batched encode and decode (true and
    hostile states)."""
    syms, ms, fq = rans_case(request.param)
    B = syms.shape[0]
    ctx = np.stack([np.asarray(tr.ctx_of_stream(jnp.asarray(s)))
                    for s in syms])
    cum = np.concatenate([np.zeros((fq.shape[0], 1), np.int32),
                          np.cumsum(fq, 1)[:, :-1].astype(np.int32)], 1)
    gctx = ctx + (np.arange(B, dtype=np.int32) * tr.NCTX)[:, None]
    w, c, s = (np.array(a) for a in tr.rans_encode_ctx_batch(
        jnp.asarray(syms), jnp.asarray(gctx), jnp.asarray(ms),
        jnp.asarray(fq), jnp.asarray(cum)))
    lut = np.asarray(td._lut_from_freqs(jnp.asarray(fq), jnp.asarray(cum)))
    fctx = gctx.reshape(-1, tr.CHUNK)[:, 0]
    hostile = np.random.default_rng(9).integers(0, 1 << 32, s.shape[0],
                                                dtype=np.uint64)
    dec = {tag: np.asarray(tr.rans_decode_ctx_batch(
        jnp.asarray(w), jnp.asarray(c), jnp.asarray(st), jnp.asarray(fctx),
        jnp.asarray(ms), jnp.asarray(fq), jnp.asarray(cum), jnp.asarray(lut),
        B)) for tag, st in (("true", s), ("hostile",
                                          hostile.astype(np.uint32)))}
    return dict(name=request.param, B=B, syms=syms, gctx=gctx, ms=ms,
                fq=fq, cum=cum, words=w, counts=c, states=s, fctx=fctx,
                hostile=hostile.astype(np.int64), dec=dec)


def test_plain_encode_walk_equals_tpulc_on_the_cases(walk_case):
    k = walk_case
    w, c, s = pr.rans_encode_ctx_batch(
        torch.from_numpy(k["syms"]), torch.from_numpy(k["gctx"]), k["ms"],
        torch.from_numpy(k["fq"]), torch.from_numpy(k["cum"]))
    assert np.array_equal(c.numpy(), k["counts"])
    assert np.array_equal(s.numpy(), k["states"].astype(np.int64))
    assert np.array_equal(w.numpy().view(np.uint16), k["words"])
    if k["name"] == "full_lane":   # 14 bits a step: 448 words of 512
        assert int(c.max()) == 448


@pytest.mark.parametrize("states", ["true", "hostile"])
def test_plain_decode_walk_equals_tpulc_on_the_cases(walk_case, states):
    k = walk_case
    st = k["states"].astype(np.int64) if states == "true" else k["hostile"]
    fq, cum = (torch.from_numpy(k[n]) for n in ("fq", "cum"))
    got = pr.rans_decode_ctx_batch(
        torch.from_numpy(k["words"].view(np.int16)),
        torch.from_numpy(k["counts"]), torch.from_numpy(st),
        torch.from_numpy(k["fctx"].astype(np.int64)), k["ms"], fq, cum,
        pr.slot_table(fq, cum), k["B"])
    assert np.array_equal(got.numpy(), k["dec"][states])
    if states == "true":
        for b, m in enumerate(k["ms"]):
            assert np.array_equal(got[b, :m].numpy(), k["syms"][b, :m])
