"""What the CUDA designs of K2 (the MTF encode walk), of the start
tables between K1 and K2 and of K1's tile maxima must get right, pinned
on the CPU: the plain versions (the card's arbiters) against scalar
references of the contracts, and against tpulc on the same inputs.

The start tables are held to the serial MTF from the identity, whose
table before each chunk is that chunk's start table; K2 to tpulc's
Pallas kernel in interpret mode on permutation tables, and to a scalar
walk on tables with duplicate entries, absent symbols and any int32.
On a duplicate entry tpulc's Pallas K2 and its XLA step disagree
(ROADMAP F5): the port keeps the first match, and a test pins both
answers.  Integers throughout: tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_walk_cases import (
    K2_CASES,
    START_CASES,
    k1_case,
    k2_case,
    k2_reference,
    start_case,
    start_reference,
)

from tpulc.primitives import mtf as jmtf
from tpulc.primitives import mtf_pallas
from tpulc_torch.primitives import mtf_kernels as mk
from tpulc_torch.primitives.mtf import mtf_decode, mtf_encode

torch.set_num_threads(1)


# -------------------------------------------------------- start tables

@pytest.mark.parametrize("nchunks", [1, 2, 3, 17, 64, 65])
@pytest.mark.parametrize("name", START_CASES)
def test_start_tables_plain_match_the_serial_mtf(name, nchunks):
    d, C = start_case(name, nchunks)
    rec = mk.mtf_recency(torch.from_numpy(d.astype(np.int32)))
    want = start_reference(d)
    got = mk.mtf_start_tables_plain(rec, C)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(mk.mtf_start_tables(rec, C), got)
    for tile in mk.START_TILES:   # from K1's tile maxima: the same tables
        rec_p, part, t = mk.mtf_recency(torch.from_numpy(d.astype(np.int32)),
                                        partials=True, tile=tile)
        assert torch.equal(rec_p, rec)
        assert torch.equal(mk.mtf_start_tables(rec, C, tile=t, part=part), got)


def _tpulc_start_tables(rec, C):
    """A transcription of tpulc's start-table stage, which tpulc writes
    inline in `mtf_encode` (`tpulc/primitives/mtf.py:85-96`, its XLA
    scan and argsort) and exports as no function: the same JAX
    operations on K1's rows, the exclusive `associative_scan(maximum)`
    of the recency over chunks, then the stable argsort of -key a row.
    tpulc's own code is held to the port's by
    `test_mtf_encode_matches_tpulc`."""
    r = jnp.asarray(rec.numpy())
    base = (jnp.arange(rec.shape[0], dtype=jnp.int32) * C)[:, None]
    recency = jnp.where(r >= 0, r + base, -1)
    incl = jax.lax.associative_scan(jnp.maximum, recency, axis=0)
    before = jnp.concatenate(
        [jnp.full((1, 256), -1, jnp.int32), incl[:-1]], axis=0)
    syms = jnp.arange(256, dtype=jnp.int32)[None, :]
    key = jnp.where(before >= 0, before, -2 - syms)
    return np.asarray(jnp.argsort(-key, axis=1, stable=True))


@pytest.mark.parametrize("nchunks", [1, 65, 259, 2101])
@pytest.mark.parametrize("name", START_CASES)
def test_start_tables_plain_equal_tpulcs_stage(name, nchunks):
    """The plain start tables (the card's arbiter) against the
    transcribed stage on the same K1 rows, at chunk counts across one, a
    few and hundreds of the kernel's tiles (1 to 263 tiles of 8): one
    tile, a prefix of a few tiles and one past the scanners' batch of
    256 tiles."""
    d, C = start_case(name, nchunks)
    rec = mk.mtf_recency(torch.from_numpy(d.astype(np.int32)))
    np.testing.assert_array_equal(mk.mtf_start_tables_plain(rec, C).numpy(),
                                  _tpulc_start_tables(rec, C))


@pytest.mark.parametrize("name", START_CASES)
def test_mtf_encode_matches_tpulc(name):
    """The whole forward path (K1, start tables, K2) on 17 chunks of
    128: tpulc's `mtf_encode` and its numpy gold."""
    d, _ = start_case(name, 17 if name != "all_symbols" else 9)
    data = d.reshape(-1)
    got = mtf_encode(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, jmtf.mtf_encode_np(data))
    np.testing.assert_array_equal(got, np.asarray(jmtf.mtf_encode(
        jnp.asarray(data))))
    np.testing.assert_array_equal(
        mtf_decode(torch.from_numpy(got)).numpy(), data)


@pytest.mark.parametrize("name", ["random", "one_run", "long_runs"])
def test_mtf_encode_matches_tpulc_on_k1_cases(name):
    """The forward path, K1 with its tile maxima included, on runs of
    one symbol a chunk and BWT-like runs: tpulc's `mtf_encode`."""
    data = k1_case(name, 37, 128).numpy().astype(np.uint8).reshape(-1)
    got = mtf_encode(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmtf.mtf_encode(
        jnp.asarray(data))))
    np.testing.assert_array_equal(got, jmtf.mtf_encode_np(data))


def test_start_tables_wrapper_checks_its_domain():
    """The CPU route is the plain version whatever `tile` and at chunks
    past the kernel's 4,096 (the card's limit is the C entry point's,
    tested on the card); int32 positions and the row shape hold on both
    routes."""
    d, C = start_case("text", 5)
    rec = mk.mtf_recency(torch.from_numpy(d.astype(np.int32)))
    want = mk.mtf_start_tables_plain(rec, C)
    for tile in (0, 8, 64, 12):
        assert torch.equal(mk.mtf_start_tables(rec, C, tile=tile), want)
    rng = np.random.default_rng(3)
    wide = rng.integers(0, 256, size=(3, 5000)).astype(np.int32)
    rec_w = mk.mtf_recency(torch.from_numpy(wide))
    np.testing.assert_array_equal(mk.mtf_start_tables(rec_w, 5000).numpy(),
                                  start_reference(wide))
    big = torch.empty((1 << 19, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        mk.mtf_start_tables(big, 4096)
    with pytest.raises(ValueError):
        mk.mtf_start_tables(rec.long(), C)
    with pytest.raises(ValueError):
        mk.mtf_start_tables(rec[:, :255].contiguous(), C)


def test_k1_partials_wrapper_checks_its_domain():
    """K1's tile maxima need int32 positions and a tile the kernel is
    built for, on both routes; the start tables take them only with
    that tile and at its shape.  Without partials any chunk count
    goes."""
    d, C = start_case("text", 5)
    syms = torch.from_numpy(d.astype(np.int32))
    rec, part, tile = mk.mtf_recency(syms, partials=True)
    assert tile == mk.START_TILES[0] and part.shape == (256, 1)
    big = torch.empty((1 << 19, 4096), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        mk.mtf_recency(big, partials=True)
    for bad in (12, -8, 128):
        with pytest.raises(ValueError, match="tile"):
            mk.mtf_recency(syms, partials=True, tile=bad)
        with pytest.raises(ValueError, match="tile"):
            mk.mtf_recency(syms, tile=bad)
    with pytest.raises(ValueError, match="tile"):
        mk.mtf_start_tables(rec, C, part=part)           # tile 0
    with pytest.raises(ValueError, match="last dim"):
        mk.mtf_start_tables(rec, C, tile=8, part=torch.cat([part, part], 1))
    with pytest.raises(ValueError, match="256 rows"):
        mk.mtf_start_tables(rec, C, tile=8, part=part[:128].contiguous())
    with pytest.raises(ValueError, match="int32"):
        mk.mtf_start_tables(rec, C, tile=8, part=part.long())
    wide = rec.repeat(8, 1)
    with pytest.raises(ValueError, match="last dim"):   # tile 8's part, 5 tiles
        mk.mtf_start_tables(wide, C, tile=16, part=mk.mtf_tile_max_plain(
            wide, C, 8))


def test_empty_block_gives_no_tables():
    """0 chunks: no tables (the plain chain alone would make one), so
    the forward path of an empty input is empty."""
    rec = torch.empty((0, 256), dtype=torch.int32)
    assert mk.mtf_start_tables(rec, 128).shape == (0, 256)
    _, part, tile = mk.mtf_recency(torch.empty((0, 128), dtype=torch.int32),
                                   partials=True)
    assert part.shape == (256, 0)
    assert mk.mtf_start_tables(rec, 128, tile=tile,
                               part=part).shape == (0, 256)
    assert mtf_encode(torch.empty(0, dtype=torch.uint8)).shape == (0,)


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("name", K2_CASES)
def test_k2_plain_matches_the_contract(name):
    for nchunks, C in ((5, 128), (3, 1), (2, 129), (2, 300), (2, 0)):
        t0, syms = k2_case(name, nchunks=nchunks, C=C)
        want_r, want_t = k2_reference(t0.numpy(), syms.numpy())
        got_r, got_t = mk.mtf_encode_lockstep(t0, syms)
        assert got_r.shape == (nchunks, C)
        np.testing.assert_array_equal(got_r.numpy(), want_r)
        np.testing.assert_array_equal(got_t.numpy(), want_t)


@pytest.mark.parametrize("name,nchunks,C", [
    ("random", 1, 1), ("random", 5, 127), ("random", 33, 129),
    ("random", 130, 300), ("repeats", 17, 128), ("repeats", 3, 129)])
def test_k2_plain_matches_pallas_interpret(name, nchunks, C):
    """Permutation tables, where tpulc's rule and the port's agree: at
    chunk counts no multiple of tpulc's 128-chunk tile and at lengths
    no multiple of the kernel's batch; `repeats` is 90 % rank-0 steps."""
    t0, syms = k2_case(name, nchunks=nchunks, C=C, seed=1)
    want_r, want_t = mtf_pallas.mtf_encode_lockstep_pallas(
        jnp.asarray(t0.numpy()), jnp.asarray(syms.numpy()), interpret=True)
    got_r, got_t = mk.mtf_encode_lockstep(t0, syms)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    if name == "repeats":
        assert (got_r == 0).float().mean() > 0.85


def _duplicate_table():
    t0 = np.arange(256, dtype=np.int32)[None, :].repeat(2, 0)
    t0[:, 200] = 5    # symbol 5 at positions 5 and 200
    return t0, np.array([[5], [5]], np.int32)


def test_f5_first_match_in_the_port_last_in_tpulcs_pallas_k2():
    """ROADMAP F5: on a table holding symbol 5 at positions 5 and 200,
    the port's K2, tpulc's XLA step (`jnp.argmax` of the equality,
    `tpulc/primitives/mtf.py:109`) and the numpy gold's `list.index`
    take rank 5; tpulc's Pallas K2 takes 200 (the max of the matching
    positions, `mtf_pallas.py:132-134`)."""
    t0, syms = _duplicate_table()
    ranks, tab = mk.mtf_encode_lockstep_plain(torch.from_numpy(t0),
                                              torch.from_numpy(syms))
    assert ranks[:, 0].tolist() == [5, 5]
    assert tab[0, :7].tolist() == [5, 0, 1, 2, 3, 4, 6]
    assert tab[0, 200] == 5                 # the second 5 stays
    xla = jnp.argmax(jnp.asarray(t0) == jnp.asarray(syms), axis=1)
    assert np.asarray(xla).tolist() == [5, 5]
    assert list(t0[0]).index(5) == 5
    np.testing.assert_array_equal(k2_reference(t0, syms)[0], ranks.numpy())
    pallas_r, _ = mtf_pallas.mtf_encode_lockstep_pallas(
        jnp.asarray(t0), jnp.asarray(syms), interpret=True)
    assert np.asarray(pallas_r)[:, 0].tolist() == [200, 200]


def test_k2_absent_symbol_takes_rank_0_and_overwrites_the_front():
    """A symbol not in the table: rank 0, position 0 overwritten and
    nothing shifted, in the port, the scalar walk and tpulc's Pallas K2."""
    t0 = np.stack([np.arange(256), np.arange(255, -1, -1)]).astype(np.int32)
    syms = np.array([[300, 300, 7], [-1, 3, -1]], np.int32)
    ranks, tab = mk.mtf_encode_lockstep_plain(torch.from_numpy(t0),
                                              torch.from_numpy(syms))
    assert ranks.tolist() == [[0, 0, 7], [0, 252, 1]]
    assert tab[0, :9].tolist() == [7, 300, 1, 2, 3, 4, 5, 6, 8]
    assert tab[1, :3].tolist() == [-1, 3, 254]
    want = k2_reference(t0, syms)
    np.testing.assert_array_equal(ranks.numpy(), want[0])
    np.testing.assert_array_equal(tab.numpy(), want[1])
    pallas = mtf_pallas.mtf_encode_lockstep_pallas(
        jnp.asarray(t0), jnp.asarray(syms), interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(pallas[0]))
    np.testing.assert_array_equal(tab.numpy(), np.asarray(pallas[1]))


def test_k2_wrapper_checks_its_options():
    """The CPU route is the plain version; tables and symbols must agree
    on the chunk count, be int32 and hold 256-entry rows."""
    t0, syms = k2_case("random", nchunks=2)
    want = mk.mtf_encode_lockstep_plain(t0, syms)
    got = mk.mtf_encode_lockstep(t0, syms)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="chunk count"):
        mk.mtf_encode_lockstep(t0[:1], syms)
    with pytest.raises(ValueError, match="int32"):
        mk.mtf_encode_lockstep(t0, syms.long())
    with pytest.raises(ValueError, match="256"):
        mk.mtf_encode_lockstep(t0[:, :128].contiguous(), syms)
