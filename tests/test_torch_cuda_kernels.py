"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (marked `cuda`; they skip on a machine without one).  On the
card: `python -m pytest tests/test_torch_cuda_kernels.py -m cuda`."""

import functools

import numpy as np
import pytest
import torch
from test_torch_walk_cases import (
    ABC_CARD_CASES,
    K1_CASES,
    K1_SHAPES,
    K2_CASES,
    K3_CASES,
    K4_CASES,
    K8_CASES,
    RANS_CARD_CASES,
    START_CASES,
    abc_case,
    abc_states,
    k1_case,
    k2_case,
    k3_case,
    k4_case,
    k8_case,
    rans_case,
    rans_walk_args,
    start_case,
)

from tpulc_torch.codecs.bwt import driver
from tpulc_torch.codecs.huffman import decode_kernels as dk
from tpulc_torch.codecs.huffman import driver as hdrv
from tpulc_torch.codecs.huffman.device_tables import canonical_decode_params
from tpulc_torch.primitives import mtf_kernels as mk

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _seq(seed, nchunks=300):
    rng = np.random.default_rng(seed)
    t0 = np.stack([rng.permutation(256) for _ in range(nchunks)])
    seq = rng.integers(0, 256, size=(nchunks, 128))
    seq[:50] = rng.integers(0, 4, size=(50, 128))  # small-rank chunks
    return (torch.from_numpy(t0.astype(np.int32)),
            torch.from_numpy(seq.astype(np.int32)))


def test_k1_k2_k4_equal_plain(cuda):
    t0, seq = _seq(0)
    tc, sc = t0.to(cuda), seq.to(cuda)
    n = mk.mtf_recency.launches
    want = mk.mtf_recency_plain(seq)
    assert torch.equal(mk.mtf_recency(sc).cpu(), want)
    assert mk.mtf_recency.launches == n + 1
    rec, part, tile = mk.mtf_recency(sc, partials=True)
    assert mk.mtf_recency.launches == n + 2
    assert tile in mk.START_TILES and torch.equal(rec.cpu(), want)
    assert torch.equal(part.cpu(), mk.mtf_tile_max_plain(want, 128, tile))
    for kern, plain in ((mk.mtf_encode_lockstep, mk.mtf_encode_lockstep_plain),
                        (mk.mtf_lockstep, mk.mtf_lockstep_plain)):
        got = kern(tc, sc)
        want = plain(t0, seq)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def _shifted(t, dev, by=1):
    """A contiguous copy of t on dev whose storage starts `by` elements
    into a wider buffer: 4-byte but not 16-byte aligned."""
    wide = torch.zeros(t.numel() + by, dtype=t.dtype, device=dev)
    wide[by:] = t.reshape(-1).to(dev)
    out = wide[by:].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("tile", [0, *mk.START_TILES])
@pytest.mark.parametrize("name", K1_CASES)
def test_k1_rows_and_tile_maxima_equal_plain(cuda, name, tile):
    """K1 at every tile (0: the start tables' pick), with and without
    the tile maxima, on every chunk length of K1_SHAPES (1 to 5,000
    steps) at 0, 1, under-a-tile and ragged chunk counts; and from a
    view 4 bytes into its storage (4-byte, not 16-byte aligned)."""
    for nchunks, C in K1_SHAPES:
        syms = k1_case(name, nchunks, C)
        want = mk.mtf_recency_plain(syms)
        n = mk.mtf_recency.launches
        rows = mk.mtf_recency(syms.to(cuda), tile=tile)
        rec, part, t = mk.mtf_recency(syms.to(cuda), partials=True, tile=tile)
        torch.cuda.synchronize()
        assert mk.mtf_recency.launches == n + (2 if nchunks else 0)
        assert t in mk.START_TILES and tile in (0, t)
        assert torch.equal(rows.cpu(), want), (nchunks, C)
        assert torch.equal(rec.cpu(), want), (nchunks, C)
        assert torch.equal(part.cpu(), mk.mtf_tile_max_plain(want, C, t)), \
            (nchunks, C)
        if nchunks:
            rec, part, t = mk.mtf_recency(_shifted(syms, cuda), partials=True,
                                          tile=tile)
            torch.cuda.synchronize()
            assert torch.equal(rec.cpu(), want), (nchunks, C)
            assert torch.equal(part.cpu(), mk.mtf_tile_max_plain(want, C, t))


@pytest.mark.parametrize("lanes", mk.LANES)
@pytest.mark.parametrize("name", K4_CASES)
def test_k4_variants_equal_plain(cuda, name, lanes):
    """Every lanes-a-chunk build on every edge case, at
    chunk counts that leave a ragged last block (1, 31, 33, 301) and at
    chunk lengths that are no multiple of the batch (100), of 4 (130:
    the scalar accesses) or longer than one batch (516)."""
    for nchunks, C in ((1, 128), (31, 128), (33, 128), (301, 128),
                       (37, 100), (5, 130), (9, 516)):
        t0, ranks = k4_case(name, nchunks=nchunks, C=C)
        want = mk.mtf_lockstep_plain(t0, ranks)
        n = mk.mtf_lockstep.launches
        got = mk.mtf_lockstep(t0.to(cuda), ranks.to(cuda), lanes=lanes)
        torch.cuda.synchronize()
        assert mk.mtf_lockstep.launches == n + 1
        assert torch.equal(got[0].cpu(), want[0]), (nchunks, C)
        assert torch.equal(got[1].cpu(), want[1]), (nchunks, C)


@pytest.mark.parametrize("lanes", [None, *mk.LANES])
def test_k4_identity_start_skipped_outputs_and_unaligned_views(cuda, lanes):
    t0, ranks = k4_case("random", nchunks=77, C=128, seed=4)
    want_s, want_t = mk.mtf_lockstep_plain(None, ranks)
    rc = ranks.to(cuda)
    s, t = mk.mtf_lockstep(None, rc, lanes=lanes)
    assert torch.equal(s.cpu(), want_s) and torch.equal(t.cpu(), want_t)
    s, t = mk.mtf_lockstep(None, rc, want_syms=False, lanes=lanes)
    assert s is None and torch.equal(t.cpu(), want_t)
    want_s, want_t = mk.mtf_lockstep_plain(t0, ranks)
    s, t = mk.mtf_lockstep(t0.to(cuda), rc, want_table=False, lanes=lanes)
    assert t is None and torch.equal(s.cpu(), want_s)
    s, t = mk.mtf_lockstep(_shifted(t0, cuda), _shifted(ranks, cuda, 3),
                           lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(s.cpu(), want_s) and torch.equal(t.cpu(), want_t)


@pytest.mark.parametrize("name", K2_CASES)
def test_k2_variants_equal_plain(cuda, name):
    """Every edge case (first matches on
    duplicate entries, absent symbols, any int32, 90 % rank-0 steps), at
    ragged chunk counts and at lengths no multiple of the batch (1, 100,
    127, 129, 300), of 4 (130) or 0."""
    for nchunks, C in ((1, 128), (31, 128), (33, 128), (301, 128),
                       (37, 100), (5, 130), (9, 516), (3, 1), (4, 127),
                       (4, 129), (3, 300), (2, 0)):
        t0, syms = k2_case(name, nchunks=nchunks, C=C)
        want = mk.mtf_encode_lockstep_plain(t0, syms)
        n = mk.mtf_encode_lockstep.launches
        got = mk.mtf_encode_lockstep(t0.to(cuda), syms.to(cuda))
        torch.cuda.synchronize()
        assert mk.mtf_encode_lockstep.launches == n + 1
        assert torch.equal(got[0].cpu(), want[0]), (nchunks, C)
        assert torch.equal(got[1].cpu(), want[1]), (nchunks, C)


def test_k2_reads_unaligned_views(cuda):
    t0, syms = k2_case("repeats", nchunks=77, C=128, seed=4)
    want = mk.mtf_encode_lockstep_plain(t0, syms)
    got = mk.mtf_encode_lockstep(_shifted(t0, cuda), _shifted(syms, cuda, 3))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("tile", [0, 8, 16, 32, 64])
@pytest.mark.parametrize("name", START_CASES)
def test_start_tables_equal_plain(cuda, name, tile):
    """K1's output at chunk counts ragged to the tile (1, T-1, T, T+1,
    3T+5) and at the bz block's 7,032 chunks; tile 0 is the C entry
    point's pick."""
    T = tile or 8
    for nchunks in (1, T - 1, T, T + 1, 3 * T + 5, 7032):
        d, C = start_case(name, nchunks)
        rec = mk.mtf_recency(torch.from_numpy(d.astype(np.int32)).to(cuda))
        want = mk.mtf_start_tables_plain(rec.cpu(), C)
        n = mk.mtf_start_tables.launches
        got = mk.mtf_start_tables(rec, C, tile=tile)
        torch.cuda.synchronize()
        assert mk.mtf_start_tables.launches == n + 1
        assert torch.equal(got.cpu(), want), nchunks
        # from K1's tile maxima (the forward MTF's route): the same tables,
        # and the maxima are read, not written
        rec, part, t = mk.mtf_recency(
            torch.from_numpy(d.astype(np.int32)).to(cuda), partials=True,
            tile=tile)
        kept = part.clone()
        got = mk.mtf_start_tables(rec, C, tile=t, part=part)
        again = mk.mtf_start_tables(rec, C, tile=t, part=part)
        torch.cuda.synchronize()
        assert mk.mtf_start_tables.launches == n + 3
        assert torch.equal(got.cpu(), want), nchunks
        assert torch.equal(again, got) and torch.equal(part, kept)
    empty = torch.empty((0, 256), dtype=torch.int32, device=cuda)
    assert mk.mtf_start_tables(empty, 128, tile=tile).shape == (0, 256)
    _, part, t = mk.mtf_recency(torch.empty((0, 128), dtype=torch.int32,
                                            device=cuda), partials=True,
                                tile=tile)
    assert mk.mtf_start_tables(empty, 128, tile=t, part=part).shape == (0, 256)


def test_start_tables_refuse_what_the_kernel_cannot_do(cuda):
    """A tile the kernel is not built for, and chunks past its 4,096-step
    mask, raise on the card (the CPU route runs the plain version)."""
    d, C = start_case("text", 5)
    rec = mk.mtf_recency(torch.from_numpy(d.astype(np.int32)).to(cuda))
    with pytest.raises(ValueError, match="tile"):
        mk.mtf_start_tables(rec, C, tile=12)
    n = mk.mtf_start_tables.launches
    with pytest.raises(RuntimeError, match="mtf_start_tables"):
        mk.mtf_start_tables(rec, 4097)
    assert mk.mtf_start_tables.launches == n


def _tile_rows(ntiles, tile, C, seed):
    """K1's input for ntiles tiles of `tile` chunks (the last one cut by
    half a tile) of C steps: each tile draws from its own 8 to 24
    symbols, so that a symbol's last position lies tiles back and some
    symbols stay unseen for many tiles."""
    rng = np.random.default_rng([seed, ntiles, tile, C])
    nchunks = max(1, ntiles * tile - tile // 2)
    d = np.empty((nchunks, C), np.int32)
    for t in range(ntiles):
        alpha = rng.choice(256, size=int(rng.integers(8, 25)), replace=False)
        rows = d[t * tile:(t + 1) * tile]
        rows[:] = rng.choice(alpha, size=rows.shape)
    return torch.from_numpy(d)


@pytest.mark.parametrize("C", [1, 128, 4096])
@pytest.mark.parametrize("tile", [0, *mk.START_TILES])
def test_start_tables_across_the_prefix_scan(cuda, tile, C):
    """The start tables at tile counts of 1 (no prefix), 31 to 65 (one
    block scanning several symbol rows a warp), 256 and 257 (a scanning
    warp's batch of 256 tiles, and one tile past it), 300 (every
    scanning block, a row a warp), 528 and 529 (at 132 SMs the most
    tiles that the pick splits between 2 warps, and one more), 1,100,
    at every built tile and the pick, chunks of 1, 128 and 4,096 steps:
    from K1's maxima (read and not written, one launch a call) and from
    their own maxima, each equal to the plain version."""
    for ntiles in ((1, 31, 33, 65) if C == 4096 else
                   (1, 31, 32, 33, 65, 256, 257, 300, 528, 529, 1100)):
        T = tile or mk.START_TILES[0]
        d = _tile_rows(ntiles, T, C, 1).to(cuda)
        rec, part, t = mk.mtf_recency(d, partials=True, tile=tile)
        want = mk.mtf_start_tables_plain(rec.cpu(), C)
        kept = part.clone()
        n = mk.mtf_start_tables.launches
        got = mk.mtf_start_tables(rec, C, tile=t, part=part)
        torch.cuda.synchronize()
        assert mk.mtf_start_tables.launches == n + 1
        assert torch.equal(got.cpu(), want), (ntiles, t)
        assert torch.equal(part, kept)
        own = mk.mtf_start_tables(rec, C, tile=t)
        torch.cuda.synchronize()
        assert mk.mtf_start_tables.launches == n + 2
        assert torch.equal(own.cpu(), want), (ntiles, t)


def test_start_tables_called_50_times_equal_plain(cuda):
    """Fifty calls in a row on one stream, each with the scratch the
    caching allocator hands back (the last call's nodes and flags): the
    memset clears every flag a call reads."""
    d = _tile_rows(300, 8, 128, 2).to(cuda)
    rec, part, t = mk.mtf_recency(d, partials=True, tile=8)
    want = mk.mtf_start_tables_plain(rec.cpu(), 128).to(cuda)
    outs = [mk.mtf_start_tables(rec, 128, tile=t, part=part)
            for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def test_mtf_encode_on_card_matches_cpu(cuda):
    """The forward path (K1, the start tables, K2) against the CPU's."""
    from tpulc_torch.primitives.mtf import mtf_encode

    for name in START_CASES:
        d, _ = start_case(name, 301)
        data = torch.from_numpy(d.reshape(-1))
        assert torch.equal(mtf_encode(data.to(cuda)).cpu(),
                           mtf_encode(data)), name


_K3_WANT = {}


@pytest.mark.parametrize("tile", [None, *dk.WALK_TILES])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", K3_CASES)
def test_k3_edges_equal_plain(cuda, name, packed, tile):
    """Every tile on every edge case ("far" walks from global memory, the
    rest from the shared-memory stage): L = 12 and 15 and the generic
    build (9), streams whose chunk count is no multiple of the tile,
    chunks of two output slabs (256) and of a ragged one (20)."""
    for L, C, ccap in ((12, 128, 300), (15, 128, 130), (9, 256, 70),
                       (15, 20, 150)):
        args = k3_case(name, C=C, L=L, ccap=ccap, W=401)
        key = (name, packed, L, C, ccap)
        if key not in _K3_WANT:
            _K3_WANT[key] = dk.huffman_walk_plain(*args, packed=packed)
        dev_args = _on(cuda, args)
        got = dk.huffman_walk(*dev_args, packed=packed, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), _K3_WANT[key]), (L, C, ccap)


@pytest.mark.parametrize("tile", [None, *dk.WALK_TILES])
def test_k3_one_table_a_stream_takes_the_window_table(cuda, tile):
    """The huffman codec's shape in small: one table a stream (so every
    tile is uniform and, packed at L <= 12, walks by the window table),
    300 chunks a stream."""
    for L, C in ((12, 128), (9, 64), (12, 256)):
        args = list(k3_case("sorted", C=C, L=L, B=3, ccap=300, W=1200))
        args[5] = torch.arange(3, dtype=torch.int32).repeat_interleave(300)
        want = dk.huffman_walk_plain(*args, packed=True)
        dev_args = _on(cuda, args)
        got = dk.huffman_walk(*dev_args, packed=True, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (L, C)


def test_k3_keeps_and_rebuilds_the_window_table_across_a_blocks_tiles(cuda):
    """Enough chunks (3 x 174,763 of 4 symbols, no multiple of 128 a
    stream) that a block walks several 128-chunk tiles: the code table
    changes every second tile (the window table is kept, then rebuilt)
    and every 40th tile mixes two tables (that tile compares)."""
    ccap = 174_763
    args = list(k3_case("sorted", C=4, L=12, B=3, ccap=ccap, W=30_000))
    j = torch.arange(ccap) // 128
    tab = (j // 2) % 5
    tab[(j % 40 == 39) & (torch.arange(ccap) % 2 == 1)] = 4
    args[5] = tab.repeat(3).to(torch.int32)
    want = dk.huffman_walk_plain(*args, packed=True)
    got = dk.huffman_walk(*_on(cuda, args), packed=True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("tile", [None, *dk.WALK_TILES])
@pytest.mark.parametrize("name", ["sorted", "far"])
def test_k3_reads_an_unaligned_words_view(cuda, name, tile):
    """`words` 4 bytes into a wider buffer with an odd row length: no
    stream row starts on a 16-byte boundary."""
    args = k3_case(name, C=128, L=12, B=3, ccap=140, W=401)
    want = dk.huffman_walk_plain(*args, packed=True)
    dev_args = _on(cuda, args)
    dev_args[0] = _shifted(args[0], cuda)
    got = dk.huffman_walk(*dev_args, packed=True, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _walk_args(seed, B=3, ccap=256, L=15):
    """K3 inputs: B streams with ragged ends, 4 tables, random picks."""
    rng = np.random.default_rng(seed)
    W = 3000
    words = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64).astype(
        np.uint32)
    tbits = np.array([W * 32 - 77 - 500 * j for j in range(B)], np.int32)
    offs = np.sort(rng.integers(0, W * 32 + 64, B * ccap)).astype(np.int32)
    lens = torch.from_numpy(rng.integers(1, L + 1, size=(4, 257)))
    lim, base, _ = canonical_decode_params(lens, L)
    tab = torch.from_numpy(rng.integers(0, 4, B * ccap).astype(np.int32))
    return (torch.from_numpy(words.view(np.int32)), torch.from_numpy(tbits),
            torch.from_numpy(offs), lim, base, tab)


def _on(dev, args):
    return [a.to(dev) if torch.is_tensor(a) else a for a in args]


@pytest.mark.parametrize("packed", [False, True])
def test_k3_equals_plain(cuda, packed):
    args = (*_walk_args(1), 128, 15)
    want = dk.huffman_walk_plain(*args, packed=packed)
    n = dk.huffman_walk.launches
    got = dk.huffman_walk(*_on(cuda, args), packed=packed)
    torch.cuda.synchronize()
    assert dk.huffman_walk.launches == n + 1
    assert torch.equal(got.cpu(), want)


_K7_WANT = {}


@pytest.mark.parametrize("L", [12, 15, 9])
@pytest.mark.parametrize("name", K3_CASES)
def test_k7_edges_equal_plain(cuda, name, L):
    """K7 on every K3 edge case (random tables a chunk, so every tile
    compares; "far" walks from global memory, the rest from the stage)
    at chunk lengths of 8, 128, 136 and 300 symbols, 150 chunks a
    stream (no multiple of any tile); one launch a call."""
    for C in (8, 128, 136, 300):
        args = k3_case(name, C=C, L=L, ccap=150, W=401)
        key = (name, L, C)
        if key not in _K7_WANT:
            _K7_WANT[key] = dk.huffman_walk_v1_plain(*args)
        n = dk.huffman_walk_v1.launches
        got = dk.huffman_walk_v1(*_on(cuda, args))
        torch.cuda.synchronize()
        assert dk.huffman_walk_v1.launches == n + 1
        assert got.shape == (args[2].shape[0], C)
        assert torch.equal(got.cpu(), _K7_WANT[key]), C


@pytest.mark.parametrize("name", ["sorted", "hostile", "corrupt", "tbits_pad",
                                  "far", "past_words"])
def test_k7_length_table_on_one_table_a_stream(cuda, name):
    """The huffman codec's shape in small: one table a stream and 40,000
    chunks (128-chunk tiles), so that at L = 12 every tile walks by the
    length table; "hostile" also takes bases of any int32 (indices
    wrap as int32, unclipped)."""
    for L in (12, 9, 15):
        args = list(k3_case(name, C=8, L=L, B=2, ccap=20_000,
                            W=3000 if name != "far" else 60_000))
        args[5] = torch.arange(2, dtype=torch.int32).repeat_interleave(20_000)
        if name == "hostile":
            args[4] = torch.from_numpy(np.random.default_rng(5).integers(
                -2**31, 2**31, size=args[4].shape).astype(np.int32))
        want = dk.huffman_walk_v1_plain(*args)
        got = dk.huffman_walk_v1(*_on(cuda, args))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), L


def test_k7_reads_an_unaligned_words_view(cuda):
    for ccap in (140, 20_000):
        args = list(k3_case("sorted", C=128, L=12, B=3, ccap=ccap, W=4001))
        args[5] = torch.zeros(3 * ccap, dtype=torch.int32)
        want = dk.huffman_walk_v1_plain(*args)
        dev_args = _on(cuda, args)
        dev_args[0] = _shifted(args[0], cuda)
        got = dk.huffman_walk_v1(*dev_args)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), ccap


@pytest.mark.parametrize("name", K8_CASES)
def test_k8_edges_equal_plain(cuda, name):
    """K8 on every K8 edge case, 256 chunks a stream (32-chunk tiles: the
    compares of the count rule), at L = 12, 15 and 9 and chunk lengths
    of 16, 128, 132 (a ragged second slab) and 300; one launch a call."""
    for L, C in ((12, 16), (12, 128), (15, 132), (9, 300)):
        args = k8_case(name, C=C, L=L)
        want = dk.huffman_walk_flat_plain(*args)
        n = dk.huffman_walk_flat.launches
        got = dk.huffman_walk_flat(*_on(cuda, args))
        torch.cuda.synchronize()
        assert dk.huffman_walk_flat.launches == n + 1
        assert torch.equal(got.cpu(), want), (L, C)


@pytest.mark.parametrize("name", ["tables", "nonnested", "hostile",
                                  "past_stream", "bits_left", "far"])
def test_k8_window_table_across_a_blocks_tiles(cuda, name):
    """4 streams of 131,072 chunks of 4 symbols: 128-chunk tiles, 4 a
    block, so at L = 12 the block builds the window table by the count
    rule and keeps it while the next tile's table holds the same values
    ("tables": runs of 3 tiles share one, then it changes; the rest
    pick a table a tile at random).  L = 15 compares."""
    for L in (12, 15):
        args = k8_case(name, C=4, L=L, B=4, ccap=131_072, W=30_000)
        want = dk.huffman_walk_flat_plain(*args)
        got = dk.huffman_walk_flat(*_on(cuda, args))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), L


@pytest.mark.parametrize("ccap", [128 * 100, 128 * 300])
@pytest.mark.parametrize("name", ["sorted", "far"])
def test_k8_reads_an_unaligned_words_view(cuda, name, ccap):
    """`words` 4 bytes into a wider buffer with an odd row length, at
    32-chunk tiles (compares) and at 128-chunk tiles (window table)."""
    args = list(k8_case(name, C=16, L=12, B=3, ccap=ccap, W=4001))
    want = dk.huffman_walk_flat_plain(*args)
    dev_args = _on(cuda, args)
    dev_args[0] = _shifted(args[0], cuda)
    got = dk.huffman_walk_flat(*dev_args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kw", [{}, {"chunk_syms": 256}, {"aligned": False}],
                         ids=["v2", "v1", "selfsync"])
def test_huffman_on_card_matches_cpu(cuda, kw):
    """The card writes the CPU path's bytes, and every decoder decodes
    them on the card."""
    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read(150000)
    on_card = hdrv.compress(data, block_size=1 << 16, device="cuda", **kw)
    assert on_card == hdrv.compress(data, block_size=1 << 16, device="cpu",
                                    **kw)
    for kernel in hdrv.KERNELS:
        assert hdrv.decompress(on_card, device="cuda", kernel=kernel) == data
    assert hdrv.compress(b"", device="cuda") == hdrv.compress(b"",
                                                              device="cpu")


@pytest.mark.parametrize("name", ["pg1661_150k", "periodic", "tiny",
                                  "empty"])
def test_bz_on_card_matches_cpu(cuda, name):
    """The card writes the CPU path's bytes and both decode them; the
    periodic and tiny blocks take the anchor-less doubling decode."""
    with open("tests/data/pg1661.txt", "rb") as f:
        data, bs = {"pg1661_150k": (f.read(150000), 1 << 16),
                    "periodic": (b"abc" * 3000, 1 << 16),
                    "tiny": (b"x", 1024),
                    "empty": (b"", 1024)}[name]
    on_card = driver.compress(data, block_size=bs, device="cuda")
    assert on_card == driver.compress(data, block_size=bs, device="cpu")
    assert driver.decompress(on_card, device="cuda") == data
    assert driver.decompress(on_card, device="cpu") == data


def _grc_case(seed, cap=8192):
    """A real group-rank grid and stream: MTF ranks of a BWT'd text
    block, with m < cap so the last lanes are short or empty."""
    from tpulc_torch.codecs.bsclike import grc
    from tpulc_torch.codecs.bwt.masked import forward_ranks_anchored

    with open("tests/data/pg1661.txt", "rb") as f:
        raw = f.read()[seed * 10000: seed * 10000 + cap - 700]
    block = torch.zeros(cap, dtype=torch.uint8)
    block[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    ranks, _, _, _ = forward_ranks_anchored(block, len(raw), 1024)
    lb, _ = grc.grc_lane_bits(ranks, len(raw))
    nsteps = int(lb.max())
    W = grc.bucket_bits(nsteps)
    gmb, _ = grc._binarize(ranks, len(raw), W)
    init, cinit, _ = grc._stats_quant(gmb)
    enc = grc.grc_encode(ranks, len(raw), W)
    return ranks, len(raw), gmb, init, cinit, nsteps, enc


def test_k5_equals_plain(cuda):
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    _, _, gmb, init, cinit, nsteps, _ = _grc_case(1)
    want = gk.grc_walk_probs_plain(gmb, init, cinit, nsteps)
    n = gk.grc_walk_probs.launches
    got = gk.grc_walk_probs(*_on(cuda, (gmb, init, cinit)), nsteps)
    torch.cuda.synchronize()
    assert gk.grc_walk_probs.launches == n + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("cut", [False, True], ids=["stream", "cut"])
def test_k6_equals_plain(cuda, cut):
    """On a real stream, and on the same stream cut to 7 word columns
    and a third of its steps (clamped reads, early stop)."""
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    ranks, m, _, _, _, nsteps, enc = _grc_case(2)
    words, _, states, inits, cinits, _ = enc
    w16 = words.to(torch.int16) if not cut else \
        words[:, :7].contiguous().to(torch.int16)
    s32 = torch.where(states >= 1 << 31, states - (1 << 32),
                      states).to(torch.int32)
    steps = nsteps // 3 if cut else nsteps
    args = (w16, s32, inits.int(), cinits.int())
    want = gk.grc_decode_walk_plain(*args, m, steps, 1024)
    n = gk.grc_decode_walk.launches
    got = gk.grc_decode_walk(*_on(cuda, args), m, steps, 1024)
    torch.cuda.synchronize()
    assert gk.grc_decode_walk.launches == n + 1
    assert torch.equal(got.cpu(), want)
    if not cut:
        assert torch.equal(want.reshape(-1)[:m], ranks[:m])


def test_emission_equals_plain(cuda):
    """The reverse-rANS emission on a real grid and K5's probabilities:
    words, counts and states, and the launch count rises by one."""
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    _, _, gmb, init, cinit, nsteps, _ = _grc_case(1)
    probs = gk.grc_walk_probs_plain(gmb, init, cinit, nsteps)
    want = gk.grc_reverse_rans_plain(gmb, probs, nsteps)
    n = gk.grc_reverse_rans.launches
    got = gk.grc_reverse_rans(*_on(cuda, (gmb, probs)), nsteps)
    torch.cuda.synchronize()
    assert gk.grc_reverse_rans.launches == n + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _odd_grid(case, W=640, L=1000):
    """An event grid no encoder writes: empty slots in the middle of
    lanes, lanes of very different lengths (some empty), records of
    model 0 and past the last model, and L a multiple of neither 32 nor
    94; -> (gmb, init, cinit, nsteps)."""
    from tpulc_torch.codecs.bsclike import grc

    rng = np.random.default_rng(7)
    g = rng.integers(1, 2 * grc.NM + 4, size=(W, L)).astype(np.int32)
    length = rng.integers(0, W + 1, size=L)
    length[::17] = 0
    g[np.arange(W)[:, None] >= length[None, :]] = 0
    if case == "holes":
        g[rng.random((W, L)) < 0.3] = 0
    init = rng.integers(8, 4089, size=grc.NM).astype(np.int32)
    cinit = rng.integers(8, 4089, size=grc.NFAM).astype(np.int32)
    nsteps = {"ragged": int(length.max()), "holes": int(length.max()),
              "short": W // 3, "nsteps0": 0}[case]
    return (torch.from_numpy(g), torch.from_numpy(init),
            torch.from_numpy(cinit), nsteps)


@pytest.mark.parametrize("lanes", [None, 5, 32, 94])
@pytest.mark.parametrize("case", ["ragged", "holes", "short", "nsteps0"])
def test_k5_and_emission_on_odd_grids(cuda, case, lanes):
    """K5 at several lanes a block, and the emission on its output,
    equal their plain versions on grids no encoder writes."""
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    gmb, init, cinit, nsteps = _odd_grid(case)
    want = gk.grc_walk_probs_plain(gmb, init, cinit, nsteps)
    got = gk.grc_walk_probs(*_on(cuda, (gmb, init, cinit)), nsteps,
                            lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    want_e = gk.grc_reverse_rans_plain(gmb, want, nsteps)
    got_e = gk.grc_reverse_rans(*_on(cuda, (gmb, want)), nsteps)
    torch.cuda.synchronize()
    for g, w in zip(got_e, want_e):
        assert torch.equal(g.cpu(), w)


def _emission_grid(case, W=300, L=40):
    """(gmb, probs, nsteps) for the emission's card cases: "full" puts
    an event at every step of every other lane at p = 1 or 4,095 (the
    most words a lane can emit, past the words a lane stages), with
    empty lanes between; "odd_probs" also gives two stages
    probabilities outside [0, 4,096] (the divide route); "ragged" has
    lanes of any length up to W with holes, every seventh lane empty
    (lane 0 never), and K5's probabilities."""
    from tpulc_torch.codecs.bsclike import grc
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    rng = np.random.default_rng([11, L, W])
    if case == "ragged":
        g = rng.integers(1, 2 * grc.NM + 4, size=(W, L)).astype(np.int32)
        length = rng.integers(1, W + 1, size=L)
        length[np.arange(L) % 7 == 3] = 0
        g[np.arange(W)[:, None] >= length[None, :]] = 0
        g[rng.random((W, L)) < 0.3] = 0
        init = rng.integers(8, 4089, size=grc.NM).astype(np.int32)
        cinit = rng.integers(8, 4089, size=grc.NFAM).astype(np.int32)
        g = torch.from_numpy(g)
        return g, gk.grc_walk_probs_plain(g, torch.from_numpy(init),
                                          torch.from_numpy(cinit), W), W
    g = np.zeros((W, L), np.int32)
    p = np.zeros((W, L), np.int32)
    full = np.arange(L) % 2 == 0
    g[:, full] = rng.choice([2, 3], size=(W, int(full.sum())))
    p[:, full] = np.where(np.arange(L)[full] % 4 == 0, 1, 4095)
    if case == "odd_probs":
        p[17:40, 0] = -77777
        p[100:103, L - 2] = 900_000
    return torch.from_numpy(g), torch.from_numpy(p), W


def _emission_c_call(g, p, n):
    """The emission's C entry alone into a words buffer filled with
    0x7f bytes: the kernel must write every entry."""
    from tpulc_torch import cuda_lib

    W, L = g.shape
    words = torch.full((L, W + 2), 0x7F7F7F7F, dtype=torch.int32,
                       device=g.device)
    counts = torch.full((L,), -1, dtype=torch.int64, device=g.device)
    states = torch.full((L,), -1, dtype=torch.int64, device=g.device)
    cuda_lib.check(cuda_lib.library().tplc_grc_reverse_rans(
        g.data_ptr(), p.data_ptr(), words.data_ptr(), counts.data_ptr(),
        states.data_ptr(), W, L, max(0, min(n, W)), cuda_lib.stream_of(g)),
        "grc_reverse_rans")
    return words, counts, states


@pytest.mark.parametrize("nsteps", ["all", 37, 0])
@pytest.mark.parametrize("case,L", [("ragged", 1), ("ragged", 31),
                                    ("ragged", 33), ("ragged", 1000),
                                    ("full", 40), ("full", 33),
                                    ("odd_probs", 40)])
def test_emission_edges_equal_plain(cuda, case, L, nsteps):
    """The emission at L = 1, 31, 33 and 1,000 lanes, with full lanes of
    up to 1,500 words (past both word buffers) between empty ones, and
    with probabilities outside [0, 4,096]; nsteps the grid's, 37 (no
    multiple of a stage's 16 steps) and 0.  Through the wrapper (one
    launch), and through the C entry into a buffer of 0x7f bytes, which
    the kernel must overwrite entirely."""
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    W = 2000 if case == "full" else 300
    gmb, probs, n = _emission_grid(case, W=W, L=L)
    n = n if nsteps == "all" else nsteps
    want = gk.grc_reverse_rans_plain(gmb, probs, n)
    g, p = gmb.to(cuda), probs.to(cuda)
    c = gk.grc_reverse_rans.launches
    got = gk.grc_reverse_rans(g, p, n)
    again = _emission_c_call(g, p, n)
    torch.cuda.synchronize()
    assert gk.grc_reverse_rans.launches == c + 1
    for a, b, w in zip(got, again, want):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)


@pytest.mark.parametrize("side", ["ring", "registers"])
@pytest.mark.parametrize("case", ["full", "ragged"])
def test_emission_at_the_route_edge(cuda, case, side):
    """The C entry's two designs at its edge: 128 lanes an SM (16,896 on
    an H100), the most the shared-memory ring takes, whose blocks then
    all fit one wave, and one lane more, which runs the register design
    after a memset of the words (a last warp of one lane).  Both equal
    the plain version, full lanes of ~175 words and ragged ones alike,
    through the wrapper and through the C entry into a buffer of 0x7f
    bytes."""
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    L = 128 * sms + (side == "registers")
    W = 400 if case == "full" else 200
    gmb, probs, n = _emission_grid(case, W=W, L=L)
    assert cuda_lib.library().tplc_grc_reverse_rans_route(L) == (
        side == "registers")
    want = gk.grc_reverse_rans_plain(gmb, probs, n)
    got = gk.grc_reverse_rans(gmb.to(cuda), probs.to(cuda), n)
    again = _emission_c_call(gmb.to(cuda), probs.to(cuda), n)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)


_K6_WANT = {}


@pytest.mark.parametrize("lanes", [None, 5, 94])
@pytest.mark.parametrize("case", ["wc1", "m_ragged", "unaligned",
                                  "nsteps0"])
def test_k6_on_odd_streams(cuda, case, lanes):
    """K6 at several lanes a block on a real 40-lane stream: one word
    column (every refill clamps), m not a multiple of the chunk, the
    words a view 3 columns into a wider buffer (rows not 16-byte
    aligned), and nsteps = 0."""
    from tpulc_torch.codecs.bsclike import grc_kernels as gk

    ranks, m, _, _, _, nsteps, enc = _grc_case(3, cap=40 * 1024)
    words, _, states, inits, cinits, _ = enc
    w16 = words.to(torch.int16)
    if case == "wc1":
        w16 = w16[:, :1].contiguous()
    s32 = torch.where(states >= 1 << 31, states - (1 << 32),
                      states).to(torch.int32)
    mm = m - 333 if case == "m_ragged" else m
    steps = 0 if case == "nsteps0" else nsteps
    args = (w16, s32, inits.int(), cinits.int())
    if case not in _K6_WANT:  # the plain FSM takes seconds on the CPU
        _K6_WANT[case] = gk.grc_decode_walk_plain(*args, mm, steps, 1024)
    want = _K6_WANT[case]
    dw, ds, di, dc = _on(cuda, args)
    if case == "unaligned":
        wide = torch.zeros((w16.shape[0] * w16.shape[1] + 3,),
                           dtype=torch.int16, device=cuda)
        wide[3:] = dw.reshape(-1)
        dw = wide[3:].view(w16.shape)
        assert dw.is_contiguous() and dw.data_ptr() % 16 != 0
    got = gk.grc_decode_walk(dw, ds, di, dc, mm, steps, 1024, lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if case in ("unaligned", "m_ragged"):
        assert torch.equal(want.reshape(-1)[:mm], ranks[:mm])


@pytest.mark.parametrize("name", ["pg1661_50k", "records", "tiny"])
def test_bsc_on_card_matches_cpu(cuda, name):
    """The card writes the CPU path's bsc -e2 bytes and both decode
    them."""
    from tpulc_torch.codecs.bsclike import driver as bsc

    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read(50000)
    rec = (np.tile(np.arange(12, dtype=np.uint8), 3000)
           + np.random.default_rng(3).integers(0, 3, 36000).astype(np.uint8))
    data = {"pg1661_50k": text, "records": rec.tobytes(),
            "tiny": b"x"}[name]
    on_card = bsc.compress(data, block_size=1 << 16, coder=2, device="cuda")
    assert on_card == bsc.compress(data, block_size=1 << 16, coder=2,
                                   device="cpu")
    assert bsc.decompress(on_card, device="cuda") == data


@pytest.mark.parametrize("name", ["pg1661_50k", "text_random",
                                  "three_blocks", "tiny"])
def test_bsc_e1_on_card_matches_cpu(cuda, name):
    """The card writes the CPU path's bsc -e1 bytes (tpulc's default
    coder) and both decode them."""
    from tpulc_torch.codecs.bsclike import driver as bsc

    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read(150000)
    noise = np.random.default_rng(3).integers(0, 256, 8000).astype(np.uint8)
    data = {"pg1661_50k": text[:50000],
            "text_random": text[:30000] + noise.tobytes(),
            "three_blocks": text, "tiny": b"x"}[name]
    on_card = bsc.compress(data, block_size=1 << 16, device="cuda")
    assert on_card == bsc.compress(data, block_size=1 << 16, device="cpu")
    assert bsc.decompress(on_card, device="cuda") == data


@functools.lru_cache(maxsize=None)
def _rans_plain(name):
    """A RANS_CARD_CASES case's walk arguments and the plain walks'
    outputs: (encode arguments, plain encode, decode runs [(arguments,
    plain decode)] from the true and from random states)."""
    from tpulc_torch.codecs.bsclike import rans

    idx, nsym, fc, lut, fctx, nlanes = rans_walk_args(*rans_case(name))
    want = rans.rans_encode_walk_plain(idx, nsym, fc)
    words, counts, states = want
    assert (int(counts.sum()) == 0) == (name == "zero_words")
    hostile = torch.from_numpy(np.random.default_rng(7).integers(
        0, 1 << 32, states.shape[0], dtype=np.uint64).astype(np.int64))
    runs = []
    for st in (states, hostile):
        args = (words, st, fctx, nsym, lut, fc, nlanes)
        runs.append((args, rans.rans_decode_walk_plain(*args)))
    valid = torch.arange(rans.CHUNK)[None, :] < nsym[:, None]
    assert torch.equal(torch.where(valid, runs[0][1], 0),
                       torch.where(valid, (idx % 257).T, 0))
    return (idx, nsym, fc, nlanes), want, runs


def _rans_wide(enc, want, runs, blocks, dev):
    """A case's bsc blocks repeated to `blocks` (a multiple of its own),
    each padded to 512 lanes of nsym 0, on dev: -> (encode arguments,
    the encode they must give, decode runs).  A repeat's contexts are
    offset by its block, so each lane equals its original."""
    from tpulc_torch.codecs.bsclike import rans

    idx, nsym, fc, nlanes = enc
    B = idx.shape[1] // nlanes
    reps, wide = blocks // B, 512
    S = fc.shape[0] // (B * rans.NCTX)
    lane = torch.arange(blocks * wide, device=dev)
    blk, pos = lane // wide, lane % wide
    real = pos < nlanes
    src = torch.where(real, (blk % B) * nlanes + pos, 0)

    def lanes(t, fill):   # a per-lane tensor (last axis lanes) re-laid
        out = t.to(dev)[..., src]
        return torch.where(real, out, torch.as_tensor(fill, dtype=t.dtype,
                                                      device=dev))

    shift = (blk // B * B * rans.NCTX * S).to(torch.int32)
    w_idx = torch.where(real, lanes(idx, 0) + shift,
                        (blk * rans.NCTX * S).to(torch.int32))
    w_enc = (w_idx.contiguous(), lanes(nsym, 0).contiguous(),
             fc.to(dev).repeat(reps), wide)
    words, counts, states = want
    w_want = (lanes(words.T, 0).T.contiguous(), lanes(counts, 0),
              lanes(states, rans.RANS_L))
    w_runs = []
    for (words_, st, fctx, nsym_, lut, fc_, _), plain in runs:
        fctx_w = torch.where(real, lanes(fctx, 0) + (blk // B * B)
                             * rans.NCTX, blk * rans.NCTX)
        w_runs.append(((lanes(words_.T, 0).T.contiguous(),
                        lanes(st, rans.RANS_L), fctx_w.contiguous(),
                        lanes(nsym_, 0), lut.to(dev).repeat(reps),
                        fc_.to(dev).repeat(reps), wide),
                       lanes(plain.T, 0).T.contiguous()))
    return w_enc, w_want, w_runs


@pytest.mark.parametrize("build", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("name", RANS_CARD_CASES)
def test_rans_walks_equal_plain(cuda, name, build):
    """The coder-1 encode and decode kernels against their plain
    versions (true and random states) on `rans_case`'s blocks: 4 to 45
    lanes a bsc block, a CUDA block straddling bsc blocks, a lane of the
    most words, tables with an f = 1 tail and zero-frequency gaps; at
    build 32 the case itself, else its blocks repeated (each padded to
    512 lanes) until the decode picks `build` lanes a block (encode:
    64 at 64, 128 from 128 on), past one wave of blocks at 512."""
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.bsclike import rans

    enc, want, runs = _rans_plain(name)
    lib = cuda_lib.library()
    if build == 32:
        enc = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in enc)
        runs = [(tuple(a.to(cuda) if torch.is_tensor(a) else a
                       for a in args), plain.to(cuda))
                for args, plain in runs]
        want = tuple(w.to(cuda) for w in want)
    else:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        B = enc[0].shape[1] // enc[3]
        blocks = -(-(sms + 1 if build == 512 else -(-sms * build // 512))
                   // B) * B
        enc, want, runs = _rans_wide(enc, want, runs, blocks, cuda)
    C, L = enc[0].shape
    S = enc[2].shape[0] // (L // enc[3] * rans.NCTX)
    assert lib.tplc_rans_decode_lanes(L, enc[3], S) == build
    assert lib.tplc_rans_encode_lanes(L, enc[3], C, S) == min(build, 128)
    n = rans.rans_encode_walk.launches
    got = rans.rans_encode_walk(*enc)
    torch.cuda.synchronize()
    assert rans.rans_encode_walk.launches == n + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for args, plain in runs:
        n = rans.rans_decode_walk.launches
        dec = rans.rans_decode_walk(*args)
        torch.cuda.synchronize()
        assert rans.rans_decode_walk.launches == n + 1
        assert torch.equal(dec, plain)


@functools.lru_cache(maxsize=None)
def _abc_plain(name):
    """An ABC_CARD_CASES case as `abc_encode` builds its walk arguments,
    with the plain walks' outputs -> (encode arguments, plain encode,
    decode runs [(arguments, plain decode)], syms, nsym)."""
    from tpulc_torch.codecs.bsclike import abc_kernels as ak
    from tpulc_torch.codecs.bsclike import rans_adaptive as ra

    syms, ms, inits, kind, wc = abc_case(name)
    B, cap = syms.shape
    lcap = cap // ra.ACHUNK
    st = torch.from_numpy(syms)
    ones, tot, lane_bits, lane_cls = ra.abc_stats(st, ms)
    if inits is None:
        inits = ra.quantize_inits(ones.numpy(), tot.numpy())
    inits = torch.from_numpy(inits.astype(np.int32))
    W = ra.bucket_bits(max(int(lane_bits.max()), 1))
    grid, nbits = ra.event_grid(st, ms, W)
    enc = (grid, nbits, inits, lcap)
    want = ak.abc_encode_walk_plain(*enc)
    words, counts, states = want
    nsym = ra._lane_counts(ms, B, lcap, ra.ACHUNK, torch.device("cpu"))
    nsteps = int(nbits.max())
    lane_cls = lane_cls.to(torch.int32)
    runs = []
    for st_, steps in ((abc_states(kind, states), nsteps),
                       (abc_states("random", states), nsteps), (states, 0)):
        args = (words[:, :wc].contiguous() if wc else words, st_, lane_cls,
                nsym, inits, lcap, steps, ra.ACHUNK)
        runs.append((args, ak.abc_decode_walk_plain(*args)))
    return enc, want, runs, st, nsym


@pytest.mark.parametrize("wide", [False, True], ids=["32lanes", "64lanes"])
@pytest.mark.parametrize("name", ABC_CARD_CASES)
def test_abc_walks_equal_plain(cuda, name, wide):
    """The adaptive coder's encode and decode kernels against their
    plain versions at each encode build: on the case's own 4 to 40
    lanes (32 lanes a block) and on its blocks repeated past one wave
    of blocks of 32 (64 lanes a block; every lane equals its
    original's): an empty lane and an empty block, the edge cases of
    `abc_case`, the decode from the case's, random and true states and
    at nsteps 0."""
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.bsclike import abc_kernels as ak
    from tpulc_torch.codecs.bsclike import rans_adaptive as ra

    enc, want, runs, syms, nsym = _abc_plain(name)
    grid, nbits, inits, lcap = enc
    L = grid.shape[1]
    lanes = cuda_lib.library().tplc_abc_encode_lanes
    reps = 1
    if wide:   # the fewest 32-lane blocks that take two waves
        blocks = next(b for b in range(1, 1 << 20) if lanes(32 * b) == 64)
        reps = 32 * blocks // L + 1
    assert L == inits.shape[0] * lcap
    assert lanes(L * reps) == (64 if wide else 32)
    n = ak.abc_encode_walk.launches
    got = ak.abc_encode_walk(grid.repeat(1, reps).to(cuda),
                             nbits.repeat(reps).to(cuda),
                             inits.repeat(reps, 1).to(cuda), lcap)
    torch.cuda.synchronize()
    assert ak.abc_encode_walk.launches == n + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.repeat((reps,) + (1,) * (w.dim() - 1)))
    for args, plain in runs:
        n = ak.abc_decode_walk.launches
        dec = ak.abc_decode_walk(*(
            a.repeat((reps,) + (1,) * (a.dim() - 1)).to(cuda)
            if torch.is_tensor(a) else a for a in args))
        torch.cuda.synchronize()
        assert ak.abc_decode_walk.launches == n + 1
        assert torch.equal(dec.cpu(), plain.repeat(reps, 1))
    words, counts, states = want
    valid = torch.arange(ra.ACHUNK)[None, :] < nsym[:, None].to(torch.int64)
    dec = ak.abc_decode_walk_plain(words, states, runs[0][0][2], nsym,
                                   inits, lcap, int(nbits.max()), ra.ACHUNK)
    assert torch.equal(torch.where(valid, dec, 0), torch.where(
        valid, syms.reshape(-1, ra.ACHUNK), 0))


@pytest.mark.parametrize("sorter,coder", [("st3", 1), ("st5", 2),
                                          ("st8", 2), ("st8w", 1),
                                          ("st8w", 2)])
def test_bsc_st_on_card_matches_cpu(cuda, sorter, coder):
    """The card writes the CPU path's bsc bytes on the ST sorters, and
    each decodes the other's."""
    from tpulc_torch.codecs.bsclike import driver as bsc

    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read()[:150000]
    kw = dict(block_size=1 << 16, sorter=sorter, coder=coder)
    on_card = bsc.compress(data, device="cuda", **kw)
    on_cpu = bsc.compress(data, device="cpu", **kw)
    assert on_card == on_cpu
    assert bsc.decompress(on_card, device="cuda") == data
    assert bsc.decompress(on_card, device="cpu") == data


@pytest.mark.parametrize("name,level", [("periodic", 9), ("text", 9),
                                        ("three_blocks", 1)])
def test_bzip2_on_card_equals_stdlib(cuda, name, level):
    """The card writes `bz2.compress`'s bytes (K1, the start tables and
    K2 once a block), and the host decoder reads them back."""
    import bz2

    from tpulc_torch.codecs.bwt import bzip2_codec

    with open("tests/data/pg1661.txt", "rb") as f:
        pg = f.read()
    data = {"periodic": b"abab" * 1000, "text": pg[:200000],
            "three_blocks": (pg[:100000] + b"\x00" * 5000) * 2
            + pg[:50000]}[name]
    n = mk.mtf_recency.launches
    comp = bzip2_codec.compress(data, level=level, device="cuda")
    torch.cuda.synchronize()
    assert comp == bz2.compress(data, level)
    assert mk.mtf_recency.launches == n + (3 if level == 1 else 1)
    assert bzip2_codec.decompress(comp, device="cuda") == data


@pytest.mark.parametrize("exact", [False, True], ids=["chains", "exact"])
def test_lzss_on_card_matches_cpu(cuda, exact):
    """The card writes the CPU path's lzss container over two blocks and
    a tail bucket, and each decodes the other's."""
    from tpulc_torch.codecs.lzss import driver as lzss

    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read()[:150000]
    on_card = lzss.compress(data, block_size=1 << 16, exact=exact,
                            device="cuda")
    on_cpu = lzss.compress(data, block_size=1 << 16, exact=exact,
                           device="cpu")
    assert on_card == on_cpu
    assert lzss.decompress(on_card, device="cuda") == data
    assert lzss.decompress(on_card, device="cpu") == data
    raw = lzss.compress_raw(data[:20000], exact=exact, device="cuda")
    assert raw == lzss.compress_raw(data[:20000], exact=exact, device="cpu")
    assert lzss.decompress_raw(raw, 20064, device="cuda") == data[:20000]


@pytest.mark.parametrize("name", ["pg150k", "mixed_raw", "short_tail"])
def test_culzss_on_card_matches_cpu(cuda, monkeypatch, name):
    """The card writes the CPU path's culzss container (compressed and
    raw packets, a short tail block), in groups of 8 and 5 packets, and
    each decodes the other's."""
    from tpulc_torch.codecs.lzss import culzss as core
    from tpulc_torch.codecs.lzss import culzss_driver as culzss

    monkeypatch.setattr(core, "ENCODE_GROUP", 8)
    monkeypatch.setattr(core, "DECODE_GROUP", 5)

    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read()[:150000]
    rng = np.random.default_rng(4)
    data = {"pg150k": text,
            "mixed_raw": text[:30000] + rng.integers(
                0, 256, size=20000).astype(np.uint8).tobytes(),
            "short_tail": text[:4096 * 3 + 17]}[name]
    on_card = culzss.compress(data, block_size=1 << 16, device="cuda")
    assert on_card == culzss.compress(data, block_size=1 << 16,
                                      device="cpu")
    assert culzss.decompress(on_card, device="cuda") == data
    assert culzss.decompress(on_card, device="cpu") == data


def test_dryrun_multichip_spawns_one_nccl_rank_a_card(cuda):
    """With no group and no device= the dry run spawns one NCCL rank a
    card; more ranks than cards raise before anything is spawned."""
    from tpulc_torch.dist.dryrun import dryrun_multichip

    dryrun_multichip(1)
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"needs {n} cards"):
        dryrun_multichip(n)


def test_dryrun_and_multihost_on_an_nccl_group_of_one(cuda):
    """tpulc's dry run on the port in an NCCL group of world size 1, and
    compress_multihost there writing the single-device container."""
    import torch.distributed as dist

    from tpulc_torch.dist.dryrun import dryrun_multichip, free_port
    from tpulc_torch.dist.multihost import compress_multihost

    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0)
    try:
        dryrun_multichip(1)
        with open("tests/data/pg1661.txt", "rb") as f:
            data = f.read()[:40000]
        assert compress_multihost(data, 16384, "bz", device="cuda") == \
            driver.compress(data, block_size=16384, device="cuda")
    finally:
        dist.destroy_process_group()


def _prim_cases():
    """name -> fn(device) over the same 50,000-element seeded inputs:
    the primitive layer's integer functions."""
    from tpulc_torch.primitives import cudpp_aux, histogram
    from tpulc_torch.primitives import parallel as par
    from tpulc_torch.primitives.dc3_device import suffix_array_dc3
    from tpulc_torch.primitives.suffix import sa_to_bwt, suffix_array

    n = 50_000
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32))
    flags = torch.from_numpy(rng.random(n) < 0.01)
    mask = torch.from_numpy(rng.random(n) < 0.3)
    buckets = torch.from_numpy(rng.integers(-3, 40, n).astype(np.int32))
    keys = torch.from_numpy(rng.integers(0, 500, n).astype(np.int32))
    order = rng.permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[order] = np.roll(order, -1)
    nxt = torch.from_numpy(nxt)
    with open("tests/data/pg1661.txt", "rb") as f:
        text = torch.from_numpy(np.frombuffer(f.read()[:n], np.uint8).copy())
    lines = text.clone()
    lines[lines == 10] = 0
    starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.nonzero(lines[:-1] == 0)[:, 0] + 1])
    ops = (torch.add, torch.maximum, torch.minimum, torch.bitwise_or)
    return {
        "scans": lambda d: [par.scan(x.to(d), op=op, exclusive=e, reverse=r)
                            for op in ops for e in (False, True)
                            for r in (False, True)
                            if not (e and op is torch.bitwise_or)],
        "multi_scan": lambda d: [par.multi_scan(x.view(50, -1).to(d), op=op,
                                                reverse=True) for op in ops],
        "segmented_scan": lambda d: [par.segmented_scan(x.to(d), flags.to(d),
                                                        op=op) for op in ops],
        "compact_reduce": lambda d: [*par.compact(x.to(d), mask.to(d)),
                                     *(par.reduce(x.to(d), op=op)
                                       for op in ops[:3])],
        "sorts": lambda d: [*par.sort_pairs(keys.to(d), x.to(d)),
                            par.merge_sorted(torch.sort(keys).values.to(d),
                                             torch.sort(x).values.to(d)),
                            *par.multisplit(x.to(d), buckets.to(d), 37)],
        "listrank": lambda d: [par.listrank(nxt.to(d), int(order[0]))],
        "suffix_arrays": lambda d: [suffix_array(text.to(d)),
                                    suffix_array_dc3(text.to(d)),
                                    *sa_to_bwt(text.to(d),
                                               suffix_array(text.to(d))),
                                    par.sort_strings_full(lines.to(d),
                                                          starts.to(d))],
        "histograms": lambda d: [
            histogram.byte_histogram(text.to(d)),
            histogram.batched_byte_histogram(text.view(10, -1).to(d), 200)],
        "md5_rand": lambda d: [cudpp_aux.md5_rand(n, 12345, device=d)],
    }


@pytest.mark.parametrize("name", ["scans", "multi_scan", "segmented_scan",
                                  "compact_reduce", "sorts", "listrank",
                                  "suffix_arrays", "histograms", "md5_rand"])
def test_integer_primitives_on_card_equal_cpu(cuda, name):
    """Every integer primitive gives the CPU's result on the card at
    50,000 elements."""
    fn = _prim_cases()[name]
    for got, want in zip(fn(cuda), fn(torch.device("cpu"))):
        torch.cuda.synchronize()
        assert got.is_cuda
        assert torch.equal(got.cpu(), want), name


def test_cuckoo_table_on_card(cuda):
    """A table of 2^16 keys built on the card: one winner a slot writes
    both the key and the value (the table equals the CPU's), and every
    lookup is right; absent keys are not found."""
    from tpulc_torch.primitives.cudpp_aux import CuckooTable

    rng = np.random.default_rng(17)
    n = 1 << 16
    keys = rng.choice(1 << 31, size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    on_card = CuckooTable(keys, vals, device=cuda)
    on_cpu = CuckooTable(keys, vals, device="cpu")
    for name in ("tk", "tv", "stash_k", "stash_v"):
        assert torch.equal(getattr(on_card, name).cpu(),
                           getattr(on_cpu, name)), name
    got, found = on_card.lookup(keys)
    assert bool(found.all())
    assert np.array_equal(got.cpu().numpy(), vals.astype(np.int64))
    absent = (keys.astype(np.uint64) + (1 << 31)).astype(np.uint32)
    assert not bool(on_card.lookup(absent)[1].any())


# ---------------------------------------------- running max/min scans

SCAN_SIZES = [1, 2, 3, 4095, 4096, 4097, 8191, 8193, 4096 * 1024 + 5,
              8192 * 600 + 3]


def _scan_input(kind, n, dtype):
    rng = np.random.default_rng(n + len(kind))
    info = np.iinfo(dtype)
    if kind == "random":
        x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    elif kind == "equal":
        x = np.full(n, 7, dtype)
    elif kind == "increasing":
        x = np.arange(n, dtype=dtype)
    elif kind == "decreasing":
        x = -np.arange(n, dtype=dtype)
    elif kind == "sentinels":   # rle.py's -1 / n + 1, rotsort's 1 << 30
        x = rng.choice(np.array([-1, n + 1, 1 << 30, info.min, info.max, 0],
                                dtype), n)
    else:
        raise KeyError(kind)
    return torch.from_numpy(x.astype(dtype))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", SCAN_SIZES)
def test_running_scans_equal_plain(cuda, n, dtype, reverse):
    """Both kernels equal their plain versions across tile boundaries
    (2,048 elements a tile up to 4096 x 1024 + 5, 2,049 tiles, so the
    look-back slides over several windows of 128; 8,192 at the last
    size, 601 tiles),
    on an aligned tensor and on a view that is not 16-byte aligned; one
    launch a call."""
    from tpulc_torch.primitives import scan_kernels as sk

    for kind in ("random", "equal", "increasing", "decreasing",
                 "sentinels"):
        x = _scan_input(kind, n, dtype)
        for kern, plain in ((sk.running_max, sk.running_max_plain),
                            (sk.running_min, sk.running_min_plain)):
            want = plain(x, reverse)
            for xc in (x.to(cuda), _shifted(x, cuda)):
                before = kern.launches
                got = kern(xc, reverse)
                torch.cuda.synchronize()
                assert kern.launches == before + 1
                assert got.dtype == x.dtype
                assert torch.equal(got.cpu(), want), (kind, kern.__name__)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_running_scans_called_50_times_equal_plain(cuda, reverse):
    """Both scans called 50 times in a row on 2^22 + 17 int64 elements
    (2,049 tiles of 2,048 whose blocks race through the look-back), each
    output equal to the plain version: a torn or early read of a tile's
    status word would show as a wrong prefix in some call."""
    from tpulc_torch.primitives import scan_kernels as sk

    n = (1 << 22) + 17
    rng = np.random.default_rng(17 + reverse)
    x = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    xc = x.to(cuda)
    for kern, plain in ((sk.running_max, sk.running_max_plain),
                        (sk.running_min, sk.running_min_plain)):
        want = plain(x, reverse).to(cuda)
        before = kern.launches
        outs = [kern(xc, reverse) for _ in range(50)]
        torch.cuda.synchronize()
        assert kern.launches == before + 50
        for k, got in enumerate(outs):
            assert torch.equal(got, want), (kern.__name__, k)


def test_running_scans_empty_and_refused_on_card(cuda):
    from tpulc_torch.primitives import scan_kernels as sk

    for kern in (sk.running_max, sk.running_min):
        before = kern.launches
        assert kern(torch.empty(0, dtype=torch.int64, device=cuda)).numel() == 0
        assert kern.launches == before
        with pytest.raises(ValueError):
            kern(torch.zeros(8, dtype=torch.float32, device=cuda))


# ------------------------------------------- anchored inverse-BWT walk

def _walk_block(src, n):
    if src == "pg1661":
        with open("tests/data/pg1661.txt", "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)
        return raw[1234: 1234 + n].copy()
    return np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)


WALK_CASES = [(src, S, n) for S in (512, 1024)
              for n in (1, S - 1, S, S + 1, 50_000)
              for src in ("pg1661", "random")]


def _walk_equal(T, last, anchors, n, S, cap, dev):
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik

    want = ik.anchored_walk_plain(T, last, anchors, n, S, cap)
    before = ik.anchored_walk.launches
    got = ik.anchored_walk(T.to(dev), last.to(dev), anchors.to(dev), n, S,
                           cap)
    torch.cuda.synchronize()
    assert ik.anchored_walk.launches == before + (n > 0)
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.parametrize("src,S,n", WALK_CASES,
                         ids=[f"{s}-S{S}-n{n}" for s, S, n in WALK_CASES])
def test_anchored_walk_equals_plain(cuda, src, S, n):
    """The rotation sort's inverse (cap = n) and the masked one (cap >
    n, lanes past n starting at idx0 and writing nothing), each equal
    to the plain walk and giving the block back."""
    from tpulc_torch.codecs.bwt import masked as pm
    from tpulc_torch.codecs.bwt import rotsort as prot

    data = _walk_block(src, n)
    last, _, anchors, ok = prot.bwt_encode_anchored(torch.from_numpy(data),
                                                    S)
    assert ok
    out = _walk_equal(prot._lf_map(last), last, anchors, n, S, n, cuda)
    assert np.array_equal(out.numpy(), data)
    cap = 51_000
    padded = np.zeros(cap, np.uint8)
    padded[:n] = data
    last, _, anchors, ok = pm.bwt_encode_masked_anchored(
        torch.from_numpy(padded), n, S)
    assert ok
    out = _walk_equal(pm._lf_map(last, n), last, anchors, n, S, cap, cuda)
    assert np.array_equal(out.numpy(), padded)


@pytest.mark.parametrize("lpw", [1, 2, 4, 8, 16, 32])
def test_anchored_walk_at_every_lanes_per_warp(cuda, lpw):
    """Every lanes a warp the kernel can pick writes the plain walk's
    bytes, on a ragged stride-512 block and a masked stride-1,024 one
    (the C entry point, which takes the lanes a warp; the wrapper lets
    the kernel pick), with int32 and int64 anchors; 3 lanes a warp and
    2-byte anchors are refused."""
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik
    from tpulc_torch.codecs.bwt import masked as pm

    lib = cuda_lib.library()
    for S, n, cap in ((512, 50_000, 50_000), (1024, 50_000, 51_000)):
        padded = np.zeros(cap, np.uint8)
        padded[:n] = _walk_block("pg1661", n)
        last, _, anchors, ok = pm.bwt_encode_masked_anchored(
            torch.from_numpy(padded), n, S)
        assert ok
        T = pm._lf_map(last, n)
        assert T.dtype == torch.int32   # the 4-byte entry
        want = ik.anchored_walk_plain(T, last, anchors, n, S, cap)
        Tc, lc = T.to(cuda), last.to(cuda)
        counts = torch.empty(256, dtype=torch.int32, device=cuda)
        for dtype in (torch.int32, torch.int64):
            ac = anchors.to(dtype).to(cuda)
            out = torch.full_like(lc, 0xAB)
            for w, width in ((lpw, ac.element_size()), (3, 8), (lpw, 2)):
                err = lib.tplc_anchored_walk(
                    Tc.data_ptr(), lc.data_ptr(), counts.data_ptr(),
                    ac.data_ptr(), width, out.data_ptr(), n, S, cap,
                    -(-n // S), w, cuda_lib.stream_of(Tc))
                assert (err == 0) == (w == lpw and width != 2)
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), want)
            assert torch.equal(counts.cpu(), torch.bincount(
                last[:n].long(), minlength=256).to(torch.int32))


def test_anchored_walk_on_real_blocks(cuda):
    """A real 900,000 B bz block (its int32 anchors, as the bz decoder
    gets them from the payload) and a stride-1,024 masked block with a
    ragged last lane, through both decoders on the card."""
    from tpulc_torch.codecs.bwt import masked as pm
    from tpulc_torch.codecs.bwt import rotsort as prot

    with open("tests/data/pg1661.txt", "rb") as f:
        raw = f.read()
    data = np.frombuffer((raw * 2)[:900_096], np.uint8).copy()
    blk = torch.from_numpy(data).to(cuda)
    last, _, anchors, ok = prot.bwt_encode_anchored(blk, 512)
    assert ok and anchors.dtype == torch.int32
    back = prot.bwt_decode_anchored(last, anchors, 512)
    assert np.array_equal(back.cpu().numpy(), data)
    _walk_equal(prot._lf_map(last.cpu()), last.cpu(), anchors.cpu(),
                data.shape[0], 512, data.shape[0], cuda)
    n, cap = 300_001, 1 << 19
    assert n % 1024
    padded = np.zeros(cap, np.uint8)
    padded[:n] = data[:n]
    last, _, anchors, ok = pm.bwt_encode_masked_anchored(
        torch.from_numpy(padded).to(cuda), n, 1024)
    assert ok
    back = pm.bwt_decode_masked_anchored(last, n, anchors.to(torch.int64),
                                         1024)
    assert np.array_equal(back.cpu().numpy(), padded)
    _walk_equal(pm._lf_map(last.cpu(), n), last.cpu(), anchors.cpu(), n,
                1024, cap, cuda)


def test_anchored_walk_refuses_and_survives_bad_anchors(cuda):
    """Too few anchors raise; an anchor past the table (a corrupt
    payload), as int32 or as an int64 whose low 32 bits name a row,
    reads nothing and writes zeros over its lane."""
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik
    from tpulc_torch.codecs.bwt import rotsort as prot

    data = _walk_block("pg1661", 3000)
    last, _, anchors, _ = prot.bwt_encode_anchored(torch.from_numpy(data),
                                                   512)
    T = prot._lf_map(last).to(cuda)
    lc, ac = last.to(cuda), anchors.to(cuda)
    with pytest.raises(ValueError):
        ik.anchored_walk(T, lc, ac[:-1], 3000, 512, 3000)
    lane1 = slice(3000 - 2 * 512, 3000 - 512)
    keep = np.ones(3000, bool)
    keep[lane1] = False
    for wide, row in ((ac, 1 << 30), (ac.long(), (1 << 32) + int(ac[0]))):
        bad = wide.clone()
        bad[1] = row
        out = ik.anchored_walk(T, lc, bad, 3000, 512, 3000).cpu().numpy()
        torch.cuda.synchronize()
        assert not out[lane1].any()
        assert np.array_equal(out[keep], data[keep])


def test_anchored_walk_zeroes_lanes_anchored_in_the_padding(cuda):
    """The anchor contract on a masked block (cap > n): an anchor in [n,
    cap), a padding row with no byte in C, reads nothing and writes
    zeros over its lane, as does a negative one, equal to the plain
    walk; the other lanes give the block back."""
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik
    from tpulc_torch.codecs.bwt import masked as pm

    S, n, cap = 512, 2_000, 3_000
    padded = np.zeros(cap, np.uint8)
    padded[:n] = _walk_block("pg1661", n)
    last, _, anchors, _ = pm.bwt_encode_masked_anchored(
        torch.from_numpy(padded), n, S)
    T = pm._lf_map(last, n)
    for a_dtype in (torch.int32, torch.int64):
        bad = anchors.to(a_dtype).clone()
        bad[1], bad[2], bad[3] = n, -1, cap - 1
        want = _walk_equal(T, last, bad, n, S, cap, cuda).numpy()
        keep = np.ones(cap, bool)
        for j in (1, 2, 3):
            run = slice(max(n - (j + 1) * S, 0), n - j * S)
            assert not want[run].any()
            keep[run] = False
        assert np.array_equal(want[keep], padded[keep])
