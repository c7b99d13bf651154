"""Edge-case inputs for K3 (the canonical Huffman chunk walk, whose
contract K7 shares), K8 (the flat walk), K4 (the MTF decode walk), K2
(the MTF encode walk), K1 (the MTF recency rows and the start tables'
tile maxima), the MTF start tables between K1 and K2, the adaptive
coder's two walks (symbol blocks whose binarization feeds them) and
coder 1's two walks (symbol blocks with their order-2 tables), made
from a numpy seed, with scalar references of the contracts.  The CPU
tests hold the plain versions to these references and to tpulc; the
card tests hold the CUDA kernels to the plain versions on the same
inputs."""

import numpy as np
import torch

from tpulc_torch.codecs.huffman.device_tables import (
    canonical_decode_params,
    package_merge_lengths_device,
)

K3_CASES = ("sorted", "equal", "nonmonotone", "tbits_pad", "ends_inside",
            "past_words", "corrupt", "hostile", "far")
K8_CASES = ("sorted", "nonnested", "bits_left", "past_stream", "nonmonotone",
            "far", "streams", "tables", "hostile")
K4_CASES = ("random", "zeros", "all255", "out_of_range", "nonperm",
            "negative_entries")
K2_CASES = ("random", "repeats", "duplicates", "absent", "int32")
START_CASES = ("text", "one_symbol", "all_symbols", "vanishing")
K1_CASES = ("random", "one_run", "long_runs", "out_of_range")
# the adaptive coder's walks: symbol blocks made as `abc_stats` and
# `event_grid` take them (ABC_CASES, each small enough for the CPU
# tests), and the card tests' larger blocks (ABC_CARD_CASES)
ABC_CASES = ("one_model", "alternate", "period3", "clip_inits",
             "full_and_empty", "lanes33", "states_top", "clamped_reads")
ABC_CARD_CASES = ("one", "three", "empty_lane", "lanes40", *ABC_CASES)
# coder 1's walks: blocks of RLE2-like symbols with their tables, as
# `rans_encode_ctx_batch` takes them (RANS_CASES, each small enough for
# the CPU tests against tpulc), and the card tests' (RANS_CARD_CASES)
RANS_CASES = ("straddle", "full_lane", "heavy_tail")
RANS_CARD_CASES = ("one", "three", "lanes33", "zero_words", *RANS_CASES)
# (nchunks, C): every chunk length the K1 tests take, at chunk counts of
# 0, 1, under every tile, and no multiple of any
K1_SHAPES = ((0, 128), (1, 128), (5, 128), (37, 128), (130, 128), (9, 1),
             (9, 5), (9, 31), (9, 127), (9, 129), (9, 300), (3, 5000))


def code_lengths(rng, L, nreal, nrand, S=257):
    """nreal + nrand code-length tables over S symbols: first optimal
    L-limited codes of skewed frequencies (some symbols absent), so that
    every length up to about L occurs; then random lengths, which
    over-subscribe the short codes (every window decodes at length 1 or
    2)."""
    ranks = np.arange(1, S + 1)[None, :] ** rng.uniform(0.7, 1.6, (nreal, 1))
    freqs = (1e6 / ranks).astype(np.int64) + 1
    freqs = np.take_along_axis(freqs, rng.permuted(
        np.tile(np.arange(S), (nreal, 1)), axis=1), axis=1)
    freqs[rng.random(freqs.shape) < 0.1] = 0
    real = package_merge_lengths_device(torch.from_numpy(freqs), L).numpy()
    return np.concatenate([real, rng.integers(0, L + 1, size=(nrand, S))])


def k3_case(name, C=16, L=12, B=2, ccap=150, W=400, seed=0):
    """-> (words int32[B, W], tbits[B], offs[B*ccap], lim, base [T, L+1],
    tab[B*ccap], C, L) as torch CPU tensors: `huffman_walk(*args)`.

    sorted       offsets ascending in each stream, ragged stream ends
    equal        every chunk of a stream starts at the same bit
    nonmonotone  offsets in random order
    tbits_pad    the last third of each stream's offsets == tbits (the
                 bz padding: chunks that are never active)
    ends_inside  tbits so small that most chunks end inside their window
    past_words   tbits beyond the W words: bits past W read as zero
    corrupt      no length ever matches (every step is the 1-bit guard)
    hostile      over-subscribed, negative and huge limits, junk bases
    far          offsets spread over a long stream in random order, so a
                 tile's span exceeds any shared-memory stage
    """
    rng = np.random.default_rng([seed, K3_CASES.index(name), C, L])
    if name == "far":
        W = 60_000
    nsub = B * ccap
    words = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64).astype(
        np.uint32)
    tbits = np.array([W * 32 - 19 - 300 * j for j in range(B)], np.int64)
    if name == "ends_inside":
        tbits = np.array([C * L * 3 + 7 + 40 * j for j in range(B)], np.int64)
    if name == "past_words":
        tbits = np.array([W * 32 + 100 + j for j in range(B)], np.int64)
    span = int(tbits.min()) if name == "ends_inside" else W * 32 + 40
    if name in ("sorted", "corrupt", "hostile", "past_words"):
        lo = W * 32 - 4 * C * L if name == "past_words" else 0
        offs = np.sort(rng.integers(max(lo, 0), span, size=(B, ccap)), axis=1)
    elif name == "equal":
        offs = np.repeat(rng.integers(0, span // 2, size=(B, 1)), ccap, 1)
    elif name in ("nonmonotone", "far", "ends_inside"):
        offs = rng.integers(0, span, size=(B, ccap))
    elif name == "tbits_pad":
        offs = np.sort(rng.integers(0, span, size=(B, ccap)), axis=1)
        offs[:, 2 * ccap // 3:] = tbits[:, None]
    else:
        raise ValueError(name)
    T = 5
    lens = code_lengths(rng, L, 3, 2)
    lim, base, _ = (t.numpy() for t in canonical_decode_params(
        torch.from_numpy(lens), L))
    if name == "corrupt":
        lim = np.zeros_like(lim)
    if name == "hostile":
        lim = rng.integers(-(1 << L), 1 << (L + 1), size=lim.shape)
        lim[0] = rng.integers(-2**31, 2**31, size=lim.shape[1])
        base = rng.integers(-300, 600, size=base.shape)
    tab = rng.integers(-1, T + 1, size=nsub)   # clamped to [0, T)
    t = torch.from_numpy
    return (t(words.view(np.int32)), t(tbits.astype(np.int32)),
            t(offs.reshape(-1).astype(np.int32)),
            t(np.ascontiguousarray(lim).astype(np.int32)),
            t(np.ascontiguousarray(base).astype(np.int32)),
            t(tab.astype(np.int32)), C, L)


def k3_reference(words, tbits, offs, lim, base, tab, C, L):
    """Scalar K3/K7 contract, one chunk and one bit at a time: first-hit
    chain, length 1 and index 0 when nothing hits, end = min(tbits,
    offs + C*L), 0 at or past end, bits past W zero -> int64[nsub, C]."""
    words = words.numpy().view(np.uint32)
    B, W = words.shape
    bits = [np.unpackbits(w.astype(">u4").view(np.uint8)) for w in words]
    offs = offs.numpy().view(np.uint32).astype(np.int64)
    lim, base = lim.numpy().astype(np.int64), base.numpy().astype(np.int64)
    tab = np.clip(tab.numpy(), 0, lim.shape[0] - 1)
    nsub = offs.shape[0]
    out = np.zeros((nsub, C), np.int64)
    for c in range(nsub):
        b, t = c // (nsub // B), tab[c]
        pos = int(offs[c])
        end = min(int(tbits[b]), pos + C * L)
        for s in range(C):
            if pos >= end:
                break
            win = 0
            for j in range(L):
                win = (win << 1) | (int(bits[b][pos + j])
                                    if pos + j < W * 32 else 0)
            ln, ci = 1, 0
            for l in range(1, L + 1):
                if (win >> (L - l)) < lim[t, l]:
                    ln, ci = l, base[t, l] + (win >> (L - l))
                    break
            out[c, s] = ci
            pos += ln
    return out


def k8_case(name, C=16, L=12, B=2, ccap=256, W=400, seed=0):
    """-> (words int32[B, W], offs[B*ccap], bits_left[B*ccap], lj, base
    [B*ccap/128, L+1], C, L) as torch CPU tensors:
    `huffman_walk_flat(*args)`.  ccap is a multiple of 128 (a table tile);
    each tile takes one of 5 canonical tables (4 optimal codes, 1 of
    random lengths), its limits left-justified, and bits_left is
    ``min(tbits[b] - offs[c], C*L)`` (as `flat_args` makes them) unless
    the case says otherwise.

    sorted       offsets ascending in each stream, ragged stream ends
    nonnested    random left-justified limits in [0, 2^L), unsorted: the
                 count rule and the first-hit rule part ways
    bits_left    bits_left above C*L, equal to 0, negative, or short
    past_stream  a third of the offsets past the W words, some near 2^32
                 (negative as int32): those chunks read zeros
    nonmonotone  offsets in random order
    far          offsets spread over a long stream in random order, so a
                 tile's span exceeds any shared-memory stage
    streams      5 streams of different lengths
    tables       tables that repeat over runs of tiles and then change
    hostile      limits and bases of any int32 (the index summed in 64
                 bits before the clip)
    """
    rng = np.random.default_rng([seed, K8_CASES.index(name), C, L])
    if name == "far":
        W = 60_000
    if name == "streams":
        B = 5
    nsub = B * ccap
    words = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64).astype(
        np.uint32)
    tbits = np.array([W * 32 - 19 - 300 * j for j in range(B)], np.int64)
    span = W * 32 + 40
    if name in ("nonmonotone", "far"):
        offs = rng.integers(0, span, size=(B, ccap))
    else:
        offs = np.sort(rng.integers(0, span, size=(B, ccap)), axis=1)
    left = np.minimum(tbits[:, None] - offs, C * L)
    if name == "past_stream":
        past = rng.random(size=offs.shape) < 1 / 3
        far = rng.integers(W * 32, 1 << 32, size=offs.shape)
        far[:, ::7] = (1 << 32) - rng.integers(1, 64, size=far[:, ::7].shape)
        offs = np.where(past, far, offs)
        left = np.where(past, rng.integers(1, 2 * C * L, size=offs.shape),
                        left)
    if name == "bits_left":
        pick = rng.integers(0, 4, size=offs.shape)
        left = np.select([pick == 0, pick == 1, pick == 2],
                         [rng.integers(C * L + 1, 2**31, size=offs.shape), 0,
                          rng.integers(-2**31, 0, size=offs.shape)],
                         rng.integers(1, C * L, size=offs.shape))
    T = nsub // 128
    lens = code_lengths(rng, L, 4, 1)
    lim, base, _ = (t.numpy().astype(np.int64) for t in
                    canonical_decode_params(torch.from_numpy(lens), L))
    lj5 = lim << (L - np.arange(L + 1))
    if name == "tables":
        pick = (np.arange(T) // 3) % 5
    else:
        pick = rng.integers(0, 5, size=T)
    lj, base = lj5[pick], base[pick]
    if name == "nonnested":
        lj = rng.integers(0, 1 << L, size=lj.shape)
    if name == "hostile":
        lj = rng.integers(-2**31, 2**31, size=lj.shape)
        lj[:, 1::2] = rng.integers(-(1 << L), 1 << (L + 1),
                                   size=lj[:, 1::2].shape)
        base = rng.integers(-2**31, 2**31, size=base.shape)
        base[::2] = rng.integers(-300, 600, size=base[::2].shape)
    t = torch.from_numpy
    return (t(words.view(np.int32)),
            t(offs.reshape(-1).astype(np.uint32).view(np.int32)),
            t(left.reshape(-1).astype(np.int32)),
            t(np.ascontiguousarray(lj).astype(np.int32)),
            t(np.ascontiguousarray(base).astype(np.int32)), C, L)


def k8_reference(words, offs, bits_left, lj, base, C, L):
    """Scalar K8 contract, one chunk and one bit at a time: table
    c // 128, length 1 + #{l < L: win >= lj[l]}, valid iff win < lj[L]
    (else length 1, index 0), index base[length] + the window's top
    `length` bits, emit while bits_left > 0, bits past W zero ->
    int64[nsub, C] (unclipped)."""
    words = words.numpy().view(np.uint32)
    B, W = words.shape
    bits = [np.unpackbits(w.astype(">u4").view(np.uint8)) for w in words]
    offs = offs.numpy().view(np.uint32).astype(np.int64)
    left = bits_left.numpy().astype(np.int64)
    lj, base = lj.numpy().astype(np.int64), base.numpy().astype(np.int64)
    nsub = offs.shape[0]
    out = np.zeros((nsub, C), np.int64)
    for c in range(nsub):
        b, t = c // (nsub // B), c // 128
        pos, bl = int(offs[c]), int(left[c])
        for s in range(C):
            if bl <= 0:
                break
            win = 0
            for j in range(L):
                win = (win << 1) | (int(bits[b][pos + j])
                                    if pos + j < W * 32 else 0)
            ln = 1 + sum(win >= lj[t, l] for l in range(1, L))
            found = win < lj[t, L]
            ln = ln if found else 1
            out[c, s] = base[t, ln] + (win >> (L - ln)) if found else 0
            bl -= ln
            pos += ln
    return out


def k4_case(name, nchunks=16, C=128, seed=0):
    """-> (table0 int32[nchunks, 256], ranks int32[nchunks, C]) as torch
    CPU tensors: `mtf_lockstep(*args)`.

    random            permutation tables, ranks over [0, 256)
    zeros / all255    every rank 0 / 255
    out_of_range      ranks in [-400, 700): the contract clamps them
    nonperm           tables with repeated non-negative entries
    negative_entries  tables of any int32, negative ones included
    """
    rng = np.random.default_rng([seed, K4_CASES.index(name), nchunks, C])
    t0 = np.stack([rng.permutation(256) for _ in range(nchunks)])
    ranks = rng.integers(0, 256, size=(nchunks, C))
    ranks[::3] = rng.integers(0, 6, size=ranks[::3].shape)  # post-BWT-like
    if name == "zeros":
        ranks[:] = 0
    elif name == "all255":
        ranks[:] = 255
    elif name == "out_of_range":
        ranks = rng.integers(-400, 700, size=(nchunks, C))
    elif name == "nonperm":
        t0 = rng.integers(0, 40, size=(nchunks, 256))
    elif name == "negative_entries":
        t0 = rng.integers(-2**31, 2**31, size=(nchunks, 256))
    elif name != "random":
        raise ValueError(name)
    return (torch.from_numpy(t0.astype(np.int32)),
            torch.from_numpy(ranks.astype(np.int32)))


def k4_reference(table0, ranks):
    """Scalar MTF by rank: list pop and insert, ranks clamped to
    [0, 255] -> (symbols int64[nchunks, C], final tables)."""
    nchunks, C = ranks.shape
    syms = np.zeros((nchunks, C), np.int64)
    tabs = np.zeros((nchunks, 256), np.int64)
    for c in range(nchunks):
        tab = [int(x) for x in table0[c]]
        for s in range(C):
            r = min(max(int(ranks[c, s]), 0), 255)
            v = tab.pop(r)
            tab.insert(0, v)
            syms[c, s] = v
        tabs[c] = tab
    return syms, tabs


def k2_case(name, nchunks=16, C=128, seed=0):
    """-> (table0 int32[nchunks, 256], syms int32[nchunks, C]) as torch
    CPU tensors: `mtf_encode_lockstep(*args)`.

    random      permutation tables, symbols over [0, 256)
    repeats     permutation tables, 90 % of the steps repeat the step
                before; every third chunk starts with its table's front
                symbol (step 0 at rank 0)
    duplicates  tables with repeated entries in [0, 40), symbols in
                [0, 48): first matches, and absent symbols
    absent      permutation tables, symbols in [-300, 600)
    int32       tables of any int32; half the symbols drawn from the
                chunk's table, half any int32
    """
    rng = np.random.default_rng([seed, K2_CASES.index(name), nchunks, C])
    t0 = np.stack([rng.permutation(256) for _ in range(nchunks)])
    syms = rng.integers(0, 256, size=(nchunks, C))
    if name == "repeats":
        rep = rng.random(size=syms.shape) < 0.9
        for i in range(1, C):
            syms[:, i] = np.where(rep[:, i], syms[:, i - 1], syms[:, i])
        if C:
            syms[::3, 0] = t0[::3, 0]
    elif name == "duplicates":
        t0 = rng.integers(0, 40, size=(nchunks, 256))
        syms = rng.integers(0, 48, size=(nchunks, C))
        syms[:, 1::2] = syms[:, :-1:2][:, : syms[:, 1::2].shape[1]]
    elif name == "absent":
        syms = rng.integers(-300, 600, size=(nchunks, C))
    elif name == "int32":
        t0 = rng.integers(-2**31, 2**31, size=(nchunks, 256))
        pick = np.take_along_axis(t0, rng.integers(0, 256, size=(nchunks, C)),
                                  axis=1)
        syms = np.where(rng.random(size=(nchunks, C)) < 0.5, pick,
                        rng.integers(-2**31, 2**31, size=(nchunks, C)))
    elif name != "random":
        raise ValueError(name)
    return (torch.from_numpy(t0.astype(np.int32)),
            torch.from_numpy(syms.astype(np.int32)))


def k2_reference(table0, syms):
    """Scalar MTF by symbol: the first position holding the symbol (list
    index), moved to the front; an absent symbol gets rank 0 and
    overwrites position 0 -> (ranks int64[nchunks, C], final tables)."""
    nchunks, C = syms.shape
    ranks = np.zeros((nchunks, C), np.int64)
    tabs = np.zeros((nchunks, 256), np.int64)
    for c in range(nchunks):
        tab = [int(x) for x in table0[c]]
        for s in range(C):
            v = int(syms[c, s])
            if v in tab:
                r = tab.index(v)
                tab.insert(0, tab.pop(r))
            else:
                r, tab[0] = 0, v
            ranks[c, s] = r
        tabs[c] = tab
    return ranks, tabs


def k1_case(name, nchunks, C, seed=0):
    """-> symbols int32[nchunks, C]: K1's input.

    random        uniform over [0, 256)
    one_run       every chunk one run of one symbol (a new one a chunk)
    long_runs     runs of 1 to 300 steps over 20 symbols, as after a BWT
    out_of_range  long runs of in-range symbols, symbols below 0 and at
                  or above 256 (-2^31, -1, 256, 300, 2^31 - 1), which K1
                  ignores
    """
    rng = np.random.default_rng([seed, K1_CASES.index(name), nchunks, C])
    n = nchunks * C
    if name == "random":
        d = rng.integers(0, 256, size=n)
    elif name == "one_run":
        d = np.repeat(rng.integers(0, 256, size=nchunks), C)
    elif name in ("long_runs", "out_of_range"):
        lens = rng.integers(1, 301, size=n + 1)
        syms = rng.integers(0, 20, size=lens.shape[0])
        if name == "out_of_range":
            odd = np.array([-2**31, -1, 256, 300, 2**31 - 1])
            bad = rng.random(lens.shape[0]) < 0.3
            syms[bad] = rng.choice(odd, size=int(bad.sum()))
        d = np.repeat(syms, lens)[:n]
    else:
        raise ValueError(name)
    return torch.from_numpy(d.astype(np.int32).reshape(nchunks, C))


def k1_reference(syms):
    """Scalar K1: the last step of each symbol in [0, 256) a chunk, -1 if
    absent -> int64[nchunks, 256]."""
    out = np.full((syms.shape[0], 256), -1, np.int64)
    for c, row in enumerate(np.asarray(syms).tolist()):
        for t, v in enumerate(row):
            if 0 <= v < 256:
                out[c, v] = t
    return out


def start_case(name, nchunks, seed=0):
    """-> (symbols uint8[nchunks, C], C): a block whose K1 rows feed the
    start tables.  C is 128, and 256 for all_symbols.

    text         a skewed 64-letter alphabet
    one_symbol   every step the same symbol
    all_symbols  every chunk a permutation of all 256 symbols
    vanishing    a few symbols in the first chunks only, another set that
                 vanishes for dozens of chunks and comes back, all 256
                 in the last chunk
    """
    rng = np.random.default_rng([seed, START_CASES.index(name), nchunks])
    C = 256 if name == "all_symbols" else 128
    if name == "text":
        p = 1.0 / np.arange(1, 65)
        d = rng.choice(np.arange(32, 96), size=(nchunks, C), p=p / p.sum())
    elif name == "one_symbol":
        d = np.full((nchunks, C), 7)
    elif name == "all_symbols":
        d = np.stack([rng.permutation(256) for _ in range(nchunks)])
    elif name == "vanishing":
        d = rng.integers(100, 110, size=(nchunks, C))
        d[: min(nchunks, 3)] = rng.integers(0, 20, size=(min(nchunks, 3), C))
        back = np.arange(nchunks) % 40 >= 30
        d[back, ::4] = rng.integers(200, 230, size=d[back, ::4].shape)
        d[-1] = np.resize(rng.permutation(256), C)
    else:
        raise ValueError(name)
    return d.astype(np.uint8), C


def start_reference(syms):
    """The serial MTF from the identity over the whole block, its table
    taken before every chunk -> int64[nchunks, 256]."""
    nchunks, C = syms.shape
    tab = list(range(256))
    out = np.zeros((nchunks, 256), np.int64)
    for c in range(nchunks):
        out[c] = tab
        for v in syms[c].tolist():
            tab.insert(0, tab.pop(tab.index(v)))
    return out


def abc_case(name, chunk=1024):
    """-> (syms int32[B, lcap * chunk], ms int32[B], inits uint16[B, 117]
    or None for `quantize_inits` of the block's statistics, states, Wc):
    the decode walk runs from the encode's states ("true"), from 2^32 -
    1 - l ("top") or from seeded random states ("random"), on the
    encode's words cut to Wc columns (None: all W + 2).

    one_model       every symbol 0: every event on model 0, bit 1 (the
                    forwarding of the last event's adapted value)
    alternate       every symbol 1: models 5 and 33 in turn (forwarded
                    from two events back)
    period3         every symbol 2: models 10, 34, 42 in turn (read
                    back from shared memory)
    clip_inits      inits at the clip bounds, 8 and 4088 by turns
    full_and_empty  a lane of 1,024 zeros whose bit count is the grid's
                    width W, and a lane with no events
    lanes33         33 lanes, no multiple of 32, 64 or 128
    states_top      decode from states near 2^32 - 1
    clamped_reads   decode from random states on 3 columns of words,
                    every refill past the second read at column Wc - 1
    the card's four more (one, three, empty_lane, lanes40): 4 to 40
    lanes of geometric symbols, an empty lane and an empty block
    """
    seeds = {"one": 1, "three": 3, "empty_lane": 5, "lanes40": 40}
    rng = np.random.default_rng(seeds[name] if name in seeds
                                else ABC_CASES.index(name) + 41)
    inits, states, wc = None, "true", None
    B, lcap, ms = {"one": (1, 4, [3333]), "three": (3, 2, [2048, 701, 1537]),
                   "empty_lane": (2, 3, [2048, 0]),
                   "lanes40": (4, 10, [10240, 9000, 77, 5000]),
                   "full_and_empty": (1, 2, [chunk]),
                   "lanes33": (3, 11, [11 * chunk, 4000, 9000]),
                   "clip_inits": (2, 2, [2 * chunk, 1500])}.get(
                       name, (1, 2, [2 * chunk]))
    syms = np.minimum(rng.geometric(0.6 if name == "lanes33" else 0.3,
                                    size=(B, lcap * chunk)) - 1, 256)
    syms[0, :40] = 256  # the longest binarization, 16 events
    if name in ("one_model", "full_and_empty"):
        syms[:] = 0
    elif name in ("alternate", "period3"):
        syms[:] = 1 if name == "alternate" else 2
    if name == "clip_inits":
        inits = np.where(np.arange(117) % 2 == 0, 8, 4088)[None].repeat(B, 0)
        inits = inits.astype(np.uint16)
    if name == "states_top":
        states = "top"
    if name == "clamped_reads":
        states, wc = "random", 3
    return (syms.astype(np.int32), np.asarray(ms, np.int32), inits, states,
            wc)


def abc_states(kind, states):
    """The decode walk's int64 states for `abc_case`'s kind, beside the
    encode's `states`."""
    L = states.shape[0]
    if kind == "top":
        return (1 << 32) - 1 - torch.arange(L, dtype=torch.int64)
    if kind == "random":
        return torch.from_numpy(np.random.default_rng(7).integers(
            0, 1 << 32, L, dtype=np.uint64).astype(np.int64))
    return states


def rans_tables(kind):
    """One explicit quantised table (int32[257], sum 2^14) of `rans_case`:
    "flat1" symbol 0 at 2^14 - 256 and every other symbol at 1;
    "tail" symbols 0-7 large, the even symbols from 8 at 1 and the odd
    ones from 9 absent (zero-frequency gaps)."""
    f = np.zeros(257, np.int32)
    if kind == "flat1":
        f[:] = 1
        f[0] = (1 << 14) - 256
    else:
        f[8::2] = 1
        f[:8] = (8000, 4000, 2000, 1000, 600, 400, 200, 60)
        f[0] += (1 << 14) - f.sum()
    return f


def rans_case(name, chunk=512):
    """-> (syms int32[B, cap], ms, fq int32[B * 32, 257]): B blocks of cap
    symbols (zeros past each block's m), their order-2 contexts'
    quantised tables.

    one, three      1 and 3 blocks of geometric ranks, 8 and 12 lanes
    lanes33         33 lanes, no multiple of 32
    zero_words      every symbol 0: each context holds one symbol (f =
                    2^14) and no lane emits a word
    straddle        3 blocks of 45 lanes: a CUDA block of 32 or more
                    lanes would take lanes of two bsc blocks
    full_lane       every table "flat1" (all 257 symbols present, 256 at
                    f = 1); lane 0 of each block codes symbols 1-256
                    twice, 14 bits a step, so it emits the most words a
                    lane of 512 steps can (448 of the row's C + 2)
    heavy_tail      every table "tail"; half the symbols from the f = 1
                    tail, so lanes emit most steps
    """
    from tpulc_torch.codecs.bsclike import rans

    seeds = {"straddle": 21, "full_lane": 22, "heavy_tail": 23}
    rng = np.random.default_rng(seeds.get(name, len(name)))
    B, cap, ms = {"one": (1, 4096, [3333]),
                  "three": (3, 2048, [2048, 701, 1537]),
                  "lanes33": (3, chunk * 11, [5632, 4000, 100]),
                  "zero_words": (2, 2048, [2000, 1500]),
                  "straddle": (3, chunk * 45, [chunk * 45, chunk * 30 + 7,
                                               chunk * 44 + 300]),
                  "full_lane": (2, chunk * 9, [chunk * 9, chunk * 4 + 5]),
                  "heavy_tail": (2, chunk * 40, [chunk * 40,
                                                 chunk * 17 + 100]),
                  }[name]
    syms = np.minimum(rng.geometric(0.3, size=(B, cap)) - 1, 256)
    if name == "zero_words":
        syms[:] = 0
    elif name == "full_lane":
        syms[:, :chunk] = np.tile(np.arange(1, 257), 2)
    elif name == "heavy_tail":
        tail = rng.integers(4, 128, size=(B, cap)) * 2
        syms = np.where(rng.random((B, cap)) < 0.5, tail,
                        np.minimum(syms, 7))
    for b in range(B):
        syms[b, ms[b]:] = 0
    syms = syms.astype(np.int32)
    if name in ("full_lane", "heavy_tail"):
        fq = np.tile(rans_tables("flat1" if name == "full_lane" else "tail"),
                     (B * rans.NCTX, 1))
    else:
        fqs = []
        for b in range(B):
            ctx = rans.ctx_of_stream(torch.from_numpy(syms[b])).numpy()
            h = np.zeros((rans.NCTX, 257), np.int64)
            np.add.at(h, (ctx[: ms[b]], syms[b, : ms[b]]), 1)
            fqs.append(rans.normalize_freqs_ctx(h))
        fq = np.concatenate(fqs)
    return syms, np.asarray(ms, np.int32), fq.astype(np.int32)


def rans_walk_args(syms, ms, fq, chunk=512):
    """`rans_case`'s blocks as the walks take them -> (idx int32[C, L],
    nsym int32[L], fc packed int32, lut int16 slot table, fctx int64[L],
    nlanes), lanes block-major (`rans_encode_ctx_batch`'s layout)."""
    from tpulc_torch.codecs.bsclike import rans

    B, cap = syms.shape
    st = torch.from_numpy(syms)
    fq = torch.from_numpy(fq)
    cum = torch.cat([torch.zeros(fq.shape[0], 1, dtype=torch.int32),
                     fq.cumsum(1)[:, :-1].to(torch.int32)], 1)
    ctx = torch.stack([rans.ctx_of_stream(s) for s in st])
    gctx = ctx + (torch.arange(B, dtype=torch.int32) * rans.NCTX)[:, None]
    nlanes = cap // chunk
    L = B * nlanes
    idx = (gctx * 257 + st).reshape(L, chunk).T.contiguous()
    nsym = rans._lane_counts(ms, B, nlanes, chunk, torch.device("cpu"))
    fctx = gctx.reshape(L, chunk)[:, 0].to(torch.int64)
    return (idx, nsym, rans.packed_table(fq, cum), rans.slot_table(fq, cum),
            fctx, nlanes)
