"""What the CUDA designs of K3, K7, K8 and K4 must get right, pinned on
the CPU: the plain versions (the card's arbiters) against scalar
references of the contracts on every edge case of
`test_torch_walk_cases`, and against tpulc on the same inputs.

tpulc's own CPU suite does not run its buffered Pallas walk (the
XLA:CPU compile of its interpret graph is slow beyond use), so K3 is
held to tpulc's XLA rank decoder on real containers instead; K4 is held
to tpulc's Pallas kernel in interpret mode.  tpulc leaves ranks outside
[0, 255] and negative table entries undefined: there the tests pin the
plain version's documented behaviour (ranks clamped, entries moved as
they are) to the scalar reference.  Integers throughout: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_walk_cases import (
    K3_CASES,
    K4_CASES,
    K8_CASES,
    code_lengths,
    k3_case,
    k3_reference,
    k4_case,
    k4_reference,
    k8_case,
    k8_reference,
)

from tpulc.codecs.huffman import driver as jdrv
from tpulc.pipeline.container import Container as JContainer
from tpulc.primitives import mtf_pallas
from tpulc_torch.codecs.huffman import decode as hdec
from tpulc_torch.codecs.huffman import decode_kernels as dk
from tpulc_torch.codecs.huffman.device_tables import canonical_decode_params
from tpulc_torch.primitives import mtf_kernels as mk
from tpulc_torch.primitives.mtf import mtf_decode

torch.set_num_threads(1)


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("L", [12, 15])
@pytest.mark.parametrize("name", K3_CASES)
def test_k3_plain_matches_the_contract(name, L):
    """Unpacked and packed, B = 2 streams of 150 chunks (no multiple of
    128), 5 tables picked at random (indices clamped)."""
    args = k3_case(name, C=16, L=L, ccap=150 if name != "far" else 40)
    want = k3_reference(*args)
    got = dk.huffman_walk(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    packed = dk.huffman_walk(*args, packed=True)
    assert packed.shape == (want.shape[0], 4)
    np.testing.assert_array_equal(
        packed.numpy().view(np.uint8).reshape(want.shape),
        np.clip(want, 0, 255))
    if name == "corrupt":
        assert not want.any()
    if name == "tbits_pad":
        assert not want.reshape(2, 150, 16)[:, 100:].any()


def test_k3_kernel_knobs_are_checked_and_change_nothing_on_the_cpu():
    args = k3_case("sorted")
    want = dk.huffman_walk(*args)
    for tile in dk.WALK_TILES:
        assert torch.equal(dk.huffman_walk(*args, tile=tile), want)
        assert torch.equal(dk.huffman_walk(*args, packed=True, tile=tile),
                           dk.huffman_walk(*args, packed=True))
    with pytest.raises(ValueError, match="tile"):
        dk.huffman_walk(*args, tile=48)


@pytest.mark.parametrize("max_len", [9, 12])
def test_k3_packed_equals_tpulc_on_ragged_multi_stream_groups(max_len):
    """3 blocks of 20,000 B at chunk_syms 16: 1,250 chunks a stream (no
    multiple of 128), the last block partial, so its stream ends inside
    a chunk's window; K3 packed's symbols equal tpulc's rank decoder.
    (That decoder stops at max_len 12; L = 15 against tpulc is
    `test_torch_huffman_walk.py`'s multi-table bz block.)"""
    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read(55_000)
    comp = jdrv.compress(data, block_size=20_000, chunk_syms=16,
                         max_len=max_len)
    c = JContainer.from_bytes(comp)
    words, tbits, lens, offs, ns, chunk = jdrv._parse_aligned_group(
        c.payloads, c.block_size, max_len)
    B = len(ns)   # the parse may pad the group with empty streams
    words, tbits, lens, offs = words[:B], tbits[:B], lens[:B], offs[:B]
    assert offs.shape == (3, 1250) and chunk == 16
    want = np.asarray(jdrv._decode_batch_ranks(
        jnp.asarray(words), jnp.asarray(tbits), jnp.asarray(lens),
        jnp.asarray(offs), chunk, max_len))
    t = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
         if a.dtype == np.uint32 else torch.from_numpy(a)
         for a in (words, tbits, lens, offs)]
    got = hdec.huffman_decode_buffered_batch(*t, chunk, max_len)
    for j, n in enumerate(ns):
        np.testing.assert_array_equal(got.numpy()[j, :n], want[j, :n])


# ------------------------------------------------------------ K7, K8

@pytest.mark.parametrize("L", [12, 15])
@pytest.mark.parametrize("name", K3_CASES)
def test_k7_plain_matches_the_contract(name, L):
    """K7's contract is K3 unpacked's: the same cases, the same scalar
    reference (int32 indices, unclipped)."""
    args = k3_case(name, C=16, L=L, ccap=150 if name != "far" else 40)
    want = k3_reference(*args)
    got = dk.huffman_walk_v1(*args)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", [12, 15])
@pytest.mark.parametrize("name", K8_CASES)
def test_k8_plain_matches_the_count_rule(name, L):
    """Two (five: "streams") streams of 256 chunks, a table a 128-chunk
    tile, packed ranks clip(index, 0, 255)."""
    args = k8_case(name, C=16, L=L)
    want = k8_reference(*args)
    got = dk.huffman_walk_flat(*args)
    assert got.shape == (want.shape[0], 4)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint8).reshape(want.shape),
        np.clip(want, 0, 255))
    if name == "bits_left":
        dead = args[2].numpy() <= 0
        assert dead.any() and not want[dead].any()


def test_count_rule_and_first_hit_part_ways_on_a_non_nested_table():
    """On a canonical table K8's count rule and K3's first-hit rule give
    the same symbols; with two left-justified limits swapped (no longer
    nested) they do not, and each walk keeps to its own rule.  So the
    card's K8 window table must be built by the count rule."""
    L, C = 12, 16
    rng = np.random.default_rng(11)
    lens = torch.from_numpy(code_lengths(rng, L, 1, 0))
    lim, base, _ = canonical_decode_params(lens, L)
    lj = (lim.long() << (L - torch.arange(L + 1))).int()
    words = torch.from_numpy(rng.integers(0, 1 << 32, size=(1, 300),
                                          dtype=np.uint64).astype(np.uint32)
                             .view(np.int32))
    offs = torch.from_numpy(np.sort(rng.integers(0, 9000, 128)).astype(
        np.int32))
    left = torch.full((128,), C * L, dtype=torch.int32)
    tbits = torch.tensor([300 * 32], dtype=torch.int32)
    tab = torch.zeros(128, dtype=torch.int32)
    swapped = lj.clone()
    swapped[0, [4, 6]] = lj[0, [6, 4]]
    assert (swapped[0, 1:].diff() < 0).any()
    for table, same in ((lj, True), (swapped, False)):
        flat = (words, offs, left, table, base, C, L)
        k8 = dk.huffman_walk_flat(*flat)
        first = (words, tbits, offs, table >> (L - torch.arange(L + 1)).int(),
                 base, tab, C, L)
        k3 = dk.huffman_walk(*first, packed=True)
        assert torch.equal(k8, k3) == same
        np.testing.assert_array_equal(
            k8.numpy().view(np.uint8).reshape(128, C),
            np.clip(k8_reference(*flat), 0, 255))
        np.testing.assert_array_equal(
            k3.numpy().view(np.uint8).reshape(128, C),
            np.clip(k3_reference(*first), 0, 255))


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("name", K4_CASES)
def test_k4_plain_matches_the_contract(name):
    t0, ranks = k4_case(name, nchunks=5, C=128)
    want_s, want_t = k4_reference(t0.numpy(), ranks.numpy())
    got_s, got_t = mk.mtf_lockstep(t0, ranks)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


@pytest.mark.parametrize("name", ["random", "zeros", "all255", "nonperm"])
def test_k4_plain_matches_pallas_interpret(name):
    """The cases tpulc defines (ranks in range, non-negative entries)."""
    t0, ranks = k4_case(name, nchunks=16, C=128, seed=1)
    want_s, want_t = mtf_pallas.mtf_lockstep_pallas(
        jnp.asarray(t0.numpy()), jnp.asarray(ranks.numpy()), interpret=True)
    got_s, got_t = mk.mtf_lockstep(t0, ranks)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("nchunks", [1, 31, 33])
def test_k4_plain_matches_pallas_interpret_at_ragged_chunk_counts(nchunks):
    t0, ranks = k4_case("random", nchunks=nchunks, C=128, seed=2)
    want_s, want_t = mtf_pallas.mtf_lockstep_pallas(
        jnp.asarray(t0.numpy()), jnp.asarray(ranks.numpy()), interpret=True)
    got_s, got_t = mk.mtf_lockstep(t0, ranks)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("C", [128, 100, 6])
def test_k4_identity_start_and_skipped_outputs_equal_the_full_call(C):
    _, ranks = k4_case("random", nchunks=7, C=C, seed=3)
    ident = torch.arange(256, dtype=torch.int32).expand(7, 256).contiguous()
    full_s, full_t = mk.mtf_lockstep(ident, ranks)
    s, t = mk.mtf_lockstep(None, ranks)
    assert torch.equal(s, full_s) and torch.equal(t, full_t)
    s, t = mk.mtf_lockstep(None, ranks, want_syms=False)
    assert s is None and torch.equal(t, full_t)
    s, t = mk.mtf_lockstep(ident, ranks, want_table=False)
    assert t is None and torch.equal(s, full_s)


def test_k4_wrapper_checks_its_options():
    t0, ranks = k4_case("random", nchunks=2)
    for lanes in mk.LANES:
        got = mk.mtf_lockstep(t0, ranks, lanes=lanes)
        assert torch.equal(got[0], mk.mtf_lockstep_plain(t0, ranks)[0])
    with pytest.raises(ValueError, match="lanes"):
        mk.mtf_lockstep(t0, ranks, lanes=4)
    with pytest.raises(ValueError):
        mk.mtf_lockstep(None, ranks.long())


def test_mtf_decode_through_the_identity_start_matches_tpulc():
    """`mtf_decode` starts K4 from `table0=None` and drops one output of
    each call; its bytes are tpulc's."""
    from tpulc.primitives import mtf as jmtf

    rng = np.random.default_rng(5)
    ranks = rng.integers(0, 256, size=33 * 128).astype(np.uint8)
    ranks[: 20 * 128] = rng.integers(0, 3, size=20 * 128)
    want = np.asarray(jmtf.mtf_decode(jnp.asarray(ranks)))
    np.testing.assert_array_equal(
        mtf_decode(torch.from_numpy(ranks)).numpy(), want)
