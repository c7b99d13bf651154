"""The port's distribution layer (`tpulc_torch/dist`) against tpulc's
(`tpulc/dist`, on the 8-device CPU mesh of `tests/conftest.py`): every
sharded step on two CPU ranks over gloo, fed the same seeded
`make_args` arrays, gives tpulc's outputs exactly, gathered to both
ranks; `compress_multihost` at world sizes 1 and 2 writes the bytes of
tpulc's single-process `compress_multihost` for huffman, bz and culzss;
`assemble_container` orders round-robin stripes; the port's
`dryrun_multichip(2, device="cpu")` passes, and without device= it asks
for the card.  The ranks are spawned processes that
import the port alone (no jax, no conftest)."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpulc.dist import sharded as tpulc_sharded
from tpulc.dist.mesh import make_mesh as tpulc_make_mesh
from tpulc.dist.multihost import compress_multihost as tpulc_multihost
from tpulc_torch.codecs import store
from tpulc_torch.dist import dryrun, sharded
from tpulc_torch.dist.multihost import (
    assemble_container,
    block_owner,
    compress_multihost,
    local_block_indices,
)
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_STORE, get_codec
from tpulc_torch.primitives.checksum import adler32_np

torch.set_num_threads(1)

N_BLOCKS = 8          # tpulc's mesh has 8 devices; the port's 2 ranks, 4 each
SEED = 5
MH_BLOCK = 16_384     # compress_multihost: 3 blocks, rank 0 owns 0 and 2
STEPS = [("huffman_roundtrip_step", 512), ("bz_forward", 512),
         ("bz_roundtrip", 512), ("bsc_rans_forward", 512),
         ("abc_roundtrip", 1024), ("grc_roundtrip", 512),
         ("culzss_roundtrip", 4096)]


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


MH_DATA = _pg(40_000)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' recorded outputs (`dryrun.record_steps`)."""
    d = tmp_path_factory.mktemp("gloo2")
    dryrun.spawn_ranks(2, "gloo", dryrun.record_steps, str(d), N_BLOCKS,
                       SEED, MH_DATA, MH_BLOCK, timeout=600)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def mesh():
    return tpulc_make_mesh()


def test_ranks_import_the_port_alone_and_agree(ranks):
    for out in ranks:
        assert int(out["imported/jax"]) == 0
        assert int(out["imported/conftest"]) == 0
    for k, v in ranks[0].items():
        if not k.startswith(("imported/", "multihost/")):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    assert not any(k.startswith("multihost/") for k in ranks[1])


@pytest.mark.parametrize("name,size", STEPS, ids=[s[0] for s in STEPS])
def test_sharded_step_equals_tpulc(ranks, mesh, name, size):
    t_step, t_args = getattr(tpulc_sharded, "sharded_" + name)(mesh, size)
    args = t_args(N_BLOCKS, SEED)
    # the port's make_args draws the same arrays (it never reads a mesh)
    _, p_args = getattr(sharded, "sharded_" + name)(None, size)
    for a, b in zip(args, p_args(N_BLOCKS, SEED)):
        np.testing.assert_array_equal(np.asarray(a), b)
    want = t_step(*args)
    assert len([k for k in ranks[0] if k.startswith(name + "/")]) == \
        len(want)
    for j, w in enumerate(want):
        got = ranks[0][f"{name}/{j}"]
        w = np.asarray(w)
        assert got.shape == w.shape, (name, j)
        np.testing.assert_array_equal(got.astype(np.int64),
                                      w.astype(np.int64), err_msg=(name, j))


@pytest.mark.parametrize("step", chip_smoke.DIST_STEPS,
                         ids=[s[0] for s in chip_smoke.DIST_STEPS])
def test_chip_smoke_step_digests_are_tpulc(step):
    """The sha256 that `chip_smoke.py` holds each card step to is that of
    tpulc's step on make_args(2, 0), and the port's step body on the CPU
    gives it too."""
    name, size, _, digest = step
    t_step, t_args = getattr(tpulc_sharded, "sharded_" + name)(
        tpulc_make_mesh(2), size)
    assert chip_smoke.outputs_sha256(t_step(*t_args(2, 0))) == digest
    p_step, p_args = getattr(sharded, "sharded_" + name)(None, size)
    assert chip_smoke.outputs_sha256(
        o.numpy() for o in p_step.body(
            *[sharded._tensor(a) for a in p_args(2, 0)])) == digest


def test_global_histogram_and_shared_table_encode_equal_tpulc(ranks, mesh):
    import jax.numpy as jnp

    _, make_args = sharded.sharded_huffman_roundtrip_step(None, 512)
    blocks, ns, codes, lengths = make_args(N_BLOCKS, SEED)
    ns[-1] = 100                       # a short last block
    hist = tpulc_sharded.global_histogram(mesh, jnp.asarray(blocks),
                                          jnp.asarray(ns))
    np.testing.assert_array_equal(ranks[0]["global_histogram/0"],
                                  np.asarray(hist))
    np.testing.assert_array_equal(
        ranks[0]["global_histogram/0"],
        np.bincount(np.concatenate([blocks[i, : ns[i]]
                                    for i in range(N_BLOCKS)]),
                    minlength=256))
    words, bits = tpulc_sharded.sharded_huffman_encode(
        mesh, jnp.asarray(blocks), jnp.asarray(ns), jnp.asarray(codes),
        jnp.asarray(lengths), 512 * 8 // 32 + 1)
    np.testing.assert_array_equal(ranks[0]["huffman_encode/0"],
                                  np.asarray(words).astype(np.int64))
    np.testing.assert_array_equal(ranks[0]["huffman_encode/1"],
                                  np.asarray(bits))


@pytest.mark.parametrize("codec", ["huffman", "bz", "culzss"])
def test_compress_multihost_equals_tpulc_at_world_1_and_2(ranks, codec):
    want = tpulc_multihost(MH_DATA, block_size=MH_BLOCK, codec_name=codec)
    assert compress_multihost(MH_DATA, MH_BLOCK, codec, device="cpu") == want
    got = ranks[0][f"multihost/{codec}"].tobytes()
    assert got == want
    assert get_codec(codec).decompress(got, device="cpu") == MH_DATA


def test_assemble_container_orders_round_robin_stripes():
    data = bytes(range(256)) * 40          # 10,240 bytes
    bs, n_blocks, n_procs = 1024, 10, 3
    arr = np.frombuffer(data, np.uint8)
    assert [block_owner(b, n_procs) for b in range(4)] == [0, 1, 2, 0]
    per_proc = []
    for p in range(n_procs):
        per_proc.append([Container.from_bytes(store.compress(
            arr[b * bs: (b + 1) * bs].tobytes(), block_size=bs,
            device="cpu")).payloads[0]
            for b in local_block_indices(n_blocks, p, n_procs)])
    buf = assemble_container(CODEC_STORE, len(data), bs, n_blocks, per_proc,
                             adler32_np(arr))
    assert get_codec(CODEC_STORE).decompress(buf, device="cpu") == data
    with pytest.raises(ValueError, match="no payload"):
        assemble_container(CODEC_STORE, len(data), bs, n_blocks,
                           per_proc[:2] + [[]], adler32_np(arr))


def test_dryrun_multichip_on_two_gloo_ranks():
    dryrun.dryrun_multichip(2, device="cpu")


def test_dryrun_multichip_asks_for_the_card_by_default(monkeypatch):
    """Without device= the dry run wants one card a rank: no card
    raises, and so do fewer cards than ranks (nothing is spawned)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dryrun, "spawn_ranks", None)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        dryrun.dryrun_multichip(2)
