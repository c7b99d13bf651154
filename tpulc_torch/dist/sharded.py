"""Block-parallel codec steps over a `DeviceMesh` (port of
`tpulc/dist/sharded.py`; the same outputs).

tpulc `shard_map`s each step over the mesh's `'blocks'` axis: a device
runs its contiguous shard of the blocks and a `psum` or `all_gather`
joins them.  Here every rank is handed the same global arrays (the
`make_args` of a step draws them from one seed), keeps its shard
[r B / W, (r + 1) B / W) on its device, runs the port's single-device
functions on it, and joins the results with `all_reduce` or
`all_gather` over the mesh's group.  Every step returns what tpulc's
returns, gathered to every rank; B must be a multiple of the world size
W, as `shard_map` requires.  On the card a step launches the kernels
its single-device functions launch: K1, the start tables and K2 (the bz
forward), K4 (the bz round trip), coder 1's encode walk (the bsc
forward), the adaptive coder's two walks and K5, the emission and K6
(the group-rank coder).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpulc_torch.dist.mesh import mesh_device
from tpulc_torch.primitives.bits import pack_bits
from tpulc_torch.primitives.histogram import prefix_hist


def _tensor(x) -> torch.Tensor:
    """A numpy array as a tensor (uint16 / uint32, which torch barely
    supports, widened to int64)."""
    a = np.array(x)
    if a.dtype in (np.uint16, np.uint32):
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _local(mesh: DeviceMesh, x) -> torch.Tensor:
    """This rank's rows of a global [B, ...] array, on its device."""
    t = _tensor(x)
    W, r = mesh.size(), mesh.get_local_rank()
    B = t.shape[0]
    if B == 0 or B % W:
        raise ValueError(f"{B} blocks do not shard over {W} ranks")
    return t[r * B // W: (r + 1) * B // W].to(mesh_device(mesh))


def _replicated(mesh: DeviceMesh, x) -> torch.Tensor:
    return _tensor(x).to(mesh_device(mesh))


def _gather(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """[b, ...] on each rank -> [W b, ...] on every rank, in rank order
    (tpulc's tiled `all_gather`)."""
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.size())]
    dist.all_gather(parts, y, group=mesh.get_group())
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def _sharded(mesh: DeviceMesh, body, n_sharded: int, summed=()):
    """A step over the mesh: body(*args) on this rank's shard of the
    first n_sharded global arrays (the rest replicated), each of its
    outputs gathered to every rank, or summed over the ranks at the
    indices in `summed` (tpulc's `psum`).  `step.body` is the same
    computation without a group, for a caller to hold the step
    against."""
    def step(*args):
        outs = body(*[_local(mesh, a) for a in args[:n_sharded]],
                    *[_replicated(mesh, a) for a in args[n_sharded:]])
        for j in summed:
            dist.all_reduce(outs[j], op=dist.ReduceOp.SUM,
                            group=mesh.get_group())
        return tuple(o if j in summed else _gather(mesh, o)
                     for j, o in enumerate(outs))

    step.body = body
    return step


def _masked_encode(blocks, ns, codes, lengths, out_words: int):
    """Every block's first ns bytes through one code table ->
    (words [b, out_words], bits [b])."""
    idx = blocks.to(torch.int64)
    live = torch.arange(blocks.shape[1], device=blocks.device) < ns[:, None]
    sym_lens = torch.where(live, lengths.to(torch.int64)[idx], 0)
    sym_codes = torch.where(live, codes.to(torch.int64)[idx], 0)
    return pack_bits(sym_codes, sym_lens, out_words)


def global_histogram(mesh: DeviceMesh, blocks, ns) -> torch.Tensor:
    """Global 256-bin histogram of uint8[B, block_size] (valid prefixes
    ns[B]) by an `all_reduce` SUM: the shared-dictionary histogram."""
    step = _sharded(mesh, lambda b, n: (prefix_hist(b, n, 256),), 2,
                    summed=(0,))
    return step(blocks, ns)[0]


def sharded_huffman_encode(mesh: DeviceMesh, blocks, ns, codes, lengths,
                           out_words: int):
    """Encode every block with one replicated table -> (words [B,
    out_words] (uint32 values), bits [B]); the `all_gather` of the bit
    counts is the offset-table collective."""
    return _sharded(mesh, partial(_masked_encode, out_words=out_words), 2)(
        blocks, ns, codes, lengths)


def sharded_huffman_roundtrip_step(mesh: DeviceMesh, block_size: int,
                                   max_len: int = 12):
    """(step, make_args): one step is the masked histograms -> their
    global sum -> every block encoded with the replicated table -> the
    gathered bit counts; step(*make_args(B)) -> (ghist, words, bits)."""
    out_words = -(-block_size * max_len // 32)

    def body(blocks, ns, codes, lengths):
        return (prefix_hist(blocks, ns, 256),
                *_masked_encode(blocks, ns, codes, lengths, out_words))

    def make_args(n_blocks: int, rng_seed: int = 0):
        rng = np.random.default_rng(rng_seed)
        blocks = rng.integers(0, 256, size=(n_blocks, block_size)).astype(
            np.uint8)
        ns = np.full((n_blocks,), block_size, np.int32)
        # a trivial valid table: the 8-bit flat code
        return (blocks, ns, np.arange(256, dtype=np.uint32),
                np.full((256,), 8, np.int32))

    return _sharded(mesh, body, 2, summed=(0,)), make_args


def _stacked(outs: list[tuple], dev: torch.device) -> tuple:
    """Per-block output tuples -> one tensor per output, blocks first."""
    return tuple(torch.stack([torch.as_tensor(x, device=dev) for x in col])
                 for col in zip(*outs))


def _bytes64(n_blocks: int, cap: int, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    return (rng.integers(0, 64, size=(n_blocks, cap)).astype(np.uint8),)


def sharded_bz_forward(mesh: DeviceMesh, block_size: int):
    """(step, make_args): each rank runs the bz forward (the bz codec's
    own `_forward`) on its blocks; step(blocks) -> (syms, m, idx0, hist,
    anchors, ok, sizes), hist that of syms[:m] and sizes the gathered m
    (the offset table)."""
    from tpulc_torch.codecs.bwt.driver import _cap_for, _forward
    from tpulc_torch.codecs.bwt.rle import ALPHABET

    cap = _cap_for(block_size)

    def one(block):
        syms, m, idx0, anchors, ok = _forward(block)
        return syms, m, idx0, prefix_hist(syms, m, ALPHABET), anchors, ok

    def body(blocks):
        out = _stacked([one(b) for b in blocks], blocks.device)
        return (*out, out[1])

    return (_sharded(mesh, body, 1),
            lambda n_blocks, rng_seed=0: _bytes64(n_blocks, cap, rng_seed))


def sharded_bz_roundtrip(mesh: DeviceMesh, block_size: int):
    """(step, make_args): the bz forward and its inverse (RLE2 -> MTF,
    K4 -> the inverse BWT by pointer doubling) on each rank's blocks;
    step(blocks) -> (blocks back, gathered m)."""
    from tpulc_torch.codecs.bwt.driver import _cap_for, _forward
    from tpulc_torch.codecs.bwt.rle import rle2_decode
    from tpulc_torch.codecs.bwt.rotsort import bwt_decode
    from tpulc_torch.primitives.mtf import mtf_decode

    cap = _cap_for(block_size)

    def one(block):
        syms, m, idx0, _, _ = _forward(block)
        ranks, _ = rle2_decode(syms, m)
        return bwt_decode(mtf_decode(ranks), idx0), m

    return (_sharded(mesh, lambda blocks: _stacked(
        [one(b) for b in blocks], blocks.device), 1),
            lambda n_blocks, rng_seed=0: _bytes64(n_blocks, cap, rng_seed))


def sharded_bsc_rans_forward(mesh: DeviceMesh, block_size: int):
    """(step, make_args): the masked BWT pipeline and coder 1's
    order-2 context rANS on each rank's blocks with replicated tables;
    step(blocks, ns, freq, cum) -> (gathered words a block, gathered
    m)."""
    from tpulc_torch.codecs.bsclike.driver import _cap_for
    from tpulc_torch.codecs.bsclike.rans import (
        CHUNK,
        NCTX,
        ctx_of_stream,
        normalize_freqs_ctx,
        rans_encode_ctx,
    )
    from tpulc_torch.codecs.bwt.masked import forward_masked
    from tpulc_torch.codecs.bwt.rle import ALPHABET

    cap = _cap_for(block_size)

    def one(block, n, freq, cum):
        syms, m, _, _ = forward_masked(block, n)
        _, counts, _ = rans_encode_ctx(syms, ctx_of_stream(syms), int(m),
                                       freq, cum, chunk=CHUNK)
        return counts.sum(), m

    def body(blocks, ns, freq, cum):
        return _stacked([one(b, n, freq, cum)
                         for b, n in zip(blocks, ns.tolist())], blocks.device)

    def make_args(n_blocks: int, rng_seed: int = 0):
        rng = np.random.default_rng(rng_seed)
        blocks = rng.integers(0, 64, size=(n_blocks, cap)).astype(np.uint8)
        ns = np.full((n_blocks,), block_size, np.int32)
        # uniform replicated tables: every symbol present -> decodable
        fq = normalize_freqs_ctx(np.ones((NCTX, ALPHABET), np.int64))
        cum = np.concatenate(
            [np.zeros((NCTX, 1), np.int32),
             np.cumsum(fq, axis=1)[:, :-1].astype(np.int32)], axis=1)
        return blocks, ns, fq.astype(np.int32), cum

    return _sharded(mesh, body, 2), make_args


def sharded_abc_roundtrip(mesh: DeviceMesh, block_size: int):
    """(step, make_args): the adaptive binary coder's encode and decode
    of each rank's symbol blocks with a replicated model-init table;
    step(syms, ns, inits) -> (decoded syms, gathered words a block)."""
    from tpulc_torch.codecs.bsclike.abc_kernels import NMODELS
    from tpulc_torch.codecs.bsclike.driver import _cap_for
    from tpulc_torch.codecs.bsclike.rans_adaptive import (
        ACHUNK,
        MAX_SYM_BITS,
        abc_decode,
        abc_encode,
        abc_stats,
    )

    cap = _cap_for(block_size)
    W = MAX_SYM_BITS * ACHUNK  # a hard bound on a lane's bits

    def body(syms, ns, inits):
        n = ns.tolist()
        lB = syms.shape[0]
        init = inits.expand(lB, -1)
        _, _, lane_bits, lane_cls = abc_stats(syms, n)
        words, counts, states = abc_encode(syms, n, init, W)
        return (abc_decode(words, states, lane_cls, n, init,
                           int(lane_bits.max()), B=lB),
                counts.reshape(lB, -1).sum(1))

    def make_args(n_blocks: int, rng_seed: int = 0):
        rng = np.random.default_rng(rng_seed)
        syms = np.minimum(rng.geometric(0.4, size=(n_blocks, cap)) - 1,
                          256).astype(np.int32)
        return (syms, np.full((n_blocks,), cap, np.int32),
                np.full((1, NMODELS), 2048, np.uint16))

    return _sharded(mesh, body, 2), make_args


def sharded_grc_roundtrip(mesh: DeviceMesh, block_size: int):
    """(step, make_args): the group-rank coder's encode (K5, the
    emission) and decode (K6) of each rank's MTF rank blocks, the inits
    computed per block; step(ranks, ns) -> (decoded ranks, gathered
    words a block)."""
    from tpulc_torch.codecs.bsclike.driver import _cap_for
    from tpulc_torch.codecs.bsclike.grc import (
        GCHUNK,
        MAX_GROUP_BITS,
        grc_decode,
        grc_encode,
        grc_lane_bits,
    )

    cap = min(_cap_for(block_size), 4 * GCHUNK)
    W = MAX_GROUP_BITS * GCHUNK  # the coder's ceiling on a lane's bits

    def one(r, n):
        words, counts, states, inits, cinits, _ = grc_encode(r, n, W)
        lane_bits, _ = grc_lane_bits(r, n)
        return (grc_decode(words, states, n, inits, cinits,
                           int(lane_bits.max()), cap), counts.sum())

    def make_args(n_blocks: int, rng_seed: int = 0):
        rng = np.random.default_rng(rng_seed)
        ranks = np.where(
            rng.random((n_blocks, cap)) < 0.5, 0,
            np.minimum(rng.geometric(0.4, size=(n_blocks, cap)), 255),
        ).astype(np.int32)
        return ranks, np.full((n_blocks,), cap, np.int32)

    return (_sharded(mesh, lambda ranks, ns: _stacked(
        [one(r, n) for r, n in zip(ranks, ns.tolist())], ranks.device), 2),
            make_args)


def sharded_culzss_roundtrip(mesh: DeviceMesh, block_size: int):
    """(step, make_args): the CULZSS packet encode and decode of each
    rank's blocks (block_size a multiple of the packet size);
    step(blocks) -> (blocks back, gathered packet bytes a block)."""
    from tpulc_torch.codecs.lzss.culzss import (
        PCKT,
        culzss_decode_block,
        culzss_encode_block,
    )

    if block_size % PCKT:
        raise ValueError(f"block_size must be a multiple of {PCKT}")

    def one(block):
        pbuf, sizes, _ = culzss_encode_block(block)
        dec, _ = culzss_decode_block(pbuf, sizes)
        return dec.reshape(-1), sizes.sum()

    def make_args(n_blocks: int, rng_seed: int = 0):
        rng = np.random.default_rng(rng_seed)
        words = [b"the ", b"lzss ", b"window ", b"match ", b"stream "]
        buf = b"".join(words[int(i)] for i in
                       rng.integers(0, 5, size=n_blocks * block_size // 4))
        return (np.frombuffer(buf[: n_blocks * block_size], np.uint8)
                .reshape(n_blocks, block_size),)

    return (_sharded(mesh, lambda blocks: _stacked(
        [one(b) for b in blocks], blocks.device), 1), make_args)
