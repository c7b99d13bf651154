"""Move-to-front transform over independent-start chunks (port of
`tpulc/primitives/mtf.py`, bit-identical outputs).

Forward: the MTF table before chunk c is fixed by the last-occurrence
  position of every symbol in the prefix, and last-occurrence composes
  with `max`.  K1 (`mtf_recency`) gives each chunk's recency row and,
  in the same pass, the max of those positions over each tile of
  chunks; `mtf_start_tables` turns them into each chunk's start table
  (an exclusive max-scan over chunks and a sort by recency,
  `mtf.py:85-96`; on the card one launch after a 16-byte memset: the
  blocks of the first tickets scan the tile maxima into each tile's
  prefix while the others wait on a count of finished scanners, then a
  warp walks a tile's chunks), and K2 (`mtf_encode_lockstep`)
  encodes all chunks in lockstep.

Inverse: decoding a rank is a positional permutation of the table, and
  permutations compose by gather.  K4 (`mtf_lockstep`) from the
  identity (made in the kernel's registers) builds each chunk's
  permutation; an exclusive composition
  scan of log2(nchunks) `torch.gather` rounds gives every chunk's start
  table (tpulc's TPU build composes with two lane sorts instead,
  `mtf.py:146-152`); K4 again decodes all chunks from those tables.
"""

from __future__ import annotations

import torch

from tpulc_torch.primitives.mtf_kernels import (
    ALPHA,
    mtf_encode_lockstep,
    mtf_lockstep,
    mtf_recency,
    mtf_start_tables,
)

DEFAULT_CHUNK = 128


def mtf_encode(data: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """MTF-encode uint8[N] -> uint8[N] of ranks (N a multiple of
    `chunk`; tail junk stays in the tail)."""
    n = data.shape[0]
    if n % chunk:
        raise ValueError("pad input to a multiple of `chunk`")
    d = data.to(torch.int32).reshape(n // chunk, chunk).contiguous()
    rec, part, tile = mtf_recency(d, partials=True)
    table0 = mtf_start_tables(rec, chunk, tile=tile, part=part)
    ranks, _ = mtf_encode_lockstep(table0, d)
    return ranks.to(torch.uint8).reshape(n)


def mtf_decode(ranks: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Inverse MTF: uint8[N] ranks -> uint8[N] symbols."""
    n = ranks.shape[0]
    if n % chunk:
        raise ValueError("pad input to a multiple of `chunk`")
    nchunks = n // chunk
    dev = ranks.device
    r = ranks.to(torch.int32).reshape(nchunks, chunk).contiguous()
    # each chunk's permutation: K4 from the identity, symbols not kept
    _, chunk_perm = mtf_lockstep(None, r, want_syms=False)
    # inclusive composition scan, (a o b)[i] = a[b[i]], Hillis-Steele
    incl = chunk_perm.long()
    d = 1
    while d < nchunks:
        nxt = incl.clone()
        nxt[d:] = torch.gather(incl[:-d], 1, incl[d:])
        incl = nxt
        d *= 2
    ident = torch.arange(ALPHA, device=dev)[None, :]
    table0 = torch.cat([ident, incl[:-1]], dim=0)
    syms, _ = mtf_lockstep(table0.to(torch.int32).contiguous(), r,
                           want_table=False)
    return syms.to(torch.uint8).reshape(n)
