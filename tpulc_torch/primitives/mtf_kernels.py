"""MTF kernels K1, K2, K4 and the start tables between K1 and K2:
wrappers, launch counts and plain versions.

The counterpart of `tpulc/primitives/mtf_pallas.py` and of the XLA stage
of `tpulc/primitives/mtf.py:85-96`.  The CUDA sources are
`tpulc_torch/csrc/mtf.cu` (design notes there).

| kernel | wrapper                   | replaces (tpulc)                              |
|--------|---------------------------|-----------------------------------------------|
| K1     | `mtf_recency`             | `mtf_pallas.py:mtf_recency_pallas`            |
| —      | `mtf_start_tables`        | `mtf.py:85-96` (XLA scan and argsort)         |
| K2     | `mtf_encode_lockstep`     | `mtf_pallas.py:mtf_encode_lockstep_pallas`    |
| K4     | `mtf_lockstep`            | `mtf_pallas.py:mtf_lockstep_pallas`           |

A wrapper given a CPU tensor runs the plain PyTorch version; given a
CUDA tensor it launches the kernel (and adds one to its `launches`
count) or raises — it never falls back.  The `*_plain` functions are
device-agnostic torch code: the CPU tests hold them against tpulc, and
`chip_smoke.py` holds each kernel against its plain version on the
card.
"""

from __future__ import annotations

import torch

from tpulc_torch import cuda_lib

ALPHA = 256


def _route(*tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_i32(name: str, t: torch.Tensor, ndim: int, width: int | None):
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous int32 with {ndim} dims, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if width is not None and t.shape[-1] != width:
        raise ValueError(f"{name}: last dim must be {width}")


def _check_walk(table0: torch.Tensor, seq: torch.Tensor) -> None:
    _check_i32("table0", table0, 2, ALPHA)
    _check_i32("seq", seq, 2, None)
    if table0.shape[0] != seq.shape[0]:
        raise ValueError("table0 and seq disagree on the chunk count")


def _move_to_front(table, rank, value):
    """table [B,256]; move position `rank` (holding `value`) to front."""
    pos = torch.arange(table.shape[1], device=table.device)[None, :]
    shifted = torch.cat([value[:, None], table[:, :-1]], dim=1)
    return torch.where(pos <= rank[:, None], shifted, table)


# --------------------------------------------------------------- K1

# the start tables' chunks a tile, which K1's blocks follow
# (csrc/mtf.cu kStartTiles)
START_TILES = (8, 16, 32, 64)


def _check_tile(tile: int, partials: bool) -> None:
    allowed = START_TILES if partials else (0, *START_TILES)
    if tile not in allowed:
        raise ValueError(f"tile: not one the kernel is built for {allowed}"
                         + (" (with partials, the tile they were made at)"
                            if partials else ""))


def _check_positions(nchunks: int, chunk: int) -> None:
    if nchunks * chunk >= 1 << 31:
        raise ValueError("nchunks * chunk must stay under 2^31")


def mtf_recency_plain(syms: torch.Tensor) -> torch.Tensor:
    """int32[nchunks, C] -> int32[nchunks, 256]: last step index of each
    symbol in its chunk, -1 when absent (symbols outside [0,256) are
    ignored)."""
    nchunks, C = syms.shape
    s = syms.long()
    s = torch.where((s >= 0) & (s < ALPHA), s, ALPHA)
    step = torch.arange(C, device=syms.device, dtype=torch.int32)
    out = torch.full((nchunks, ALPHA + 1), -1, dtype=torch.int32,
                     device=syms.device)
    out.scatter_reduce_(1, s, step.expand(nchunks, C), "amax")
    return out[:, :ALPHA].contiguous()


def mtf_tile_max_plain(rec_rel: torch.Tensor, chunk: int,
                       tile: int) -> torch.Tensor:
    """The start tables' tile maxima from K1's rows int32[nchunks, 256]
    of chunks of `chunk` steps: for each tile of `tile` chunks and each
    symbol s, the max of c * chunk + rec_rel[c][s] over the tile's
    chunks c where rec_rel[c][s] >= 0, else -1.  Symbol-major
    int32[256, ceil(nchunks / tile)] (positions are int32: nchunks *
    chunk must stay under 2^31)."""
    nchunks = rec_rel.shape[0]
    dev = rec_rel.device
    ntiles = -(-nchunks // tile)
    base = (torch.arange(nchunks, device=dev, dtype=torch.int32)
            * chunk)[:, None]
    key = torch.where(rec_rel >= 0, rec_rel + base, -1)
    pad = torch.full((ntiles * tile - nchunks, ALPHA), -1, dtype=torch.int32,
                     device=dev)
    key = torch.cat([key, pad]).reshape(ntiles, tile, ALPHA)
    return key.amax(dim=1).T.contiguous()


def mtf_recency(syms: torch.Tensor, partials: bool = False, tile: int = 0):
    """K1 wrapper (see `mtf_recency_plain`).  With `partials`, returns
    (rows, part, tile): also the start tables' tile maxima at `tile`
    (`mtf_tile_max_plain`), which `mtf_start_tables(rows, C, tile=tile,
    part=part)` takes in place of reading the rows a second time; then
    nchunks * C must stay under 2^31.  `tile` is one of START_TILES, or
    0 for the start tables' own pick on the card (START_TILES[0] on the
    CPU); without partials it only sets the chunks a block on the card
    and changes no output."""
    _check_i32("syms", syms, 2, None)
    nchunks, C = syms.shape
    _check_tile(tile, False)
    if partials:
        _check_positions(nchunks, C)
    if _route(syms) == "cpu":
        rec = mtf_recency_plain(syms)
        if not partials:
            return rec
        tile = tile or START_TILES[0]
        return rec, mtf_tile_max_plain(rec, C, tile), tile
    lib = cuda_lib.library()
    out = torch.empty((nchunks, ALPHA), dtype=torch.int32, device=syms.device)
    with torch.cuda.device(syms.device):
        tile = lib.tplc_mtf_start_tile(nchunks, tile)
        if tile <= 0:
            raise RuntimeError("mtf_recency: the card gave no tile")
        part = torch.empty((ALPHA, -(-nchunks // tile)), dtype=torch.int32,
                           device=syms.device) if partials else None
        if nchunks == 0:   # nothing to launch
            return (out, part, tile) if partials else out
        cuda_lib.check(lib.tplc_mtf_recency(
            syms.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), nchunks, C, tile,
            cuda_lib.stream_of(syms)), "mtf_recency")
    mtf_recency.launches += 1
    return (out, part, tile) if partials else out


mtf_recency.launches = 0


# ------------------------------------------------------- start tables

def mtf_start_tables_plain(rec_rel: torch.Tensor, chunk: int) -> torch.Tensor:
    """K1's per-chunk recency int32[nchunks, 256] -> every chunk's MTF
    start table int32[nchunks, 256]: an exclusive max-scan over chunks,
    then seen symbols newest first and unseen ones in natural order."""
    nchunks = rec_rel.shape[0]
    dev = rec_rel.device
    base = (torch.arange(nchunks, device=dev, dtype=torch.int32)
            * chunk)[:, None]
    recency = torch.where(rec_rel >= 0, rec_rel + base, -1)
    incl = torch.cummax(recency, dim=0).values
    before = torch.cat(
        [torch.full((1, ALPHA), -1, dtype=torch.int32, device=dev),
         incl[:-1]], dim=0)
    syms = torch.arange(ALPHA, device=dev, dtype=torch.int32)[None, :]
    key = torch.where(before >= 0, before, -2 - syms)
    return torch.argsort(-key, dim=1, stable=True).to(torch.int32)


def _start_scratch_words(ntiles: int, own_part: bool) -> int:
    """int32 words of the start tables' scratch (csrc/mtf.cu
    tplc_mtf_start_tables): none for one tile, else the ticket and the
    scanners' count (4), the prefix over tiles (256 a tile) and, without
    K1's maxima, the maxima (256 a tile)."""
    if ntiles <= 1:
        return 0
    return 4 + ALPHA * ntiles * (2 if own_part else 1)


def mtf_start_tables(rec_rel: torch.Tensor, chunk: int, tile: int = 0,
                     part: torch.Tensor | None = None) -> torch.Tensor:
    """Start-table wrapper (see `mtf_start_tables_plain`).  Its domain is
    K1's output for chunks of `chunk` steps: every row holds values in
    [-1, chunk), and each step index at most once a row.  There every
    key is distinct (seen symbols have distinct positions, unseen ones
    the keys -2 - s), so the order is unique and the kernel's output is
    bit-identical to the plain version's; off it the kernel's output is
    unspecified.  Positions c * chunk + step are int32 on both routes,
    so nchunks * chunk must stay under 2^31.  The kernel also needs
    chunk <= 4,096 (its step mask; the C entry point refuses more).
    `tile` forces the kernel's chunks a tile (8, 16, 32 or 64: a hook
    for tests and `chip_smoke.py`, unused on the CPU); 0 lets
    the C entry point pick from the shape and the card.  It changes no
    output.  `part`: K1's tile maxima of these rows at `tile` (from
    `mtf_recency(..., partials=True)`, which also gives the tile), read
    and never written; the kernel then takes them in place of its own
    first launch over the rows (one memset and one kernel launch a
    call).  The CPU route checks and ignores it.  0 chunks give 0
    tables."""
    _check_i32("rec_rel", rec_rel, 2, ALPHA)
    nchunks = rec_rel.shape[0]
    _check_positions(nchunks, chunk)
    tensors = (rec_rel,)
    if part is not None:
        _check_tile(tile, True)
        _check_i32("part", part, 2, -(-nchunks // tile))
        if part.shape[0] != ALPHA:
            raise ValueError(f"part: need {ALPHA} rows, one a symbol")
        tensors = (rec_rel, part)
    if nchunks == 0:
        return torch.empty((0, ALPHA), dtype=torch.int32,
                           device=rec_rel.device)
    if _route(*tensors) == "cpu":
        return mtf_start_tables_plain(rec_rel, chunk)
    lib = cuda_lib.library()
    out = torch.empty_like(rec_rel)
    with torch.cuda.device(rec_rel.device):
        tile = lib.tplc_mtf_start_tile(nchunks, tile)
        if tile <= 0:
            raise ValueError("tile: not one the kernel is built for")
        scratch = torch.empty(
            max(1, _start_scratch_words(-(-nchunks // tile), part is None)),
            dtype=torch.int32, device=rec_rel.device)
        cuda_lib.check(lib.tplc_mtf_start_tables(
            rec_rel.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), scratch.data_ptr(),
            nchunks, chunk, tile, cuda_lib.stream_of(rec_rel)),
            "mtf_start_tables")
    mtf_start_tables.launches += 1
    return out


mtf_start_tables.launches = 0


# --------------------------------------------------------------- K2

def mtf_encode_lockstep_plain(table0: torch.Tensor, syms: torch.Tensor):
    """Lockstep MTF-by-symbol: table0 int32[nchunks,256], syms
    int32[nchunks,C] -> (ranks int32[nchunks,C], final table).  Entries
    and symbols are any int32.  A symbol's rank is its FIRST position in
    the table: the rule of tpulc's XLA step (`jnp.argmax` of the
    equality, `tpulc/primitives/mtf.py:109`) and of its numpy gold
    (`list.index`), which define the contract; tpulc's Pallas kernel
    takes the last on a table with a duplicate entry
    (`mtf_pallas.py:132-134`, ROADMAP F5).  The codecs' start tables
    are permutations, where both rules agree, so no container depends on
    the choice.  An absent symbol gets rank 0 and overwrites position 0."""
    table = table0
    ranks = []
    for t in range(syms.shape[1]):
        col = syms[:, t]
        rank = torch.argmax((table == col[:, None]).to(torch.int32), dim=1)
        table = _move_to_front(table, rank, col)
        ranks.append(rank.to(torch.int32))
    out = torch.stack(ranks, dim=1) if ranks else syms.clone()
    return out.contiguous(), table.contiguous()


def mtf_encode_lockstep(table0: torch.Tensor, syms: torch.Tensor):
    """K2 wrapper (see `mtf_encode_lockstep_plain`)."""
    _check_walk(table0, syms)
    if _route(table0, syms) == "cpu":
        return mtf_encode_lockstep_plain(table0, syms)
    lib = cuda_lib.library()
    nchunks, C = syms.shape
    ranks = torch.empty_like(syms)
    tab = torch.empty_like(table0)
    with torch.cuda.device(syms.device):
        cuda_lib.check(lib.tplc_mtf_encode_lockstep(
            table0.data_ptr(), syms.data_ptr(), ranks.data_ptr(),
            tab.data_ptr(), nchunks, C, cuda_lib.stream_of(syms)),
            "mtf_encode_lockstep")
    mtf_encode_lockstep.launches += 1
    return ranks, tab


mtf_encode_lockstep.launches = 0


# --------------------------------------------------------------- K4

LANES = (32, 16, 8)   # K4: lanes a chunk the kernel is built for


def mtf_lockstep_plain(table0: torch.Tensor | None, ranks: torch.Tensor,
                       want_syms: bool = True, want_table: bool = True):
    """Lockstep MTF-by-rank: table0 int32[nchunks,256] (None: every
    chunk starts from the identity), ranks int32[nchunks,C] (clamped to
    [0,255]) -> (symbols int32[nchunks,C], final table); an output that
    is not wanted is None.  Table entries are moved, never inspected:
    any int32 values, a permutation or not."""
    nchunks = ranks.shape[0]
    if table0 is None:
        table0 = torch.arange(ALPHA, device=ranks.device,
                              dtype=torch.int32).expand(nchunks, ALPHA)
    table = table0
    syms = []
    for t in range(ranks.shape[1]):
        rank = ranks[:, t].clamp(0, ALPHA - 1).long()
        sym = table.gather(1, rank[:, None])[:, 0]
        table = _move_to_front(table, rank, sym)
        syms.append(sym)
    out = torch.stack(syms, dim=1) if syms else ranks.clone()
    return (out.contiguous() if want_syms else None,
            table.contiguous() if want_table else None)


def mtf_lockstep(table0: torch.Tensor | None, ranks: torch.Tensor,
                 want_syms: bool = True, want_table: bool = True,
                 lanes: int | None = None):
    """K4 wrapper (see `mtf_lockstep_plain`).  `lanes` (one of LANES)
    picks a build of the kernel; None leaves the choice to the C entry
    point.  It changes no output."""
    if table0 is None:
        _check_i32("ranks", ranks, 2, None)
    else:
        _check_walk(table0, ranks)
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}")
    tensors = (ranks,) if table0 is None else (table0, ranks)
    if _route(*tensors) == "cpu":
        return mtf_lockstep_plain(table0, ranks, want_syms, want_table)
    lib = cuda_lib.library()
    nchunks, C = ranks.shape
    dev = ranks.device
    syms = torch.empty_like(ranks) if want_syms else None
    tab = torch.empty((nchunks, ALPHA), dtype=torch.int32,
                      device=dev) if want_table else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_mtf_lockstep(
            ptr(table0), ranks.data_ptr(), ptr(syms), ptr(tab), nchunks, C,
            lanes or 0, cuda_lib.stream_of(ranks)), "mtf_lockstep")
    mtf_lockstep.launches += 1
    return syms, tab


mtf_lockstep.launches = 0
