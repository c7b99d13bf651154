"""The canonical Huffman chunk walks K3, K7 and K8: wrappers, launch
counts and plain versions.

The counterparts of `tpulc/codecs/huffman/pallas_decode.py`:

  K3 `huffman_walk`      `decode_canonical_indices_buffered` (unpacked
                         and packed), CUDA source `csrc/huffman_walk.cu`;
  K7 `huffman_walk_v1`   `decode_canonical_indices` (v1),
                         `csrc/huffman_v1.cu`;
  K8 `huffman_walk_flat` `decode_canonical_indices_flat`,
                         `csrc/huffman_flat.cu`.

Design notes are in the CUDA sources; the three share one walk core,
`csrc/huffman_walk.cuh`.  A CPU tensor runs the plain
PyTorch version; a CUDA tensor launches the kernel (adding one to the
wrapper's `launches`) or raises.

The batch interface (K3, K7): `words` int32[B, W] holds B streams of
uint32 bit patterns, `tbits` int32[B] their valid bit counts; chunk c
belongs to stream ``c // (nsub // B)``, starts at bit `offs[c]` (read as
uint32) and decodes with table ``tab[c]`` of `lim`/`base` int32[T, L+1]
(clamped to [0, T)).  bz calls with B = 1 and its selectors as `tab`;
the huffman codec with one stream and one table per block.

Contract of K3 and K7, per chunk (the TPU kernels'): end =
min(tbits[b], offs[c] + chunk_syms*L); each step reads the next L bits
as `win`, takes the first l with ``win >> (L-l) < lim[l]`` (length l,
index ``base[l] + (win >> (L-l))``), or length 1 and index 0 when none
matches (corrupt stream); steps at or past end emit 0 and do not
advance.  Bits past a stream's W words read as zero.  Packed K3 output
(alphabet <= 256): byte b of int32 word q is ``clip(index, 0, 255)`` of
symbol 4q+b — little-endian, so ``out.view(torch.uint8)`` is the ranks
in symbol order.

K8 takes per-chunk `bits_left` (``min(tbits[b] - offs[c], chunk_syms*L)``)
and one table per TILE of chunks as LEFT-JUSTIFIED limits
``lj[l] = lim[l] << (L-l)``: length ``1 + sum_{l<L} [win >= lj[l]]``,
valid iff ``win < lj[L]`` (else length 1, index 0); a step emits while
``bits_left > 0``.  Output packed like K3's.
"""

from __future__ import annotations

import torch

from tpulc_torch import cuda_lib
from tpulc_torch.primitives.bits import M32

MAX_L = 16   # two codes fit one 32-bit refill
TILE = 128   # K8: chunks a table tile
WALK_TILES = (32, 64, 128)   # K3: chunks a tile (= threads a CUDA block)


def _check_int32(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous int32, got {t.dtype}")
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_streams(words, offs, chunk_syms: int, max_len: int, quad: bool):
    if words.dim() != 2 or offs.dim() != 1:
        raise ValueError("words must be [B, W] and offs 1-D")
    B, W = words.shape
    nsub = offs.shape[0]
    if B < 1 or nsub % B:
        raise ValueError(f"{nsub} chunks do not split over {B} streams")
    if not 1 <= max_len <= MAX_L:
        raise ValueError(f"need 1 <= max_len <= {MAX_L}")
    if chunk_syms < 2 or chunk_syms % (4 if quad else 2):
        raise ValueError(f"chunk_syms {chunk_syms} must be a multiple of "
                         f"{4 if quad else 2}")
    if W >= 2 ** 26:
        raise ValueError("stream too long for the kernels' int32 offsets")
    return B, nsub


def _check_walk(words, tbits, offs, lim, base, tab, chunk_syms: int,
                max_len: int, packed: bool):
    """K3/K7 arguments -> (device, nsub), or ValueError."""
    dev = _check_int32(words=words, tbits=tbits, offs=offs, lim=lim,
                       base=base, tab=tab)
    B, nsub = _check_streams(words, offs, chunk_syms, max_len, packed)
    if tbits.shape != (B,):
        raise ValueError(f"tbits must be [{B}]")
    if lim.dim() != 2 or lim.shape[1] != max_len + 1 or base.shape != lim.shape:
        raise ValueError(f"lim/base must be [T, {max_len + 1}]")
    if tab.shape != (nsub,):
        raise ValueError(f"tab must be [{nsub}]")
    return dev, nsub


def _stream_reader(words, offs):
    """-> (word(i) reading stream `c // ccap` at word i, zero past W)."""
    B, W = words.shape
    nsub = offs.shape[0]
    flat = torch.cat([words.to(torch.int64) & M32,
                      torch.zeros((B, 1), dtype=torch.int64,
                                  device=words.device)], 1).reshape(-1)
    row = (torch.arange(nsub, device=words.device) // (nsub // B)) * (W + 1)

    def word(i):
        return flat[row + i.clamp(max=W)]

    return word


def _window(word, pos, L: int):
    """The next L bits at `pos` (int64), right-aligned."""
    wi = pos >> 5
    b = pos & 31
    merged = ((word(wi) << b) & M32) | (word(wi + 1) >> (32 - b))
    return merged >> (32 - L)


def _walk_plain(words, tbits, offs, lim, base, tab, chunk_syms: int,
                max_len: int) -> torch.Tensor:
    """The K3/K7 contract, vectorised across chunks: int32[nsub, C]."""
    L = max_len
    B = words.shape[0]
    nsub = offs.shape[0]
    word = _stream_reader(words, offs)
    blk = torch.arange(nsub, device=words.device) // (nsub // B)
    t = tab.to(torch.int64).clamp(0, lim.shape[0] - 1)
    lim_c = lim.to(torch.int64)[t]
    base_c = base.to(torch.int64)[t]
    pos = offs.to(torch.int64) & M32
    end = torch.minimum(pos + chunk_syms * L, tbits.to(torch.int64)[blk])
    cols = []
    for _ in range(chunk_syms):
        active = pos < end
        win = _window(word, pos, L)
        ln = torch.ones_like(pos)
        ci = torch.zeros_like(pos)
        found = torch.zeros_like(pos, dtype=torch.bool)
        for l in range(1, L + 1):
            code = win >> (L - l)
            hit = ~found & (code < lim_c[:, l])
            ln = torch.where(hit, l, ln)
            ci = torch.where(hit, base_c[:, l] + code, ci)
            found |= hit
        cols.append(torch.where(active, ci, 0))
        pos = pos + torch.where(active, ln, 0)
    if not cols:
        return torch.zeros((nsub, 0), dtype=torch.int32, device=words.device)
    return torch.stack(cols, dim=1).to(torch.int32)


def pack_ranks(ci: torch.Tensor) -> torch.Tensor:
    """int [nsub, C] canonical indices -> int32[nsub, C/4], byte b of
    word q = clip(ci[:, 4q+b], 0, 255) (little-endian)."""
    return ci.clamp(0, 255).to(torch.uint8).contiguous().view(torch.int32)


# ------------------------------------------------------------------- K3

def huffman_walk_plain(words, tbits, offs, lim, base, tab, chunk_syms: int,
                       max_len: int, packed: bool = False) -> torch.Tensor:
    """Plain PyTorch K3 -> int32[nsub, C] indices, or int32[nsub, C/4]
    packed ranks (see the module docstring)."""
    ci = _walk_plain(words, tbits, offs, lim, base, tab, chunk_syms, max_len)
    return pack_ranks(ci) if packed else ci


def huffman_walk(words: torch.Tensor, tbits: torch.Tensor, offs: torch.Tensor,
                 lim: torch.Tensor, base: torch.Tensor, tab: torch.Tensor,
                 chunk_syms: int, max_len: int, packed: bool = False,
                 tile: int | None = None) -> torch.Tensor:
    """K3 wrapper (see the module docstring and `huffman_walk_plain`).
    `tile` (one of WALK_TILES) is the chunks a block of the CUDA kernel
    stages and walks at a time; None lets the C entry point pick from
    the shape.  It changes no output."""
    if tile is not None and tile not in WALK_TILES:
        raise ValueError(f"tile must be one of {WALK_TILES}")
    dev, nsub = _check_walk(words, tbits, offs, lim, base, tab, chunk_syms,
                            max_len, packed)
    if dev.type == "cpu":
        return huffman_walk_plain(words, tbits, offs, lim, base, tab,
                                  chunk_syms, max_len, packed)
    lib = cuda_lib.library()
    q = chunk_syms // 4 if packed else chunk_syms
    out = torch.empty((nsub, q), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_huffman_walk(
            words.data_ptr(), *words.shape, tbits.data_ptr(),
            offs.data_ptr(), nsub,
            lim.data_ptr(), base.data_ptr(), lim.shape[0], tab.data_ptr(),
            out.data_ptr(), chunk_syms, max_len, int(packed), tile or 0,
            cuda_lib.stream_of(words)), "huffman_walk")
    huffman_walk.launches += 1
    return out


huffman_walk.launches = 0


# ------------------------------------------------------------------- K7

def huffman_walk_v1_plain(words, tbits, offs, lim, base, tab, chunk_syms: int,
                          max_len: int) -> torch.Tensor:
    """Plain PyTorch K7 -> int32[nsub, C] (the K3 unpacked contract; the
    plain walk already fetches the straddling word pair per symbol, as
    v1 does)."""
    return _walk_plain(words, tbits, offs, lim, base, tab, chunk_syms,
                       max_len)


def huffman_walk_v1(words: torch.Tensor, tbits: torch.Tensor,
                    offs: torch.Tensor, lim: torch.Tensor, base: torch.Tensor,
                    tab: torch.Tensor, chunk_syms: int,
                    max_len: int) -> torch.Tensor:
    """K7 wrapper -> int32[nsub, C] (on the card a transposed view of the
    kernel's step-major [C, nsub] output)."""
    dev, nsub = _check_walk(words, tbits, offs, lim, base, tab, chunk_syms,
                            max_len, False)
    if dev.type == "cpu":
        return huffman_walk_v1_plain(words, tbits, offs, lim, base, tab,
                                     chunk_syms, max_len)
    lib = cuda_lib.library()
    out = torch.empty((chunk_syms, nsub), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_huffman_walk_v1(
            words.data_ptr(), *words.shape, tbits.data_ptr(),
            offs.data_ptr(), nsub,
            lim.data_ptr(), base.data_ptr(), lim.shape[0], tab.data_ptr(),
            out.data_ptr(), chunk_syms, max_len,
            cuda_lib.stream_of(words)), "huffman_walk_v1")
    huffman_walk_v1.launches += 1
    return out.t()


huffman_walk_v1.launches = 0


# ------------------------------------------------------------------- K8

def huffman_walk_flat_plain(words, offs, bits_left, lj, base, chunk_syms: int,
                            max_len: int) -> torch.Tensor:
    """Plain PyTorch K8 -> int32[nsub, C/4] packed ranks."""
    L = max_len
    nsub = offs.shape[0]
    dev = words.device
    word = _stream_reader(words, offs)
    tile = torch.arange(nsub, device=dev) // TILE
    lj_c = lj.to(torch.int64)[tile]
    base_c = base.to(torch.int64)[tile]
    pos = offs.to(torch.int64) & M32
    left = bits_left.to(torch.int64)
    cols = []
    for _ in range(chunk_syms):
        win = _window(word, pos, L)
        ln = 1 + (win[:, None] >= lj_c[:, 1:L]).sum(dim=1)
        found = win < lj_c[:, L]
        ln = torch.where(found, ln, 1)
        code = win >> (L - ln)
        ci = torch.where(found, base_c.gather(1, ln[:, None])[:, 0] + code, 0)
        active = left > 0
        cols.append(torch.where(active, ci, 0))
        st = torch.where(active, ln, 0)
        left = left - st
        pos = pos + st
    if not cols:
        return torch.zeros((nsub, 0), dtype=torch.int32, device=dev)
    return pack_ranks(torch.stack(cols, dim=1))


def huffman_walk_flat(words: torch.Tensor, offs: torch.Tensor,
                      bits_left: torch.Tensor, lj: torch.Tensor,
                      base: torch.Tensor, chunk_syms: int,
                      max_len: int) -> torch.Tensor:
    """K8 wrapper (see the module docstring and `huffman_walk_flat_plain`).
    Chunk c uses table ``c // TILE``; nsub must be a TILE multiple."""
    dev = _check_int32(words=words, offs=offs, bits_left=bits_left, lj=lj,
                       base=base)
    B, nsub = _check_streams(words, offs, chunk_syms, max_len, True)
    if (nsub // B) % TILE:
        raise ValueError(f"chunks per stream must be a multiple of {TILE}")
    if bits_left.shape != (nsub,):
        raise ValueError(f"bits_left must be [{nsub}]")
    if lj.shape != (nsub // TILE, max_len + 1) or base.shape != lj.shape:
        raise ValueError(f"lj/base must be [{nsub // TILE}, {max_len + 1}]")
    if dev.type == "cpu":
        return huffman_walk_flat_plain(words, offs, bits_left, lj, base,
                                       chunk_syms, max_len)
    lib = cuda_lib.library()
    out = torch.empty((nsub, chunk_syms // 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_huffman_walk_flat(
            words.data_ptr(), *words.shape, offs.data_ptr(),
            bits_left.data_ptr(), nsub, lj.data_ptr(), base.data_ptr(),
            out.data_ptr(), chunk_syms, max_len,
            cuda_lib.stream_of(words)), "huffman_walk_flat")
    huffman_walk_flat.launches += 1
    return out


huffman_walk_flat.launches = 0
