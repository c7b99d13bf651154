"""The four CUDPP primitives outside the compress path (port of
`tpulc/primitives/cudpp_aux.py`; the same words, tables and, within
float rounding, the same solutions).

- `md5_rand`: cudppRand's MD5 generator, counter-mode MD5 over all
  blocks at once, bit-exact against hashlib.md5.  torch has no general
  uint32 arithmetic, so the words are computed and returned in int64,
  masked to 32 bits after every add: each value is the uint32 word.
- `spmv`: cudppSparseMatrixVectorMultiply, CSR y = A @ x as one gather
  and one `index_add_`.
- `tridiagonal_solve`: cudppTridiagonal, batched parallel cyclic
  reduction (log2(n) vectorised elimination rounds).
- `CuckooTable`: the cudpp_hash basic table, 4-choice first-writer-wins
  insertion rounds plus a sorted stash; lookups are four gathers and a
  `searchsorted`.  Keys and values are uint32 carried in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.device import resolve

_M32 = 0xFFFFFFFF

# ---- MD5 (counter mode) ---------------------------------------------

_MD5_K = [int(k) for k in np.floor(
    np.abs(np.sin(np.arange(1, 65))) * (1 << 32)).astype(np.uint32)]
_MD5_S = ([7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4
          + [6, 10, 15, 21] * 4)
_MD5_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def _md5(words: list, n: int, device) -> torch.Tensor:
    """MD5 compression of n single-block messages whose 16 words are
    int64 [n] tensors or ints (a constant word of every message) ->
    int64 [n, 4] digests in [0, 2^32)."""
    a, b, c, d = (torch.full((n,), v, dtype=torch.int64, device=device)
                  for v in _MD5_INIT)
    for i in range(64):
        if i < 16:
            f = (b & c) | ((b ^ _M32) & d)
            g = i
        elif i < 32:
            f = (d & b) | ((d ^ _M32) & c)
            g = (5 * i + 1) % 16
        elif i < 48:
            f = b ^ c ^ d
            g = (3 * i + 5) % 16
        else:
            f = c ^ (b | (d ^ _M32))
            g = (7 * i) % 16
        rot = (a + f + (_MD5_K[i] + words[g])) & _M32
        s = _MD5_S[i]
        a, d, c = d, c, b
        b = (b + (((rot << s) | (rot >> (32 - s))) & _M32)) & _M32
    return torch.stack([(x + v) & _M32
                        for x, v in zip((a, b, c, d), _MD5_INIT)], 1)


def md5_blocks(m: torch.Tensor) -> torch.Tensor:
    """MD5 compression of single-block messages.

    m: integer [n, 16] little-endian message words in [0, 2^32) (the
    caller pads).  Returns int64 [n, 4] digests (the a, b, c, d words,
    each the uint32 word)."""
    cols = m.to(torch.int64).t().contiguous()
    return _md5(list(cols), m.shape[0], m.device)


def md5_rand(n: int, seed: int,
             device: str | torch.device | None = None) -> torch.Tensor:
    """cudppRand (CUDPP_RAND_MD5 role): n 32-bit words of deterministic
    randomness, int64 [n] in [0, 2^32), from MD5 over 8-byte (seed,
    counter) messages with standard MD5 padding; each counter block
    gives 4 words."""
    dev = resolve(device)
    nblk = -(-n // 4)
    counter = torch.arange(nblk, dtype=torch.int64, device=dev)
    # seed, counter, the padding bit after 8 bytes, the length in bits
    words = [int(seed) & _M32, counter, 0x80] + [0] * 11 + [64, 0]
    return _md5(words, nblk, dev).reshape(-1)[:n]


# ---- sparse matrix-vector multiply (CSR) ----------------------------

def spmv(values: torch.Tensor, cols: torch.Tensor, row_ptr: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """cudppSparseMatrixVectorMultiply: CSR y = A @ x.

    values/cols: nnz entries; row_ptr: integer [nrows + 1].  Each
    entry's row by a `searchsorted`, then one `index_add_` (float sums
    in another order than tpulc's segment sum)."""
    nrows = row_ptr.shape[0] - 1
    prod = values * x[cols.to(torch.int64)]
    entry = torch.arange(cols.shape[0], dtype=row_ptr.dtype,
                         device=row_ptr.device)
    row_of = torch.searchsorted(row_ptr[1:].contiguous(), entry, right=True)
    y = torch.zeros(nrows, dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, row_of, prod)


# ---- tridiagonal solver (batched parallel cyclic reduction) ----------

def tridiagonal_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """cudppTridiagonal (crpcr role): solve tridiagonal systems.

    a (sub), b (diag), c (super), d (rhs): float [B, n], n a power of
    two; a[:, 0] and c[:, n-1] are ignored.  Parallel cyclic reduction:
    log2(n) vectorised rounds, no per-system serial loop."""
    n = b.shape[1]
    a = a.clone()
    c = c.clone()
    a[:, 0] = 0
    c[:, -1] = 0
    col = torch.arange(n, device=b.device)
    stride = 1
    while stride < n:
        def shl(x):
            return torch.nn.functional.pad(x, (0, stride))[:, stride:]

        def shr(x):
            return torch.nn.functional.pad(x, (stride, 0))[:, :n]

        bl, br = shl(b), shr(b)
        alpha = -a / torch.where(br == 0, 1, br)
        alpha = torch.where(col >= stride, alpha, 0)
        beta = -c / torch.where(bl == 0, 1, bl)
        beta = torch.where(col < n - stride, beta, 0)
        a, b, c, d = (alpha * shr(a),
                      b + alpha * shr(c) + beta * shl(a),
                      beta * shl(c),
                      d + alpha * shr(d) + beta * shl(d))
        stride *= 2
    return d / b


# ---- cuckoo hash table (cudpp_hash basic table) ---------------------

_EMPTY = _M32


def _h(keys: torch.Tensor, seed: int, size: int) -> torch.Tensor:
    """tpulc's 32-bit mix of int64 keys in [0, 2^32) -> int64 slots.
    Each product stays under 2^59 before the mask; `% size` acts on the
    unsigned value."""
    x = keys ^ seed
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    return x % size


def _u32(x, dev: torch.device) -> torch.Tensor:
    """uint32 keys or values (numpy or a tensor) -> int64 on dev."""
    if torch.is_tensor(x):
        return x.to(dev, torch.int64) & _M32
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64)).to(dev)


class CuckooTable:
    """Multiple-choice hash table with a stash (the cudpp_hash
    `CUDPP_BASIC_HASH_TABLE` role: 4-way cuckoo with a stash,
    `src/cudpp_hash/hash_table.cu`).

    Build: parallel eviction livelocks under simultaneous scatters, so
    (as tpulc) each round every pending key tries its current choice;
    a free slot takes one of them and placed keys never move; the
    stragglers after `max_rounds` go to a sorted stash.  One winner a
    slot: the largest index among the keys that may write it
    (`scatter_reduce_` "amax", XLA's last writer on the CPU), whose key
    and value are then written together.  Two separate scatters of keys
    and values would let the card pick two different winners and leave
    a slot with one key's key and another's value.  Keys are uint32 !=
    0xFFFFFFFF; `tk`, `tv`, `stash_k` and `stash_v` hold uint32 in
    int64; `rounds` counts the build's rounds."""

    SEEDS = (0x9E37, 0x85EB, 0xC2B2AE35, 0x27D4EB2F)

    def __init__(self, keys, vals, space: float = 1.6, max_rounds: int = 24,
                 device: str | torch.device | None = None):
        dev = resolve(device)
        keys_np = np.asarray(keys, np.uint32)
        vals_np = np.asarray(vals, np.uint32)
        n = len(keys_np)
        size = max(8, int(n * space))
        k, v = _u32(keys_np, dev), _u32(vals_np, dev)
        tk = torch.full((size,), _EMPTY, dtype=torch.int64, device=dev)
        tv = torch.zeros(size, dtype=torch.int64, device=dev)
        hs = [_h(k, s, size) for s in self.SEEDS]
        idx = torch.arange(n, device=dev)
        choice = torch.zeros(n, dtype=torch.int64, device=dev)
        pending = torch.ones(n, dtype=torch.bool, device=dev)
        self.rounds = 0
        for _ in range(max_rounds):
            slot = hs[0]
            for ci in range(1, 4):
                slot = torch.where(choice == ci, hs[ci], slot)
            # a key that may not write sends -1 to its own slot: no
            # atomic contends on one drop slot
            src = torch.where(pending & (tk[slot] == _EMPTY), idx, -1)
            win = torch.full((size,), -1, dtype=torch.int64, device=dev)
            win.scatter_reduce_(0, slot, src, "amax")
            won = win >= 0
            tk = torch.where(won, k[win.clamp(min=0)], tk)
            tv = torch.where(won, v[win.clamp(min=0)], tv)
            pending &= ~((tk[slot] == k) & (tv[slot] == v))
            # losers (slot occupied, or another key won it) advance
            choice = torch.where(pending, (choice + 1) % 4, choice)
            self.rounds += 1
            if not bool(pending.any()):
                break
        self.tk, self.tv, self.size = tk, tv, size
        left = np.flatnonzero(pending.cpu().numpy())
        sk, sv = keys_np[left], vals_np[left]
        order = np.argsort(sk)
        self.stash_k = _u32(np.append(sk[order], np.uint32(_EMPTY)), dev)
        self.stash_v = _u32(np.append(sv[order], np.uint32(0)), dev)

    def lookup(self, keys) -> tuple[torch.Tensor, torch.Tensor]:
        """uint32 keys (numpy or a tensor) -> (values int64 in [0,
        2^32), found bool), on the table's device."""
        k = _u32(keys, self.tk.device)
        val = torch.zeros_like(k)
        found = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
        for s in self.SEEDS:
            sl = _h(k, s, self.size)
            hit = (self.tk[sl] == k) & ~found
            val = torch.where(hit, self.tv[sl], val)
            found |= hit
        pos = torch.searchsorted(self.stash_k[:-1].contiguous(), k)
        shit = (self.stash_k[pos] == k) & ~found
        val = torch.where(shit, self.stash_v[pos], val)
        return val, found | shit
