"""Device DC3 / skew suffix array: one sample level + doubling (port of
`tpulc/primitives/dc3_device.py`; the same arrays).

cudpp's recursive DC3 (`sa_app.cu:125-365`) with tpulc's structure:

  - the 2/3-sample recursion is rank doubling over the sample's name
    string (`_suffix_ranks`), whose early exit is DC3's "names unique"
    shortcut; tpulc's `while_loop` is a host loop with the same exit
    test, read on the host once a round;
  - the custom-comparator merge (`mgpu::MergePairs` with `my_less`,
    `sa_app.cu:27-35,292`) is three pairwise class orders made of plain
    key sorts (mod1 against mod2 from the sample ranks, and the unions
    mod0+mod1 keyed (char, successor rank) and mod0+mod2 keyed (char,
    char, rank)), counted into global ranks: global(x) = own_rank(x) +
    the cross-class counts, each a position in a union sort less the
    own rank;
  - the sample's characters and ranks are strided slices.

Every multi-key sort packs its keys into int64 words (one when they
fit) and runs stable `torch.sort`s: CUB's radix sort on the card.
"""

from __future__ import annotations

import torch

from tpulc_torch.codecs.bwt.rotsort import _scatter_perm
from tpulc_torch.primitives.suffix import _dense_rank

_FAN = 6  # rank keys a doubling round (cf. rotsort._FAN)
_CHAR = 256  # symbols are bytes + 1; 0 is the end sentinel


def _suffix_ranks(vals: torch.Tensor, high: int) -> torch.Tensor:
    """Unique 0-based suffix ranks of vals (each in [0, high]) by fan-6
    doubling.

    tpulc keys a position past the end by -1-overshoot, so a shorter
    suffix orders first at every depth.  Key j of position i is here
    rank[i + j k] + min(j k, m) while i + j k < m, else m - 1 - i (that
    key shifted up by j k): the same order, every key non-negative and
    under 2m, so a round's six keys need at most three int64 words."""
    m = vals.shape[0]
    idx = torch.arange(m, device=vals.device)
    rank = _dense_rank([vals], [high])
    k = 1
    _suffix_ranks.rounds = 0
    while k < m and int(rank.max()) < m - 1:
        keys, highs = [rank], [m - 1]
        for j in range(1, _FAN):
            span = min(j * k, m)
            keys.append(torch.where(idx + j * k < m,
                                    torch.roll(rank, -j * k) + span,
                                    m - 1 - idx))
            highs.append(m - 1 + span)
        rank = _dense_rank(keys, highs)
        k *= _FAN
        _suffix_ranks.rounds += 1
    return rank


_suffix_ranks.rounds = 0


def suffix_array_dc3(data: torch.Tensor) -> torch.Tensor:
    """SA of uint8[n] -> int64[n] via one DC3 sample level + doubling.
    Raises ValueError for n < 4 (`primitives.suffix.suffix_array` takes
    any n)."""
    n = data.shape[0]
    if n < 4:
        raise ValueError("suffix_array_dc3 needs n >= 4; use "
                         "primitives.suffix.suffix_array for tiny inputs")
    dev = data.device
    t = torch.cat([data.to(torch.int64) + 1,
                   torch.zeros(4, dtype=torch.int64, device=dev)])

    has_dummy = n % 3 == 1
    ntot = n + (1 if has_dummy else 0)
    n1p = len(range(1, ntot, 3))  # class 1, the dummy included
    n2 = len(range(2, ntot, 3))
    n0 = len(range(0, n, 3))
    m = n1p + n2

    # sample triples (strided slices, one 3-key sort)
    def tr(start):
        sl = t[start: start + ntot]
        return torch.cat([sl[1::3], sl[2::3]])

    pos12 = torch.cat([torch.arange(1, ntot, 3, device=dev),
                       torch.arange(2, ntot, 3, device=dev)])
    srank = _dense_rank([tr(0), tr(1), tr(2)], [_CHAR] * 3)
    # names in sample-slot order (class-1 block, then class 2), >= 1; the
    # suffix ranks of that name string ARE the sample suffix order
    rrank = _suffix_ranks(srank + 1, m)

    # drop the dummy sample (a rank adjustment, no compaction)
    if has_dummy:
        dummy_rank = rrank[n1p - 1]
        r12s = torch.where(rrank > dummy_rank, rrank - 1, rrank)
        r12s[n1p - 1] = -1
    else:
        r12s = rrank

    # rank over text positions (1-based; 0 past the end and off-sample)
    rank_arr = torch.zeros(n + 4, dtype=torch.int64, device=dev)
    rank_arr[pos12] = r12s + 1

    # SA0: class 0 by (char, successor rank), already a strict order
    t0 = t[0:n:3]
    rsucc0 = rank_arr[1: n + 1: 3]
    rank0 = _dense_rank([t0, rsucc0], [_CHAR, m])

    # class 1 and class 2 ranks among themselves
    r1_text = rank_arr[1: n + 1: 3][: len(range(1, n, 3))]  # 1-based
    r2_text = rank_arr[2: n + 1: 3][: len(range(2, n, 3))]
    n1 = r1_text.shape[0]
    own1 = _dense_rank([r1_text], [m])
    own2 = _dense_rank([r2_text], [m])

    # B = mod0 + mod1, key (t[i], rank[i+1]): a permutation
    posB = _dense_rank(
        [torch.cat([t0, t[1:n:3]]),
         torch.cat([rsucc0, rank_arr[2: n + 2: 3][:n1]])], [_CHAR, m])
    # A = mod0 + mod2, key (t[i], t[i+1], rank[i+2])
    posA = _dense_rank(
        [torch.cat([t0, t[2:n:3]]),
         torch.cat([t[1: n + 1: 3], t[3: n + 3: 3][:n2]]),
         torch.cat([rank_arr[2: n + 2: 3][:n0], rank_arr[4: n + 4: 3][:n2]])],
        [_CHAR, _CHAR, m])

    # global positions by pairwise counting
    g = torch.cat([posA[:n0] + posB[:n0] - rank0,
                   posB[n0:] + (r1_text - 1) - own1,
                   posA[n0:] + (r2_text - 1) - own2])
    p = torch.cat([torch.arange(0, n, 3, device=dev),
                   torch.arange(1, n, 3, device=dev),
                   torch.arange(2, n, 3, device=dev)])
    return _scatter_perm(g, p)
