"""Preprocessing filters and detectors of the bsc codec (the host numpy
parts of `tpulc/codecs/bsclike/filters.py`, copied so that every choice
matches tpulc's).

- record reorder: transpose fixed-width records (AoS -> SoA) so
  same-field bytes cluster before the block sorter (libbsc's
  `bsc_reorder_forward`); block reverse (`bsc_reverse_block`);
- the record-size detector behind `--filter auto`;
- the entropy-model segmentation detector (libbsc's
  `bsc_detect_segments`, `detectors.cpp:70-290`) and its O(n) gate.

All of it runs on the host in float64 numpy, as in tpulc.
"""

from __future__ import annotations

import numpy as np

# filter byte on the wire: 0 = none, 1 = reverse, else reorder with
# record size = the byte value (2..255)
FILTER_NONE = 0
FILTER_REVERSE = 1


def apply_filter_np(block: np.ndarray, filter_byte: int) -> np.ndarray:
    """Host-side forward filter (the codec's encode-side stage)."""
    if filter_byte == FILTER_NONE:
        return block
    if filter_byte == FILTER_REVERSE:
        return block[::-1]
    rs = filter_byte
    body = (len(block) // rs) * rs
    return np.concatenate(
        [np.ascontiguousarray(block[:body].reshape(-1, rs).T).reshape(-1),
         block[body:]]
    )


def invert_filter_np(block: np.ndarray, filter_byte: int) -> np.ndarray:
    """Host-side inverse filter (the codec's decode-side stage)."""
    if filter_byte == FILTER_NONE:
        return block
    if filter_byte == FILTER_REVERSE:
        return block[::-1]
    rs = filter_byte
    body = (len(block) // rs) * rs
    return np.concatenate(
        [np.ascontiguousarray(block[:body].reshape(rs, -1).T).reshape(-1),
         block[body:]]
    )


def detect_record_size(block: np.ndarray, max_size: int = 32,
                       sample: int = 1 << 18, margin: float = 1.25,
                       floor: float = 0.10) -> int:
    """Suggest a record size for `--filter auto`, or 0 for none.

    Byte-equality autocorrelation: fixed-width records make
    ``data[i] == data[i - N]`` markedly more likely at the true record
    stride N than at lag 1.  Returns the best N in [2, max_size] when
    its score clears both the lag-1 baseline by `margin` and an absolute
    `floor`; 0 otherwise.
    """
    arr = np.asarray(block[:sample], np.uint8)
    n = len(arr)
    if n < 4 * max_size:
        return 0
    base = float((arr[1:] == arr[:-1]).mean())
    best_n, best_s = 0, 0.0
    for N in range(2, max_size + 1):
        s = float((arr[N:] == arr[:-N]).mean())
        if s > best_s:
            best_n, best_s = N, s
    if best_s > max(margin * base, floor):
        return best_n
    return 0


# --- entropy-model segmentation (bsc_detect_segments) ---

SEG_MIN_BLOCK = 24576          # DETECTORS_BLOCK_SIZE
_SEG_SCALE = 65536.0           # reference entropy units: 65536 = 1 bit


def _seg_entropy(f: np.ndarray) -> np.ndarray:
    """bsc_entropy: f * log2(f) in 65536-per-bit units (E(0)=0)."""
    f = f.astype(np.float64)
    out = np.zeros_like(f)
    nz = f > 0
    out[nz] = f[nz] * np.log2(f[nz]) * _SEG_SCALE
    return out


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence index of each element among equal keys seen before it
    (vectorized groupby-cumcount; uint16 keys take numpy's radix sort)."""
    n = keys.shape[0]
    if n and keys.max() < (1 << 16):
        keys = keys.astype(np.uint16)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    counts = np.diff(np.r_[starts, n])
    k_sorted = np.arange(n) - np.repeat(starts, counts)
    out = np.empty(n, np.int64)
    out[order] = k_sorted
    return out


def detect_split_point(block: np.ndarray) -> int:
    """One split point per `bsc_detect_segments_serial`: an order-2
    hashed-context adaptive entropy model; returns i < n if coding
    [0,i) and [i,n) separately saves more than n_entropy/32 +
    12KB-equivalent model bits, else n.  The context at i is exactly
    ((s[i-2] << 5) ^ s[i-1]) & 0xFF, so the sequential counter scan is
    two groupby-cumcounts plus a prefix sum."""
    x = np.asarray(block, np.uint8).astype(np.int64)
    n = x.shape[0]
    if n < SEG_MIN_BLOCK:
        return n
    ctx = np.zeros(n, np.int64)
    if n > 1:
        ctx[1] = x[0] & 0xFF
    ctx[2:] = ((x[:-2] << 5) ^ x[1:-1]) & 0xFF
    pair = ctx * 256 + x

    r_tot = np.bincount(pair, minlength=65536)
    c_tot = np.bincount(ctx, minlength=256)
    entropy = _seg_entropy(c_tot).sum() - _seg_entropy(r_tot).sum()

    k = _cumcount(pair)                     # pair occurrences before i
    m = _cumcount(ctx)                      # context occurrences before i
    ev = _seg_entropy(np.arange(n + 2, dtype=np.float64))
    dl = ev[1:] - ev[:-1]                   # dl[f] = E(f+1) - E(f)
    d = (
        dl[r_tot[pair] - k - 1]             # right freq f -> f-1
        - dl[k]                             # left freq k -> k+1
        - dl[c_tot[ctx] - m - 1]            # right count
        + dl[m]                             # left count
    )
    local = entropy + np.r_[0.0, np.cumsum(d)[:-1]]
    best0 = entropy - entropy / 32.0 - _SEG_SCALE * 12 * 1024
    i = int(np.argmin(local))
    return i if local[i] < best0 else n


def looks_heterogeneous(block: np.ndarray, threshold: float = 0.25) -> bool:
    """O(n) gate for the segmentation detector: max L1 distance between
    adjacent 64 KB windows' byte distributions (homogeneous text sits
    well under 0.25; a text|binary boundary exceeds it)."""
    n = len(block)
    if n < SEG_MIN_BLOCK:
        return False
    W = 1 << 16
    nw = n // W
    if nw < 2:
        # block shorter than two windows: halve
        W = max(4096, n // 2)
        nw = n // W
        if nw < 2:
            return False
    x = np.asarray(block[: nw * W], np.uint8).reshape(nw, W)
    h = np.stack([np.bincount(row, minlength=256) for row in x])
    h = h.astype(np.float64) / W
    return bool(np.abs(h[1:] - h[:-1]).sum(axis=1).max() > threshold)


def detect_segments_gated(block: np.ndarray) -> list[int]:
    """`detect_segments` behind the `looks_heterogeneous` gate, the form
    the default compress path uses."""
    if not looks_heterogeneous(block):
        return [len(block)]
    return detect_segments(block)


def detect_segments(block: np.ndarray, max_segments: int = 256) -> list[int]:
    """Recursive segmentation (`bsc_detect_segments_recursive`):
    segment lengths summing to n."""
    n = len(block)
    if n < SEG_MIN_BLOCK or max_segments == 1:
        return [n]
    split = detect_split_point(block)
    if split == n or split == 0:
        return [n]
    left = detect_segments(block[:split], max_segments - 1)
    right = detect_segments(block[split:], max_segments - len(left))
    return left + right
