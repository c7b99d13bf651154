"""The one generator of the benchmark's traffic mixes.

A mix is a JSON file beside this module (`<mix>.json`) naming a `kind`
and its parameters; `objects(mix, seed, root)` makes the run's objects
from the seed, every seed the same count and sizes:

- `rotate_tile`: the bytes of `file` (a path under the checkout),
  rotated left by an offset drawn from the seed, tiled `tile` times;
  `objects` of them, each with its own offset.
- `word_draw`: `size` bytes of the tokens of `file` (a word and the
  spaces, punctuation and line ends after it) drawn independently, each
  as often as it occurs in the file, cut to size; `objects` of them,
  each from its own draws.
"""

from __future__ import annotations

import os
import re

import numpy as np

TOKEN = re.compile(rb"[A-Za-z0-9']+[^A-Za-z0-9']*")


def _read(root: str, path: str) -> bytes:
    with open(os.path.join(root, path), "rb") as f:
        return f.read()


def _rotate_tile(mix: dict, rng, root: str) -> list[np.ndarray]:
    raw = np.frombuffer(_read(root, mix["file"]), np.uint8)
    offsets = rng.integers(0, raw.shape[0], size=mix["objects"])
    return [np.tile(np.roll(raw, -int(o)), mix["tile"]) for o in offsets]


def _word_draw(mix: dict, rng, root: str) -> list[np.ndarray]:
    text = _read(root, mix["file"])
    raw = np.frombuffer(text, np.uint8)
    spans = [m.span() for m in TOKEN.finditer(text)]
    starts = np.array([s for s, _ in spans], np.int64)
    lens = np.array([e - s for s, e in spans], np.int64)
    size = mix["size"]
    out = []
    for _ in range(mix["objects"]):
        # enough draws to pass `size` on every seed: the mean token
        # length times 1.25, then more draws until the bytes suffice
        idx = rng.integers(len(spans), size=int(size / lens.mean() * 1.25))
        while lens[idx].sum() < size:
            idx = np.concatenate([idx, rng.integers(len(spans),
                                                    size=len(idx) // 8 + 1)])
        ln = lens[idx]
        end = np.cumsum(ln)
        cut = int(np.searchsorted(end, size)) + 1
        ln, end = ln[:cut], end[:cut]
        src = np.repeat(starts[idx[:cut]] - (end - ln), ln)
        src += np.arange(src.shape[0])
        out.append(raw[src[:size]])
    return out


KINDS = {"rotate_tile": _rotate_tile, "word_draw": _word_draw}


def objects(mix: dict, seed: int, root: str) -> list[np.ndarray]:
    """The mix's objects for this seed, uint8 arrays."""
    return KINDS[mix["kind"]](mix, np.random.default_rng(seed), root)
