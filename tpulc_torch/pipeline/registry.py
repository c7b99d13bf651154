"""Codec registry: the codec ids of `tpulc/pipeline/registry.py:12-18`
(the container's codec byte), resolving to the port's drivers.

All seven of tpulc's codecs are ported: `store`, `huffman`, `lzss`,
`culzss`, `bz`, `bsc` (every sorter, both coders) and `bzip2`.
"""

from __future__ import annotations

CODEC_STORE = 0        # raw block store (incompressible fallback)
CODEC_HUFFMAN = 1      # canonical Huffman, self-sync or aligned decode
CODEC_LZSS = 2         # Dipperstein 12/4 bitstream LZSS
CODEC_LZSS_CULZSS = 3  # CULZSS flag-byte 8/8 packet format
CODEC_BZ = 4           # BWT -> MTF -> RLE2 -> Huffman (bzip2-class)
CODEC_BSC = 5          # large-block LZP + QLFC-rank + rANS (bsc-class)
CODEC_BZIP2 = 6        # real .bz2 format, bit-exact vs bzip2 -9

_NAMES = {
    "store": CODEC_STORE,
    "huffman": CODEC_HUFFMAN,
    "lzss": CODEC_LZSS,
    "culzss": CODEC_LZSS_CULZSS,
    "bz": CODEC_BZ,
    "bsc": CODEC_BSC,
    "bzip2": CODEC_BZIP2,
}

def available_codecs() -> dict[str, int]:
    return dict(_NAMES)


def codec_name_of(cid: int) -> str:
    for name, i in _NAMES.items():
        if i == cid:
            return name
    return f"unknown({cid})"


def get_codec(name_or_id: str | int):
    """Resolve a codec driver module lazily by name or id."""
    cid = _NAMES[name_or_id] if isinstance(name_or_id, str) else name_or_id
    if cid == CODEC_STORE:
        from tpulc_torch.codecs import store as driver
        return driver
    if cid == CODEC_HUFFMAN:
        from tpulc_torch.codecs.huffman import driver
        return driver
    if cid == CODEC_BZ:
        from tpulc_torch.codecs.bwt import driver
        return driver
    if cid == CODEC_BSC:
        from tpulc_torch.codecs.bsclike import driver
        return driver
    if cid == CODEC_BZIP2:
        from tpulc_torch.codecs.bwt import bzip2_codec
        return bzip2_codec
    if cid == CODEC_LZSS:
        from tpulc_torch.codecs.lzss import driver
        return driver
    if cid == CODEC_LZSS_CULZSS:
        from tpulc_torch.codecs.lzss import culzss_driver
        return culzss_driver
    raise KeyError(f"unknown codec {name_or_id!r}")
