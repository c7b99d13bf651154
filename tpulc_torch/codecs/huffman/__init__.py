"""Canonical length-limited Huffman codec (port of
`tpulc/codecs/huffman/`; the same exports as tpulc's package).

Package-merge code lengths, canonical codes and the flat 2^L decode LUT
(`tables`), parallel device encode (`encode`), the self-synchronising
decoder (`decode`), and the codec driver (`driver`) with the chunk walks
K3, K7 and K8 (`decode_kernels`).  Importing it builds nothing.
"""

from tpulc_torch.codecs.huffman.tables import (  # noqa: F401
    package_merge_lengths,
    canonical_codes,
    decode_lut,
    HuffmanTable,
)
from tpulc_torch.codecs.huffman.encode import huffman_encode  # noqa: F401
from tpulc_torch.codecs.huffman.decode import huffman_decode  # noqa: F401
