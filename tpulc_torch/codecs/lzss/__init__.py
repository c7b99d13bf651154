"""The LZ codecs (port of `tpulc/codecs/lzss`): the Dipperstein LZSS
codec (`lzss`) and the CULZSS packet codec (`culzss`, `culzss.py` and
`culzss_driver.py`).

`lzss`'s wire format: the lzss-0.6.2 bitstream (12-bit ring offset,
4-bit length, `cuda-lzss-unknown/lzss-0.6.2/lzlocal.h:70-82`),
interoperable both ways with the reference CPU codec.

Design (against the reference's serial loops): encode by sort-based
3-gram candidates, packed-word match extension and a path-doubling
greedy parse; decode by the map-composition scan of token boundaries
and pointer doubling of copy sources.
"""

from tpulc_torch.codecs.lzss.decode import lzss_decode_device  # noqa: F401
from tpulc_torch.codecs.lzss.encode import lzss_encode_device  # noqa: F401
