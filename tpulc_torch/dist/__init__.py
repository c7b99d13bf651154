"""Multi-device distribution layer (port of `tpulc/dist`).

tpulc maps blocks onto a 1-D device mesh with `shard_map`ped steps,
`psum` for the shared-dictionary histogram and `all_gather` of
per-block sizes for the container's offset table.  Here the mesh is a
`torch.distributed` `DeviceMesh` (`mesh.py`), each rank runs its own
contiguous block shard, and the collectives are `all_reduce` and
`all_gather` of its process group (`sharded.py`); `multihost.py`
stripes whole blocks over the ranks and assembles the container on rank
0; `dryrun.py` runs tpulc's multi-chip dry run on the port.  Importing
this package initialises no process group.
"""

from tpulc_torch.dist.mesh import make_mesh  # noqa: F401
from tpulc_torch.dist.sharded import (  # noqa: F401
    global_histogram,
    sharded_huffman_encode,
    sharded_huffman_roundtrip_step,
)
