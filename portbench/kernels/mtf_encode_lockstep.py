"""K2: move-to-front encode of every chunk from its start table: a
step finds the symbol (rank compares) and shifts rank entries, 2 *
rank + 2 operations."""

from portbench.kernels import nbytes

WRAPPER = "tpulc_torch.primitives.mtf_kernels:mtf_encode_lockstep"
KERNELS = ("mtf_encode_walk_kernel",)
PER_CALL = 1


def cost(args, kwargs, out):
    ranks = out[0]
    return nbytes(*args, out), int((2 * ranks.long() + 2).sum())
