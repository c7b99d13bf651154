"""K4: move-to-front decode of every chunk (from the identity or from
start tables): a step moves rank entries and reads and writes the
symbol, rank + 2 operations."""

from portbench.kernels import nbytes

WRAPPER = "tpulc_torch.primitives.mtf_kernels:mtf_lockstep"
KERNELS = ("mtf_decode_kernel",)
PER_CALL = 1


def cost(args, kwargs, out):
    ranks = args[1]
    return nbytes(*args[:2], out), int((ranks.clamp(0, 255).long() + 2).sum())
