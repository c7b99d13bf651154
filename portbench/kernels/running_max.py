"""The 1-D running max scan (one launch, decoupled look-back): the
array read once and written once, one operation an element."""

from portbench.kernels import nbytes

WRAPPER = "tpulc_torch.primitives.scan_kernels:running_max"
KERNELS = ("scan_kernel",)
PER_CALL = 1


def cost(args, kwargs, out):
    x = args[0]
    return nbytes(x, out), x.shape[0]
