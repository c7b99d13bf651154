"""K1: each chunk's last-occurrence row of the 256 symbols (and the
tile maxima of those rows): a read of the symbols, 256 entries written
a chunk; one compare a symbol and one write an entry."""

from portbench.kernels import nbytes

WRAPPER = "tpulc_torch.primitives.mtf_kernels:mtf_recency"
KERNELS = ("mtf_recency_kernel",)
PER_CALL = 1


def cost(args, kwargs, out):
    syms = args[0]
    return nbytes(syms, out), syms.numel() + 256 * syms.shape[0]
