"""The MTF start tables from K1's rows: a max of the scan over chunks
and log2(256) = 8 compares of the sort by recency, 9 operations an
entry of the rows."""

from portbench.kernels import nbytes

WRAPPER = "tpulc_torch.primitives.mtf_kernels:mtf_start_tables"
KERNELS = ("mtf_start_kernel",)
PER_CALL = 1


def cost(args, kwargs, out):
    rec = args[0]
    return nbytes(rec, out), 9 * rec.numel()
