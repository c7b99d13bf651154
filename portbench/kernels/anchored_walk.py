"""The anchored inverse-BWT walk (a count launch, then one thread a
lane of LF steps): 33 bytes a byte walked (a 32-byte sector of the LF
map, the byte written) and 3 integer operations a step."""

WRAPPER = "tpulc_torch.codecs.bwt.ibwt_kernels:anchored_walk"
KERNELS = ("count_kernel", "anchored_walk_kernel")
PER_CALL = 2


def cost(args, kwargs, out):
    n = args[3]
    return 33 * n, 3 * n
