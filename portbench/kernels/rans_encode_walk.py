"""Coder 1's encode walk: the valid steps' table entries, the lane
vector, the packed table and the reciprocals read once, every entry of
the words and the counts and states written once; 35 operations a
valid step (two table reads, the renormalisation test, a 32-bit divide
of ~20, the state update, the next context)."""

WRAPPER = "tpulc_torch.codecs.bsclike.rans:rans_encode_walk"
KERNELS = ("rans_encode_kernel",)
PER_CALL = 1
PROB_SCALE = 1 << 14


def cost(args, kwargs, out):
    idx, nsym, fc = args[0], args[1], args[2]
    C, L = idx.shape
    steps = int(nsym.long().sum())
    nbytes = (4 * steps + 4 * L + 4 * fc.numel() + 4 * (PROB_SCALE + 1)
              + 2 * L * (C + 2) + 16 * L)
    return nbytes, 35 * steps
