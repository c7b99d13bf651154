"""Coder 1's decode walk: the words the lanes take, the lane vectors
and the packed table read once (the slot table is not read), the
symbols written once; 35 operations a valid step.  The words a lane
takes are counted up to its last nonzero word (the rows hold zeros past
each lane's words), which can only undercount."""

import torch

WRAPPER = "tpulc_torch.codecs.bsclike.rans:rans_decode_walk"
KERNELS = ("rans_decode_kernel", "rans_decode_fused_kernel")
PER_CALL = 1


def cost(args, kwargs, out):
    words, nsym, fc = args[0], args[3], args[5]
    chunk = args[7] if len(args) > 7 else kwargs.get("chunk", 512)
    L, W = words.shape
    col = torch.arange(1, W + 1, device=words.device)
    taken = int(torch.where(words != 0, col, 0).amax(1).sum())
    return (2 * taken + 20 * L + 4 * fc.numel() + 4 * L * chunk,
            35 * int(nsym.long().sum()))
