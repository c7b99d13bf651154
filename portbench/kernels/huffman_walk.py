"""K3: canonical Huffman decode of every chunk: a symbol costs its
max_len length compares plus 10 (window, index, reservoir)."""

from portbench.kernels import nbytes

WRAPPER = "tpulc_torch.codecs.huffman.decode_kernels:huffman_walk"
KERNELS = ("huffman_walk_kernel",)
PER_CALL = 1


def cost(args, kwargs, out):
    offs, chunk_syms, max_len = args[2], args[6], args[7]
    tensors = [a for a in args if hasattr(a, "element_size")]
    return (nbytes(*tensors, out),
            offs.shape[0] * chunk_syms * (max_len + 10))
