"""Seconds of the huffman codec's batched encode (stage huffman.encode:
the blocks' upload, histogram, package-merge lengths, canonical codes,
the code gather and pack_bits) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("huffman.encode",))
