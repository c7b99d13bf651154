"""Seconds of the huffman codec's pull of the decoded symbols to the host
(stage huffman.pull) per GB decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress", ("huffman.pull",))
