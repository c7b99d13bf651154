"""Seconds of the huffman codec's host parse of a group's payloads into
batch arrays and their upload (stage huffman.parse) per GB
decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress", ("huffman.parse",))
