"""Seconds of the huffman codec's batched decode on the device (stage
huffman.decode: the decode tables, the chunk walk, ranks to symbols) per
GB decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress", ("huffman.decode",))
