#!/usr/bin/env python3
"""Prove the PyTorch/CUDA port (tpulc_torch) runs on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --e1
    python3 chip_smoke.py --st
    python3 chip_smoke.py --lz
    python3 chip_smoke.py --dist
    python3 chip_smoke.py --prim
    python3 chip_smoke.py --huff

`--e1`: the card, the build and phase 9 alone; `--st`: the same for
phase 10; `--lz`: the same for phases 11 and 12; `--dist`: the same for
phase 13; `--prim`: the same for phase 14; `--huff`: the same for
phases 5 and 6.

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit (nvidia-smi); CUDA must be present;
2. build the hand-written kernels from tpulc_torch/csrc (nvcc, sm_90a);
3. each kernel (K1 with the start tables' tile maxima, the MTF start
   tables from those maxima, K2, K4 MTF; K3 Huffman walk) against its
   plain PyTorch version on the card at the main path's shapes (7,032
   chunks x 128 from a real 900 KB block; K3 on that block's real
   stream): bit-identical, timed with CUDA events (median of 5 after
   warm-up); then K2's walk (the share of steps it walks, ns a walked
   step, registers, waves) and every build of the other redesigned
   kernels at this shape, each equal to the plain version: K4 at 32, 16
   and 8 lanes a chunk (ms, ns a step, registers, waves), K4 as
   `mtf_decode` calls it (identity start without symbols; without the
   final table), K1 and the start tables at 8-, 16-, 32- and 64-chunk
   tiles (K1 with and without the maxima; the start tables from K1's
   maxima and from their own), K3 at 32-, 64- and
   128-chunk tiles; the running max / min scans (csrc/scan.cu) on the
   four arrays the first block's RLE2 scans (`rle2_encode`'s three,
   `rle2_decode`'s one) and the anchored inverse-BWT walk
   (csrc/ibwt.cu) on its real last column and anchors, each against its
   plain version, the scans beside torch.cummax / cummin; then the walk
   at every lanes a warp, and each wrapper's device time and CUDA
   launches a call (torch.profiler);
4. the bz main path: bz compress + decompress of pg1661 x 6 (3,569,598
   B, 900,000 B blocks) through the codec entry points on the card, with
   every kernel's launch count reset before and read after; exact round
   trip, ratio 4.145, each kernel launched (K1, the start tables and K2
   once a block, the walk once an anchored block, each scan once a call
   of the path), the container byte-identical
   to the port's CPU path on a small input; MB/s from warm repeats;
   stage times and a torch.profiler trace of one warm compress and one
   warm decompress, in which no torch.cummax / cummin may run;
5. the huffman kernels (K3 packed, K7 v1, K8 flat) against their plain
   versions at the huffman path's full width: the 100 MB group of 96
   blocks x 8,192 chunks x 128 symbols from its real streams;
   bit-identical, timed as in phase 3; K3 packed at every tile; K3, K7
   and K8 on two streams whose chunk offsets are in random order, which
   sends every tile down its global-memory route, K7 with bases of any
   int32 and K8 with non-nested limits and bits_left of 0, below 0 and
   past C*L on the whole group, each equal to the plain version;
6. the huffman main path: compress + decompress of 100,000,000 B of
   pg1661 at 1 MiB blocks, counted as in phase 4: exact round trip, the
   container's size and sha256 equal to tpulc's, K3 launched; decoded
   again with kernel="v1" and "flat" (K7 and K8 counted the same way);
   pg1661 x 6 at 1 MiB equal to tpulc's container; MB/s from warm
   repeats, decode-only GB/s per decoder on device-resident parsed
   input and where each decoder's decode-only time goes (arguments,
   walk, rank-to-symbol map, the rest), the self-sync decode's time,
   peak device memory, stage times and a trace as in phase 4;
7. the group-rank coder's kernels (K5 model walk, the reverse-rANS
   emission that reads K5's output, K6 decode FSM) against their plain
   versions on real grids at both bsc shapes: pg1661 x 6 at 4 MiB
   blocks (1,024 lanes after LZP) and the first 25 MiB block of 100 MB
   of word soup (25,600 lanes); bit-identical, timed as in phase 3 (the
   plain versions once: they take seconds); then K5 and K6 at 32 and
   64 lanes a block, each output equal to the default 94's;
   and K1, the start tables, K2 and K4 at the soup shape (204,800
   chunks x 128 from that block's real BWT output; the plain K2 and K4
   once), with K2's walk and every K4, K1 and start-table build as in
   phase 3 and the device time and count of each of the start tables'
   launches on K1's maxima (the memset and the kernel);
8. the bsc -e2 main path, counted as in phase 4: pg1661 x 6 at 4 MiB
   blocks (exact round trip, ratio 21.281, tpulc's sha256, K4
   launched, K1, the start tables, K2, K5, the emission and K6 once per
   block, the scans once a call and the walk once a block, the card's
   container equal to the CPU path's on 50 KB, MB/s from warm repeats),
   then 100,000,000 B of bench.py's word soup at 25 MiB blocks (4
   blocks, exact round trip, K1, the start tables, K2, K5, the emission
   and K6 once and K4 twice per block, MB/s, stage times, peak device
   memory, and a
   torch.profiler trace of one warm compress and one warm decompress:
   device-busy share and the top device times);
9. the bsc -e1 main path (tpulc's default coder, through
   get_codec("bsc") with tpulc's defaults): first coder 1's encode and
   decode walks (csrc/rans_ctx.cu) against their plain versions on the
   arguments each cell's path gives them, timed as in phase 3; then,
   counted as in phase 4, pg1661 x 6 at 4 MiB blocks (exact round trip,
   177,610 B, ratio 20.098, tpulc's sha256, K1, the start tables and K2
   once a block, K4 twice, each walk once a call, the card's container
   equal to the CPU path's on 50 KB, MB/s from warm repeats) and 100 MB
   of word soup at 25 MiB blocks (the same checks at 8,361,750 B, stage
   times, peak device memory and a trace as in phase 8), the scans
   once a call and the walk once a block in both; on the soup's first
   block the scans and the walk against their plain versions as in
   phase 3;
10. bsc on the ST sorters (`ST_CELLS`: `-m st8`, `st8 -e2` and `st8w
   -e2` on pg1661 x 6 at 4 MiB, `st8 -e2` and `st8w -e2` on one 25 MiB
   block of bench.py's soup), counted as in phase 4: each container's
   size, ratio and sha256 equal to tpulc's, an exact round trip, K1,
   the start tables and K2 once a compress block, K4 twice a decompress
   block, each coder walk once a call, the host inverse-ST walk once a
   hybrid block; the adaptive coder's encode and decode walks
   (csrc/abc.cu) against their plain versions on the arguments each
   -e2 cell's run gave them, and K1, the start tables, K2 and K4 at
   st8w's 409,600 chunks; stage times (the host walk's seconds a
   block), peak device memory, MB/s (the hybrid soup cell decodes once,
   under the profiler) and the soup cells' traces;
11. bzip2 at level 9 and lzss at 1 MiB blocks on pg1661 x 6 through
   get_codec, counted as in phase 4: bzip2 writes the bytes of Python's
   `bz2.compress` (ratio 4.395), launches K1, the start tables and K2
   once a block, round-trips through the port and `bz2.decompress`, and
   those three kernels are held against their plain versions on the
   last block's arguments; lzss writes tpulc's container (1,862,942 B,
   ratio 1.916, sha256), round-trips, writes the CPU path's container on
   150 KB, and counts its decode's host-synced steps; stage times, MB/s
   from warm repeats, peak device memory and a trace of each direction;
   then lzss on bench.py's make_soup(3,569,598) at 1 MiB: tpulc's
   container (629,458 B, ratio 5.671, sha256) and an exact round trip;
12. culzss at 1 MiB blocks through get_codec, counted as in phase 4 (the
   match kernel, csrc/culzss_match.cu, once an encode group and no
   other hand kernel): on pg1661 x 6
   and on make_soup(3,569,598), tpulc's containers (size, ratio,
   sha256) and exact round trips, with stage times (grid, doubling,
   parse, pack, pull, container; payloads, records, doubling
   rounds, out, verify), MB/s from warm repeats, peak device memory and
   a trace of
   each direction; the card's container equal to the CPU path's on 150
   KB; 100,000,000 B of the soup (24,415 packets) round-tripped
   exactly, its peak device memory printed beside the packet groups;
   that compress counted as in phase 4 (the match kernel once in each
   of its 24 encode groups, nothing else); the match kernel against
   its plain version on that soup's packet grid, at one group of 1,024
   packets and at the call's 24 groups of 24,415, a launch a group as
   the encode makes them;
13. the distribution layer on the card: the port's dry run (tpulc's
   seven sharded checks) as a user calls it, on one spawned NCCL rank,
   then in an NCCL group of world size 1: the dry run; each sharded
   step at tpulc's dry-run shapes with tpulc's outputs (their sha256)
   and equal to the same functions run without a group on the same
   card, with the same hand-kernel launches, which are printed;
   compress_multihost of pg1661 x 6 writes tpulc's
   single-process compress_multihost bytes for bz (900,000 B blocks)
   and phase 12's container for culzss.  One card: multi-GPU scaling is
   not measured;
14. the primitive layer (plain torch, no hand kernel may launch but the
   culzss match kernel of the codec that writes the golds' packets) at the
   sizes users run, each timed as the median of 3 warm runs between
   synchronisations, with GB/s of input and peak device memory: the
   doubling and device-DC3 suffix arrays of pg1661 x 6 and of one 25
   MiB soup block, equal to each other and, on the first 900,000 B, to
   the host DC3 (doubling rounds printed); SA + sa_to_bwt on that
   900,000 B block (and, outside the layer's count, bz's
   rotsort.bwt_encode_anchored on it); sort_strings_full
   of pg1661 x 6's lines against Python's sorted (ties by the device
   DC3's ranks); scans (cummax beside the log-step form),
   segmented_scan, compact, multisplit, sort_pairs, merge_sorted and
   reduce on 2^26 int32 against numpy; listrank of 2^24 nodes; md5_rand
   of 2^26 words against hashlib on 4,096 blocks; spmv of 2^20 x 32
   against float64 numpy; tridiagonal_solve of 4,096 systems x 1,024
   by float64 residual; a cuckoo table of 2^22 keys (every value right,
   2^22 absent keys not found); byte histograms of 100 MB and 96 x 1
   MiB; the lzss gold and the card decoding each other's streams of
   phase 11's blocks, and every culzss packet of phase 12 decoded by
   the serial gold.
   The script's total seconds are printed before the last two lines.

Every kernel entry carries its bound: the larger of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s
and its integer operations over 67 T op/s (the H100 SXM figures of
NVIDIA's data sheet), and, where one PyTorch call computes the same
function (K1's rows: `scatter_reduce_` "amax"), that call's time.  The
serial coder walks' (coder 1's, the adaptive coder's and the
reverse-rANS emission's) lines before the JSON also print `chain`: the
fewest dependent integer operations the function needs on its longest
lane (`*_CHAIN` a step, counted from the function; `abc_encode_chain`
for the adaptive encode, `emission_chain` for the emission: its
longest lane's events) times 4 cycles over the card's maximum SM clock
(nvidia-smi), a computed term kept out of the `kernels` line.  K1's
bytes include its tile maxima; the start tables' are the function's
(K1's rows in, the tables out), whichever route feeds them.  The start
tables' plain version is the chain of PyTorch calls the path ran
before they had a kernel (`cummax`, `cat`, a stable `argsort`); no one
call computes them.  The scans' library time is torch.cummax /
cummin (a reverse scan's on the flipped input); their bytes are x read
and y written once.  The walk's bytes are its n table reads as 32-byte
sectors and its n output bytes; no one PyTorch call computes it.  `ms`
is the wrapper's call between two CUDA events; `device_ms` is the
kernel alone, from a CUDA graph of 5 calls replayed, because the
wrapper's host time exceeds a kernel of some tens of microseconds.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from functools import partial

CORPUS_SIZE = 3_569_598  # pg1661.txt x 6, bench.py's corpus
BLOCK = 900_000
RATIO = 4.145
# tpulc's container for the same input (JAX reference, CPU run)
TPULC_SHA256 = "e8895df92c8f65d717206d88007f6ffc6a957b68b14341026371e1afa5dd724e"
# huffman, bench.py's huffman_decode_100MB input at 1 MiB blocks, and
# pg1661 x 6 at 1 MiB: tpulc's containers (JAX reference, CPU run)
HUFF_SIZE = 100_000_000
HUFF_BLOCK = 1 << 20
HUFF_MAX_LEN = 12
HUFF_BYTES = 59_030_504
HUFF_SHA256 = "65530b4906eaf5f8098dbc2a2866e6ce41d43294cdbe438098a7428e78a555fb"
HUFF_X6_SHA256 = "8ad209108c27f84d686c37ec34076dba64b2394f48f855d66632d9b582a88282"
# bsc -e2 (bench.py's bsc_e2 setting) on pg1661 x 6 at 4 MiB blocks:
# tpulc's container (JAX reference, CPU run)
BSC_BLOCK = 4 << 20
BSC_RATIO = 21.281
BSC_SHA256 = "8fc81d25cff86f7dd3b5838e17d92333e3b04a8bb0731ae12d5baac9bc26e82b"
# bsc -e2 at bsc's default 25 MiB blocks on bench.py's make_soup bytes
SOUP_SIZE = 100_000_000
SOUP_BLOCK = 25 << 20
SOUP_SHA256 = "93286634ddbf920ee02839cd0a6640a9808ad85df88fdd3d2c402849534066b4"
# bsc -e1 (tpulc's defaults: coder 1, bench.py's bsc setting) on pg1661 x
# 6 at 4 MiB and on the soup at 25 MiB: tpulc's containers (JAX
# reference, CPU run)
BSC_E1_BYTES = 177_610
BSC_E1_RATIO = 20.098
BSC_E1_SHA256 = "12807218c93267d082dc1123e032925e186e0be902eb2d3e78d0cb5a18070462"
SOUP_E1_BYTES = 8_361_750
SOUP_E1_RATIO = 11.959
SOUP_E1_SHA256 = "c9ad5986f2de0a097b60446e9564a7beac0b4f944f50a174c7b33bb9cb9d4731"
# bsc on the ST sorters (`-m st8`, `st8w`; `-e 1` and `-e 2`, the
# adaptive binary coder) on pg1661 x 6 at 4 MiB and on one 25 MiB block
# of bench.py's make_soup(26_214_400): tpulc's containers (JAX
# reference, CPU run) -> (label, input, block, sorter, coder, bytes,
# ratio, sha256)
ST_SOUP_SIZE = 25 << 20
ST_SOUP_SHA256 = "fec9871127e52845634d68da4111927e3006deb0a6092b5a2f223c1ae6b073f4"
ST_CELLS = (
    ("st8", "pg", BSC_BLOCK, "st8", 1, 176_455, 20.230,
     "7c14c7e761e1432456dc70630c541570105901597a9acc98bea5699b15904937"),
    ("st8_e2", "pg", BSC_BLOCK, "st8", 2, 168_249, 21.216,
     "efb425baf67d981b511dc065355e1320cbd63e7da26d334a10bfc3ff78b48374"),
    ("st8w_e2", "pg", BSC_BLOCK, "st8w", 2, 481_240, 7.418,
     "36e5606936fa7b19299f59bb5495bec0a0276740846344db45c1e271054dac92"),
    ("soup25_st8_e2", "soup", SOUP_BLOCK, "st8", 2, 2_140_816, 12.245,
     "7968dfe488ef04da0eff5d59845ca0ca2062c0e7687d5a78f7f699a05b2aea84"),
    ("soup25_st8w_e2", "soup", SOUP_BLOCK, "st8w", 2, 4_298_370, 6.099,
     "7cf872d7b17bc9c378154f86bf50e0479bdcebacf0e4a337f1f8b37339c31195"),
)
ABC_SRC = "tpulc_torch/csrc/abc.cu"
# bzip2 at level 9 (Python's bz2 module gives the expected bytes) and
# lzss at 1 MiB blocks on pg1661 x 6: tpulc's lzss container (JAX
# reference, CPU run)
BZIP2_LEVEL = 9
BZIP2_RATIO = 4.395
LZSS_BLOCK = 1 << 20
LZSS_BYTES = 1_862_942
LZSS_RATIO = 1.916
LZSS_SHA256 = "592a4aea47217fb6520d7a89dbbf08d4485750f76865ef5c472069d8127f8e47"
# lzss and culzss at 1 MiB blocks on bench.py's make_soup(3,569,598), and
# culzss on pg1661 x 6: tpulc's containers (JAX reference, CPU run) ->
# (label, input, bytes, ratio, sha256)
LZSS_SOUP = ("soup", "soup", 629_458, 5.671,
             "d05c264c16a6fac03c7d3e695f51fea4d2aeb173e729d666445cbf555f0af561")
CULZSS_BLOCK = 1 << 20
CULZSS_CELLS = (
    ("pg1661x6", "pg", 3_348_444, 1.066,
     "31fa4d205583e976632d184bafdd503d5ae1fc8f858078f9a95b4c56b3565f1b"),
    ("soup", "soup", 1_914_803, 1.864,
     "eb94050ca61816e17edf196e39c40c57c6517f7360257994f64d1c0a24347b9b"),
)
CULZSS_BIG = 100_000_000
# the sharded steps of phase 13 at tpulc's dry-run shapes (its
# `dryrun_multichip`: 512-byte blocks, culzss a packet a block, 2 blocks
# a rank) -> (step, block size, the hand kernels its functions launch,
# `outputs_sha256` of tpulc's step on make_args(2, 0): JAX reference,
# CPU run, pinned by tests/test_torch_dist.py)
DIST_STEPS = (
    ("huffman_roundtrip_step", 512, (),
     "b83fc8e651df52b57b1c855deb1a321ac3a130b685cd6ffdcef7cb473d9d0a22"),
    ("bz_forward", 512,
     ("mtf_recency", "mtf_start_tables", "mtf_encode_lockstep",
      "running_max", "running_min"),
     "a43c62c8f542b8acaac5451dfa3ae6b3fb6a856bf6ffc59b39cebe3854ce5d8f"),
    ("bz_roundtrip", 512,
     ("mtf_recency", "mtf_start_tables", "mtf_encode_lockstep",
      "mtf_lockstep", "running_max", "running_min"),
     "d7c1a483ddfd306f5d49e8088545af0a3079e07ece807c3d497b65b5ad4694fc"),
    ("bsc_rans_forward", 512,
     ("mtf_recency", "mtf_start_tables", "mtf_encode_lockstep",
      "rans_encode_walk", "running_max", "running_min"),
     "d5d19a97f0bfaa9f2b9e2be49726d1c28802eadafca18be00eaea6c0224bfb54"),
    ("abc_roundtrip", 512, ("abc_encode_walk", "abc_decode_walk"),
     "a79f8d03ccca6424cab7c9a5698d358633b3c1ad3a010adddcfadac803cefad1"),
    ("grc_roundtrip", 512,
     ("grc_walk_probs", "grc_reverse_rans", "grc_decode_walk",
      "running_max", "running_min"),
     "a5efec28d836329873b1479ad5a63fad9820ba46bd7aab86f56014cb60b3ee1e"),
    ("culzss_roundtrip", 4096, ("culzss_match",),
     "e670ea69fef2976b032d4566e2c0480c279450fcc336969488506e236b052867"),
)
# tpulc's single-process compress_multihost of pg1661 x 6 as bz at
# 900,000 B blocks (JAX reference, CPU run): bz's own container, whose
# flags are 0 and whose blocks are coded independently
DIST_BZ_SHA256 = TPULC_SHA256
# the CUDA runtime and driver calls that launch a kernel, as the
# profiler names them on the host
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# the forward MTF's kernels, each launched once a compress block
MTF_FORWARD = ("mtf_recency", "mtf_start_tables", "mtf_encode_lockstep")
# the start-table kernel's tiles, swept (csrc/mtf.cu picks one by shape)
START_TILES = (8, 16, 32, 64)
START_REPLACES = "tpulc/primitives/mtf.py:85-96 (XLA scan and argsort, no " \
                 "pallas_call)"
# the running max / min scans and the anchored inverse-BWT walk (hand
# kernels for XLA stages, no pallas_call), their sources and the tpulc
# stages they replace
SCAN_SRC = "tpulc_torch/csrc/scan.cu"
IBWT_SRC = "tpulc_torch/csrc/ibwt.cu"
STAGE_REPLACES = {
    "running_max": "tpulc/codecs/bwt/rle.py:43,78,103 (jax.lax."
                   "associative_scan, no pallas_call)",
    "running_min": "tpulc/codecs/bwt/rle.py:46, rotsort.py:148, "
                   "bsclike/grc.py:299 (reverse jax.lax.associative_scan, no "
                   "pallas_call)",
    "anchored_walk": "tpulc/codecs/bwt/rotsort.py:375, masked.py:235 (jax."
                     "lax.fori_loop, no pallas_call)",
}
STAGE_KERNELS = tuple(STAGE_REPLACES)
# every call site of those three wrappers on the codec paths: (module,
# name) as the module imported it
STAGE_SITES = (("tpulc_torch.codecs.bwt.rle", "running_max"),
               ("tpulc_torch.codecs.bwt.rle", "running_min"),
               ("tpulc_torch.codecs.bwt.rotsort", "running_min"),
               ("tpulc_torch.codecs.bsclike.grc", "running_max"),
               ("tpulc_torch.codecs.bsclike.grc", "running_min"),
               ("tpulc_torch.codecs.bwt.rotsort", "anchored_walk"),
               ("tpulc_torch.codecs.bwt.masked", "anchored_walk"))
RLE_MOD = "tpulc_torch.codecs.bwt.rle"
# what the path must not run any more: torch's 1-D scans
NO_TORCH_SCANS = ("aten::cummax", "aten::cummin")
# the walk's integer operations a step (the mask of the successor, the
# byte's shift and or into its word)
WALK_OPS = 3
# the walk's lanes a warp (csrc/ibwt.cu picks one from the lanes and the
# SM count), swept
WALK_LANES_PER_WARP = (1, 2, 4, 8, 16, 32)
SOUP_WORDS = [
    b"the", b"of", b"and", b"compression", b"lossless", b"entropy",
    b"transform", b"block", b"sorting", b"data", b"parallel", b"encode",
    b"decode", b"huffman", b"window", b"match", b"stream", b"symbol",
]
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s; float32/int32
# operations/s outside the tensor cores
HBM_BPS = 3.35e12
SCALAR_OPS = 67e12
# integer operations per step, counted from the function each kernel
# computes and not from its design: a Huffman symbol (K3, K7, K8) costs
# its L length compares plus ~10 (window, index, reservoir); a K4 step
# its rank + 2 moves (the entries that shift, the read and the write of
# the symbol); a K2 step its O(rank) find and shift; a K5 event ~50
# (model pick, family, mix, two adaptations, coarse select chain); a K6
# event ~140 (contexts, model pick, mix, rANS step, adaptations, FSM); an
# emission event ~35 (coding interval, renormalisation test, a 32-bit
# divide of ~20, the state update)
HUFF_OPS = 10
# the start tables, per entry of K1's rows: a max of the scan over
# chunks and log2(256) = 8 compares of the sort by recency
START_OPS = 9
K5_OPS = 50
K6_OPS = 140
EMIT_OPS = 35
# a coder-1 rANS step, either way: two table reads, the renormalisation
# test, a 32-bit divide of ~20 (encode) or a multiply (decode), the
# state update and the next context
RANS_OPS = 35
RANS_SRC = "tpulc_torch/csrc/rans_ctx.cu"
# an adaptive-coder event: encode, the model read and adaptation (~10)
# and a rANS step with its 32-bit divide (~35); decode, the FSM's model
# id and transition (~25), the rANS step (~15), the adaptation (~10)
# and the symbol's rebuild (~10)
ABC_ENC_OPS = 45
ABC_DEC_OPS = 60
# the fewest dependent integer operations of a serial coder walk,
# counted from the function (each one ~4 cycles): an adaptive-coder
# rANS step (the renormalisation compare and select, an exact quotient
# as a multiply-high, the remainder, its compare and select) and an
# adaptation (subtract, shift, add, two clips), which waits only on the
# last adaptation of the same model (`abc_encode_chain`); a decode
# step's slot, bit compare, the state's select and multiply-add, the
# renormalisation compare and select; coder 1's encode step as the
# adaptive one's rANS step, its decode step's slot, state multiply-add
# and subtract, renormalisation compare and select (beside two dependent
# table reads)
ABC_RANS_CHAIN = 6
ABC_ADAPT_CHAIN = 5
ABC_DEC_CHAIN = 6
RANS_ENC_CHAIN = 6
RANS_DEC_CHAIN = 5
# the reverse-rANS emission's step, as the adaptive coder's rANS step:
# the renormalisation compare and select, the quotient's multiply-high,
# the remainder, its compare and select
EMIT_CHAIN = 6
CHAIN_CYCLES = 4
# phase 14, the primitive layer at the sizes its users run (PERF.md §4):
# one libbsc default block of bench.py's soup for the suffix arrays; 2^26
# int32 for the scans and sorts; 2^24 list nodes; 2^26 random words; a
# CSR of 2^20 rows x 32 entries; 4,096 tridiagonal systems of 1,024; a
# cuckoo table of 2^22 keys at tpulc's space 1.6; histograms of the
# huffman cell's 100 MB and of 96 rows of 1 MiB
PRIM_SOUP = ST_SOUP_SIZE
PRIM_N = 1 << 26
PRIM_NODES = 1 << 24
PRIM_SEED = 0x5EED
SPMV_ROWS, SPMV_ROW_NNZ = 1 << 20, 32
TRI_SYSTEMS, TRI_N = 4096, 1024
CUCKOO_KEYS = 1 << 22
HIST_ROWS = 96


def outputs_sha256(outs) -> str:
    """sha256 of a tuple of arrays, each as its shape and its values in
    int64, C order: one digest for tpulc's and the port's outputs."""
    import numpy as np

    h = hashlib.sha256()
    for x in outs:
        a = np.ascontiguousarray(np.asarray(x).astype(np.int64))
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def corpus(here: str, size: int = CORPUS_SIZE) -> bytes:
    """pg1661.txt repeated to `size` bytes (bench.py's make_corpus)."""
    with open(os.path.join(here, "tests", "data", "pg1661.txt"), "rb") as f:
        raw = f.read()
    return (raw * (size // len(raw) + 1))[:size]


def soup(size: int) -> bytes:
    """bench.py's make_soup(size), vectorised: the same word draws from
    default_rng(12345), one space after each word, cut to size."""
    import numpy as np

    rng = np.random.default_rng(12345)
    lens = np.array([len(w) + 1 for w in SOUP_WORDS])
    idx = rng.integers(len(SOUP_WORDS), size=size // 3 + 1)
    ln = lens[idx]
    end = np.cumsum(ln)
    n = int(np.searchsorted(end, size)) + 1
    idx, ln, end = idx[:n], ln[:n], end[:n]
    table = np.full((len(SOUP_WORDS), lens.max()), ord(" "), np.uint8)
    for i, w in enumerate(SOUP_WORDS):
        table[i, : len(w)] = np.frombuffer(w, np.uint8)
    out = np.empty(int(end[-1]), np.uint8)
    start = end - ln
    for k in range(lens.max()):
        m = ln > k
        out[start[m] + k] = table[idx[m], k]
    return out[:size].tobytes()


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the scalar rate, whichever is larger."""
    tb, to = nbytes / HBM_BPS, ops / SCALAR_OPS
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations"}


_SM_HZ: list = []


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm) in Hz."""
    if not _SM_HZ:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0]
        _SM_HZ.append(float(mhz) * 1e6)
    return _SM_HZ[0]


def chain_ms(ops: int) -> float:
    """The least time of `ops` dependent integer operations of
    CHAIN_CYCLES each at the maximum SM clock."""
    return ops * CHAIN_CYCLES / sm_clock_hz() * 1e3


def abc_encode_chain(torch, grid, nbits, lanes: int = 4096) -> int:
    """The adaptive encode's longest chain of dependent operations over
    its lanes: event t's probability waits on the k_t earlier events of
    its model (ABC_ADAPT_CHAIN each), and the reverse pass, which runs
    t = nbits[l] - 1 down to 0, takes ABC_RANS_CHAIN a step from step t
    on, so lane l needs max over its events t of ABC_ADAPT_CHAIN k_t +
    ABC_RANS_CHAIN (t + 1) operations.  Counted on the card, `lanes`
    lanes at a time."""
    W, L = grid.shape
    t = torch.arange(W, device=grid.device)
    best = 0
    for a in range(0, L, lanes):
        g = grid[:, a:a + lanes].T.to(torch.int64)          # [c, W]
        n = nbits[a:a + lanes].to(torch.int64)[:, None]
        c = g.shape[0]
        valid = (t[None, :] < n) & (g > 0)
        model = ((g >> 1) - 1).clamp(0, 116)
        lane = torch.arange(c, device=grid.device)[:, None]
        key = ((lane * 128 + model) * W + t)[valid]
        key, _ = torch.sort(key)
        grp = key // W
        first = torch.ones_like(grp, dtype=torch.bool)
        first[1:] = grp[1:] != grp[:-1]
        idx = torch.arange(key.numel(), device=grid.device)
        k = idx - torch.cummax(torch.where(first, idx, 0), 0)[0]
        ops = ABC_ADAPT_CHAIN * k + ABC_RANS_CHAIN * (key % W + 1)
        if ops.numel():
            best = max(best, int(ops.max()))
    return best


def emission_chain(gmb, nsteps: int) -> int:
    """The emission's longest chain of dependent operations: a lane
    codes its events (gmb > 0 in rows < nsteps) one after another, each
    a rANS step of EMIT_CHAIN, so the lane with the most events needs
    that many times EMIT_CHAIN operations."""
    if nsteps <= 0 or gmb.shape[1] == 0:
        return 0
    return EMIT_CHAIN * int((gmb[:nsteps] > 0).sum(dim=0).max())


def nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(nbytes(y) for y in x)
    return x.numel() * x.element_size() if hasattr(x, "numel") else 0


def time_ms(torch, fn, reps: int = 5, warm: bool = True) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 5) -> float:
    """Median time on the device of one fn(): `reps` calls captured into
    a CUDA graph and the graph replayed between two events, so that the
    wrapper's host time, which exceeds a kernel of some tens of
    microseconds and then sets what events around a call read, is out
    of it.  fn() must launch on the current stream and never wait for
    the device."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay) / reps


def max_abs_err(torch, got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max())


def check_kernels(torch, checks: list[dict]) -> list[dict]:
    """Each check (name, src, replaces, kern, plain, args, shape, ops,
    and optionally bytes, library, plain_reps) against its plain version
    on the same card tensors (a plain version of plain_reps 1, a loop of
    seconds, is timed on the one run that the equality reads).  `ms` is the wrapper's call between two
    CUDA events, `device_ms` the kernel alone (see `device_ms`).
    `bytes` defaults to every tensor argument read once plus the
    output written once; `library` is one PyTorch
    call computing the same function, timed beside the kernel; `chain`,
    the dependent operations of the longest lane, prints `chain_ms`
    beside the bound (not in the entry: it is computed, not measured).
    Launches are filled in from the main path's run later."""
    kernels = []
    for c in checks:
        kern, plain, args = c["kern"], c["plain"], c["args"]
        got, reps = kern(*args), c.get("plain_reps", 5)
        want = []
        once_ms = time_ms(torch, lambda: want.append(plain(*args)), 1, False)
        want = want[0]
        err = max_abs_err(torch, got, want)
        moved = c.get("bytes") or nbytes(list(args)) + nbytes(got)
        del got, want
        ms = time_ms(torch, lambda: kern(*args))
        dev_ms = device_ms(torch, lambda: kern(*args))
        # a plain version run once (plain_reps 1) is timed on that run
        plain_ms = once_ms if reps == 1 else time_ms(
            torch, lambda: plain(*args), reps)
        library_ms = None
        if c.get("library") is not None:
            library_ms = time_ms(torch, c["library"])
        b = bound(moved, c["ops"])
        chain = (f" chain {chain_ms(c['chain'])} ms ({c['chain']} dependent "
                 f"ops)" if "chain" in c else "")
        print(f"kernel {c['name']}: shape {c['shape']} max_abs_err {err} "
              f"kernel {ms:.4f} ms (on the device {dev_ms:.4f}) plain "
              f"{plain_ms:.4f} ms library "
              f"{library_ms} ms bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {moved} B, {c['ops']} ops){chain}",
              flush=True)
        require(err == 0, f"{c['name']} disagrees with its plain version")
        kernels.append({"name": c["name"], "route": "cuda",
                        "source": c["src"], "replaces": c["replaces"],
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "device_ms": dev_ms,
                        "plain_ms": plain_ms, **b, "library_ms": library_ms})
    return kernels


def synced(torch, fn):
    """(fn(), host seconds) with the device synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(torch, wrappers: dict, fn):
    """Run fn() with every wrapper's launch count reset just before;
    -> (fn(), host seconds, {name: launches})."""
    for w in wrappers.values():
        w.launches = 0
    out, dt = synced(torch, fn)
    return out, dt, {k: w.launches for k, w in wrappers.items()}


def k4_ops(ranks) -> int:
    """MTF by rank on these ranks: rank + 2 moves a step."""
    return int((ranks.clamp(0, 255).long() + 2).sum())


def ptxas_registers(log: str) -> dict:
    """nvcc -Xptxas=-v output -> {mangled entry name: registers}."""
    regs, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line and entry:
            regs[entry] = int(line.split("Used")[1].split("registers")[0])
    return regs


def resident_warps(regs: int) -> int:
    """Warps of `regs` registers a thread that one SM's 65,536 registers
    hold (allocated 256 a warp at a time), at most 64."""
    return min(64, 65_536 // (-(-regs * 32 // 256) * 256))


def k4_variants(torch, mk, cuda_lib, table0, ranks, want) -> dict:
    """K4 at every lanes-a-chunk build (each output equal
    to `want`, the plain version's), with ms, ns a step and waves; and
    the two calls `mtf_decode` makes (identity start without symbols;
    without the final table), each equal to the plain version of the
    same arguments, with the bound of the bytes that call must move."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs = ptxas_registers(cuda_lib.build_log.get("mtf.cu", ""))
    nchunks, C = ranks.shape
    out = {"shape": f"{nchunks}x{C}", "sms": sms, "builds": {}}
    for lanes in mk.LANES:
        fn = partial(mk.mtf_lockstep, table0, ranks, lanes=lanes)
        got = fn()
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"K4 at {lanes} lanes differs from plain")
        del got
        ms = device_ms(torch, fn)
        row = {"device_ms": ms, "ns_per_step": ms * 1e6 / C}
        r = next((v for k, v in regs.items()
                  if f"mtf_decode_kernelILi{lanes}EE" in k), None)
        if r is not None:
            warps = nchunks * lanes // 32
            row["registers"] = r
            row["waves"] = -(-warps // (sms * resident_warps(r)))
        out["builds"][f"lanes{lanes}"] = row
    calls = {"perm": dict(table0=None, want_syms=False),
             "syms": dict(table0=table0, want_table=False)}
    for tag, kw in calls.items():
        t0 = kw.pop("table0")
        got = mk.mtf_lockstep(t0, ranks, **kw)
        ref = mk.mtf_lockstep_plain(t0, ranks, **kw)
        torch.cuda.synchronize()
        require(all((g is None and w is None) or torch.equal(g, w)
                    for g, w in zip(got, ref)),
                f"K4 call '{tag}' differs from its plain version")
        moved = nbytes([t0, ranks]) + nbytes([g for g in got if g is not None])
        del got, ref
        out[tag] = {"device_ms": device_ms(torch, lambda: mk.mtf_lockstep(
            t0, ranks, **kw)), "bytes": moved, **bound(moved, k4_ops(ranks))}
    return out


def k2_walk(torch, cuda_lib, table0, syms, ms) -> dict:
    """K2's walk at this shape, from its device ms `ms`: the share of
    steps it walks (a symbol that differs from the one before; step 0
    against its table's front), ns a step and a walked step, registers
    and waves."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nchunks, C = syms.shape
    prev = torch.cat([table0[:, :1], syms[:, :-1]], dim=1)
    walked = float((syms != prev).float().mean())
    out = {"shape": f"{nchunks}x{C}", "sms": sms, "walked_share": walked,
           "device_ms": ms, "ns_per_step": ms * 1e6 / C,
           "ns_per_walked_step": ms * 1e6 / max(C * walked, 1e-9)}
    r = next((v for k, v in ptxas_registers(
        cuda_lib.build_log.get("mtf.cu", "")).items()
        if "mtf_encode_walk_kernel" in k), None)
    if r is not None:
        out["registers"] = r
        out["waves"] = -(-nchunks // (sms * resident_warps(r)))
    return out


def start_tiles(torch, mk, cuda_lib, d, want, split: bool = False) -> dict:
    """K1 and the start tables at every tile, on K1's input `d`: K1's
    rows and tile maxima equal to the plain versions', the start tables
    from K1's maxima (the forward MTF's route) and from their own
    maxima (one launch more) each equal to `want`, the plain version's;
    device ms of each (K1 also without the maxima), tiles and K1's
    registers; with `split`, the device ms of each launch (memset
    included) of the default tile's route from K1's maxima
    (`launch_split`)."""
    nchunks, C = d.shape
    rec_want = mk.mtf_recency_plain(d)
    out = {"shape": f"{nchunks}x{C}",
           "auto_tile": cuda_lib.library().tplc_mtf_start_tile(nchunks, 0),
           "k1_registers": next((v for k, v in ptxas_registers(
               cuda_lib.build_log.get("mtf.cu", "")).items()
               if "mtf_recency_kernel" in k), None),
           "builds": {}}
    for tile in START_TILES:
        k1 = partial(mk.mtf_recency, d, partials=True, tile=tile)
        rec, part, t = k1()
        require(t == tile and torch.equal(rec, rec_want)
                and torch.equal(part, mk.mtf_tile_max_plain(rec_want, C,
                                                            tile)),
                f"K1 at tile {tile} differs")
        fused = partial(mk.mtf_start_tables, rec, C, tile=tile, part=part)
        own = partial(mk.mtf_start_tables, rec, C, tile=tile)
        require(torch.equal(fused(), want) and torch.equal(own(), want),
                f"start tables at tile {tile} differ")
        out["builds"][f"tile{tile}"] = {
            "k1_device_ms": device_ms(torch, k1),
            "k1_rows_only_device_ms": device_ms(
                torch, partial(mk.mtf_recency, d, tile=tile)),
            "device_ms": device_ms(torch, fused),
            "own_maxima_device_ms": device_ms(torch, own),
            "tiles": -(-nchunks // tile)}
    if split:
        rec, part, tile = mk.mtf_recency(d, partials=True)
        out["launches_device_ms"] = launch_split(
            torch, lambda: mk.mtf_start_tables(rec, C, tile=tile, part=part),
            counts=True)
    return out


def mtf_pair_checks(mk, d, rec, part, tile: int, suffix: str,
                    library) -> list:
    """check_kernels entries of K1 and the start tables as the forward
    MTF calls them: K1 with its tile maxima at `tile` (against the plain
    rows and `mtf_tile_max_plain`), and the start tables from K1's rows
    `rec` and maxima `part` (against the plain version)."""
    C = d.shape[1]
    shape = "x".join(map(str, d.shape))
    src = "tpulc_torch/csrc/mtf.cu"

    def k1_plain(x):
        r = mk.mtf_recency_plain(x)
        return r, mk.mtf_tile_max_plain(r, C, tile)

    return [
        dict(name="mtf_recency" + suffix, src=src,
             replaces="tpulc/primitives/mtf_pallas.py:215",
             kern=lambda x: mk.mtf_recency(x, partials=True, tile=tile)[:2],
             plain=k1_plain, args=(d,), shape=shape,
             ops=d.numel() + 256 * d.shape[0], library=library),
        dict(name="mtf_start_tables" + suffix, src=src,
             replaces=START_REPLACES,
             kern=partial(mk.mtf_start_tables, tile=tile, part=part),
             plain=mk.mtf_start_tables_plain, args=(rec, C), shape=shape,
             ops=START_OPS * rec.numel()),
    ]


def bz_block_syms(torch, driver, data: bytes, dev):
    """The first 900,000 B block of `data` as the bz compress hands it to
    K1: its anchored BWT, int32[7,032, 128] on the card."""
    from tpulc_torch.codecs.bwt.rotsort import bwt_encode_anchored

    block = torch.zeros(driver._cap_for(BLOCK), dtype=torch.uint8)
    block[:BLOCK] = torch.frombuffer(bytearray(data[:BLOCK]), dtype=torch.uint8)
    last, _, _, _ = bwt_encode_anchored(block.to(dev), driver.ANCHOR_STRIDE)
    return last.to(torch.int32).reshape(-1, 128).contiguous()


def launch_split(torch, fn, reps: int = 20, counts: bool = False):
    """Device ms of one fn() by kernel name: `reps` calls under
    torch.profiler, each kernel's total over reps (with `counts`, [ms,
    launches a call], memsets included); "not measured" if the profiler
    caught no device event (it drops some now and then)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.split("::")[-1].split("(")[0]
            dt = (ev.time_range.end - ev.time_range.start) / 1e3 / reps
            ms, k = split.get(name, (0.0, 0))
            split[name] = (ms + dt, k + 1 / reps)
    if counts:
        return {k: list(v) for k, v in split.items()} or "not measured"
    return {k: v[0] for k, v in split.items()} or "not measured"


def stage_calls(fn, keep: dict | None = None):
    """Run fn() with every call site of STAGE_SITES wrapped -> (fn(),
    {kernel: calls with work (a non-empty scan, a walk of n > 0)},
    {site: [(args, kwargs) of its first calls]}): `keep` maps a site to
    how many of its first calls to keep."""
    import importlib

    calls = dict.fromkeys(STAGE_KERNELS, 0)
    kept = {site: [] for site in keep or {}}
    origs = []
    for site in STAGE_SITES:
        mod = importlib.import_module(site[0])
        orig = getattr(mod, site[1])

        def spy(*args, _orig=orig, _site=site, **kw):
            name = _site[1]
            calls[name] += (args[3] > 0 if name == "anchored_walk"
                            else args[0].numel() > 0)
            if _site in kept and len(kept[_site]) < keep[_site]:
                kept[_site].append((args, kw))
            return _orig(*args, **kw)

        origs.append((mod, site[1], orig))
        setattr(mod, site[1], spy)
    try:
        out = fn()
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)
    return out, calls, kept


def require_stage_launches(label: str, counts: dict, calls: dict,
                           walks: int | None = None) -> None:
    """Each of the scans and the walk launched once a call with work,
    the walk at least once (`walks` times where the blocks say so)."""
    require(all(counts[k] == calls[k] for k in STAGE_KERNELS),
            f"{label}: scan or walk launches {counts} differ from their "
            f"calls {calls}")
    require(calls["anchored_walk"] > 0 and (
        walks is None or calls["anchored_walk"] == walks),
        f"{label}: the anchored walk ran {calls['anchored_walk']} times, "
        f"not {walks if walks is not None else 'at least once'}")


def rle2_arrays(enc: dict, dec: dict) -> list:
    """The four arrays a block's RLE2 scans (`rle2_encode`'s three,
    `rle2_decode`'s one: kept by `stage_calls` as enc and dec) -> [(the
    wrapper's name, x, reverse, the call site)]."""
    arrays = [(k[1], a[0], kw.get("reverse", False), f"rle2_encode[{i}]")
              for k in ((RLE_MOD, "running_max"), (RLE_MOD, "running_min"))
              for i, (a, kw) in enumerate(enc[k])]
    return arrays + [(k[1], a[0], kw.get("reverse", False), "rle2_decode")
                     for k in ((RLE_MOD, "running_max"),)
                     for a, kw in dec[k]]


def stage_checks(torch, cuda_lib, enc: dict, dec: dict, suffix: str):
    """`check_kernels` entries of the scans on the four arrays a block's
    RLE2 scans (`rle2_arrays`) and of the walk on the block's real
    arguments; then the walk at every lanes a warp
    (`walk_at_every_lanes`) and each wrapper's device time and CUDA
    launches a call -> (the entries for the kernels line: the first max
    and min of the encode and the walk; every entry)."""
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik
    from tpulc_torch.primitives import scan_kernels as sk

    plain = {"running_max": sk.running_max_plain,
             "running_min": sk.running_min_plain}
    arrays = rle2_arrays(enc, dec)
    checks = []
    for name, x, rev, site in arrays:
        lib_fn = torch.cummax if name == "running_max" else torch.cummin
        xl = torch.flip(x, (0,)) if rev else x
        checks.append(dict(
            name=name + suffix, src=SCAN_SRC, replaces=STAGE_REPLACES[name],
            kern=partial(getattr(sk, name), reverse=rev),
            plain=partial(plain[name], reverse=rev), args=(x,),
            shape=f"{x.shape[0]} {x.dtype} {'reverse ' if rev else ''}"
                  f"({site})",
            ops=x.shape[0], library=partial(lib_fn, xl, 0)))
    walk = [v for k, v in dec.items() if k[1] == "anchored_walk"][0]
    T, last, anchors, n, S, cap = walk[0][0]
    checks.append(dict(
        name="anchored_walk" + suffix, src=IBWT_SRC,
        replaces=STAGE_REPLACES["anchored_walk"], kern=ik.anchored_walk,
        plain=ik.anchored_walk_plain, args=(T, last, anchors, n, S, cap),
        shape=f"{-(-n // S)} lanes x {S} steps, n {n}, cap {cap}",
        bytes=33 * n, ops=WALK_OPS * n, plain_reps=1))
    entries = check_kernels(torch, checks)
    args = (T, last, anchors, n, S, cap)
    print(json.dumps({
        f"anchored_walk_lanes_per_warp{suffix}": walk_at_every_lanes(
            torch, cuda_lib, args),
        f"launches_a_call{suffix}": {
            "running_max": launch_split(torch, partial(
                sk.running_max, arrays[0][1]), counts=True),
            "running_min_reverse": launch_split(torch, partial(
                sk.running_min, arrays[len(enc[(RLE_MOD, "running_max")])][1],
                True), counts=True),
            "anchored_walk": launch_split(torch, partial(
                ik.anchored_walk, *args), counts=True)}}), flush=True)
    line = [entries[0], entries[len(enc[(RLE_MOD, "running_max")])],
            entries[-1]]
    return line, entries


def walk_at_every_lanes(torch, cuda_lib, args) -> dict:
    """The walk's C entry at every lanes a warp (the memset and the count
    launch, the same at every choice, included), each output equal to
    the wrapper's, with device ms; the kernel's own pick; the wrapper's
    device ms."""
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik

    T, last, anchors, n, S, cap = args
    lanes = -(-n // S)
    lib = cuda_lib.library()
    a = anchors[:lanes].contiguous()
    counts = torch.empty(256, dtype=torch.int32, device=T.device)
    want = ik.anchored_walk(*args)
    out = torch.empty(cap, dtype=torch.uint8, device=T.device)
    res = {"lanes": lanes, "pick": lib.tplc_anchored_walk_lanes(lanes),
           "device_ms": {}}
    for lpw in WALK_LANES_PER_WARP:
        def run(lpw=lpw):
            cuda_lib.check(lib.tplc_anchored_walk(
                T.data_ptr(), last.data_ptr(), counts.data_ptr(),
                a.data_ptr(), a.element_size(), out.data_ptr(), n, S, cap,
                lanes, lpw, cuda_lib.stream_of(T)), "anchored_walk")

        out.fill_(0xAB)
        run()
        torch.cuda.synchronize()
        require(torch.equal(out, want),
                f"the walk at {lpw} lanes a warp differs from the wrapper's")
        res["device_ms"][lpw] = device_ms(torch, run)
    res["wrapper_device_ms"] = device_ms(torch, lambda: ik.anchored_walk(
        *args))
    return res


def k1_library(torch, d):
    """K1's library twin: one scatter_reduce_ "amax" of the step index
    into a -1-filled [nchunks, 256]."""
    d_long = d.long()
    iota = torch.arange(d.shape[1], device=d.device,
                        dtype=torch.int32).expand_as(d).contiguous()

    def run():
        out = torch.full((d.shape[0], 256), -1, dtype=torch.int32,
                         device=d.device)
        return out.scatter_reduce_(1, d_long, iota, "amax",
                                   include_self=True)

    return run


def k3_tiles(torch, dk, cuda_lib, args, packed: bool, want) -> dict:
    """K3 at every tile (each output equal to `want`), with device ms, ns a symbol step, the blocks an SM's shared
    memory and registers hold, and waves."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    L = args[7]
    lt = L if L in (12, 15) else 0
    regs = next((v for k, v in ptxas_registers(
        cuda_lib.build_log.get("huffman_walk.cu", "")).items()
        if f"huffman_walk_kernelILi{lt}ELb{int(packed)}EE" in k), 64)
    B, nsub, C = args[0].shape[0], args[2].shape[0], args[6]
    slab = min(C, 128) // (4 if packed else 1)
    out = {"shape": f"{nsub}x{C}", "packed": packed, "registers": regs,
           "builds": []}
    for tile in dk.WALK_TILES:
        fn = partial(dk.huffman_walk, *args, packed=packed, tile=tile)
        require(torch.equal(fn(), want), f"K3 at tile {tile} differs")
        ms = device_ms(torch, fn)
        # csrc/huffman_walk.cu launch(): stage, base columns, output
        # tile, and the window table where the walk may build one
        lut = packed and L <= 12 and (1 << L) <= 32 * tile
        smem = 4 * tile * (36 + 17 + -(-slab // 4) * 4 + 4) \
            + ((2 << L) if lut else 0)
        resident = min(233_472 // (smem + 1024),
                       resident_warps(regs) * 32 // tile, 32)
        out["builds"].append({
            "tile": tile, "device_ms": ms, "ns_per_step": ms * 1e6 / C,
            "smem_bytes": smem, "blocks_per_sm": resident})
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--e1", action="store_true",
                    help="phase 9 alone (bsc -e1 on both cells)")
    ap.add_argument("--st", action="store_true",
                    help="phase 10 alone (bsc's ST sorters, both coders)")
    ap.add_argument("--lz", action="store_true",
                    help="phases 11 and 12 alone (bzip2, lzss, culzss)")
    ap.add_argument("--dist", action="store_true",
                    help="phase 13 alone (the distribution layer, NCCL "
                         "world size 1)")
    ap.add_argument("--prim", action="store_true",
                    help="phase 14 alone (the primitive layer and the "
                         "golds)")
    ap.add_argument("--huff", action="store_true",
                    help="phases 5 and 6 alone (the huffman walks and the "
                         "100 MB huffman round trip)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.bwt import driver
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik
    from tpulc_torch.codecs.huffman import decode_kernels as dk
    from tpulc_torch.pipeline.container import Container
    from tpulc_torch.primitives import mtf_kernels as mk
    from tpulc_torch.primitives import scan_kernels as sk

    # 1. the card
    print(card())
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{' '.join(cuda_lib.NVCC_FLAGS)})", flush=True)
    for src, log in sorted(cuda_lib.build_log.items()):
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")

    if opts.e1 or opts.st or opts.lz or opts.dist or opts.prim or opts.huff:
        kernels = []
        phases = ([bsc_e1_phase] if opts.e1 else [st_phase] if opts.st
                  else [lz_phase, culzss_phase] if opts.lz
                  else [dist_phase] if opts.dist
                  else [lambda t, h, k: huffman_phases(
                      t, h, t.device("cuda"), k)]
                  if opts.huff else [prim_phase])
        for phase in phases:
            phase(torch, here, kernels)
        print(f"total: {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}))
        return 0

    # 3. kernels vs plain at the main path's shapes
    data = corpus(here)
    cap = driver._cap_for(BLOCK)
    d = bz_block_syms(torch, driver, data, dev)
    rec, part, tile = mk.mtf_recency(d, partials=True)
    table0 = mk.mtf_start_tables(rec, 128, tile=tile, part=part)
    ranks, _ = mk.mtf_encode_lockstep(table0, d)
    # the block's RLE2 scans and its anchored walk, kept for their checks
    one, _, enc = stage_calls(lambda: driver.compress(
        data[:BLOCK], block_size=BLOCK, device="cuda"),
        {(RLE_MOD, "running_max"): 2, (RLE_MOD, "running_min"): 1})
    _, _, dec = stage_calls(lambda: driver.decompress(one, device="cuda"), {
        (RLE_MOD, "running_max"): 1,
        ("tpulc_torch.codecs.bwt.rotsort", "anchored_walk"): 1})
    payload = Container.from_bytes(one).payloads[0]
    _, walk, _, _ = driver.walk_args(payload, cap, dev)
    mtf_shape = "x".join(map(str, d.shape))
    k1_lib = k1_library(torch, d)
    require(torch.equal(k1_lib(), mk.mtf_recency(d)),
            "scatter_reduce_ differs from K1")
    walk_syms = walk[2].shape[0] * walk[6]
    kernels = check_kernels(torch, [
        *mtf_pair_checks(mk, d, rec, part, tile, "", k1_lib),
        dict(name="mtf_encode_lockstep", src="tpulc_torch/csrc/mtf.cu",
             replaces="tpulc/primitives/mtf_pallas.py:156",
             kern=mk.mtf_encode_lockstep, plain=mk.mtf_encode_lockstep_plain,
             args=(table0, d), shape=mtf_shape,
             ops=int((2 * ranks.long() + 2).sum())),
        dict(name="huffman_walk", src="tpulc_torch/csrc/huffman_walk.cu",
             replaces="tpulc/codecs/huffman/pallas_decode.py:362",
             kern=dk.huffman_walk, plain=dk.huffman_walk_plain, args=walk,
             shape=f"{walk[2].shape[0]}x{walk[6]}",
             ops=walk_syms * (walk[7] + HUFF_OPS)),
        dict(name="mtf_lockstep", src="tpulc_torch/csrc/mtf.cu",
             replaces="tpulc/primitives/mtf_pallas.py:89",
             kern=mk.mtf_lockstep, plain=mk.mtf_lockstep_plain,
             args=(table0, ranks), shape=mtf_shape, ops=k4_ops(ranks)),
    ])
    # K2's walk, and every build of K4, the start tables and K3
    k4 = k4_variants(torch, mk, cuda_lib, table0, ranks,
                     mk.mtf_lockstep_plain(table0, ranks))
    kernels[-1]["calls"] = {t: k4[t] for t in ("perm", "syms")}
    print(json.dumps({"bz_shape_builds": {
        "k2": k2_walk(torch, cuda_lib, table0, d, kernels[2]["device_ms"]),
        "start_tables": start_tiles(torch, mk, cuda_lib, d,
                                    mk.mtf_start_tables_plain(rec, 128)),
        "k4": k4, "k3": k3_tiles(torch, dk, cuda_lib, walk, False,
                                 dk.huffman_walk_plain(*walk))}}), flush=True)
    # the scans on the four arrays a bz block's RLE2 scans, the walk on
    # its real last column and anchors
    stage_line, stage_all = stage_checks(torch, cuda_lib, enc, dec, "")
    print(json.dumps({"bwt_stage_kernels_bz": stage_all}), flush=True)
    kernels += stage_line
    del enc, dec, one

    # 4. the main path, counted
    wrappers = {"mtf_recency": mk.mtf_recency,
                "mtf_start_tables": mk.mtf_start_tables,
                "mtf_encode_lockstep": mk.mtf_encode_lockstep,
                "huffman_walk": dk.huffman_walk,
                "mtf_lockstep": mk.mtf_lockstep,
                "running_max": sk.running_max,
                "running_min": sk.running_min,
                "anchored_walk": ik.anchored_walk}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp, calls, _ = stage_calls(lambda: driver.compress(
        data, block_size=BLOCK, device="cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back, dcalls, _ = stage_calls(lambda: driver.decompress(
        comp, device="cuda"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: w.launches for k, w in wrappers.items()}
    calls = {k: calls[k] + dcalls[k] for k in calls}
    for k in kernels:
        k["launches"] = counts[k["name"]]
    ratio = len(data) / len(comp)
    sha = hashlib.sha256(comp).hexdigest()
    print(f"main path (first run): compress {t1 - t0:.3f} s, decompress "
          f"{t2 - t1:.3f} s, launches {counts}", flush=True)
    require(back == data, "round trip is not exact")
    require(round(ratio, 3) == RATIO, f"ratio {ratio} != {RATIO}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the path never launched: {counts}")
    nblocks = len(Container.from_bytes(comp).payloads)
    require(all(counts[k] == nblocks for k in MTF_FORWARD),
            f"K1, the start tables, K2 not once per block: {counts}")
    anchored = sum(driver._parse_block(p)[7] is not None
                   for p in Container.from_bytes(comp).payloads)
    require_stage_launches("bz", counts, calls, anchored)
    print(f"bz: {nblocks} blocks, {anchored} anchored; scan and walk calls "
          f"{calls}", flush=True)

    # the container does not depend on the device (small input)
    small = data[:150_000]
    on_card = driver.compress(small, block_size=1 << 16, device="cuda")
    on_cpu = driver.compress(small, block_size=1 << 16, device="cpu")
    require(on_card == on_cpu, "card and CPU containers differ")
    require(driver.decompress(on_cpu, device="cuda") == small,
            "card fails to decode the CPU container")

    cs, ds = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = driver.compress(data, block_size=BLOCK, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        driver.decompress(c, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        require(c == comp, "compress is not deterministic")
        cs.append(t1 - t0)
        ds.append(t2 - t1)
    c_s, d_s = statistics.median(cs), statistics.median(ds)
    mb = len(data) / 1e6
    print(json.dumps({
        "bz_pg1661x6": {
            "input_bytes": len(data), "container_bytes": len(comp),
            "ratio": ratio, "sha256": sha,
            "sha256_equals_tpulc": sha == TPULC_SHA256,
            "compress_s": c_s, "decompress_s": d_s,
            "compress_MBps": mb / c_s, "decompress_MBps": mb / d_s,
            "roundtrip_MBps": mb / (c_s + d_s),
            "timing": "median of 3 warm runs, host clock, synchronized",
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }}))
    print(json.dumps({"bz_pg1661x6_profile": path_profile(
        torch, lambda: driver.compress(data, block_size=BLOCK, device="cuda"),
        lambda c: driver.decompress(c, device="cuda"),
        forbid=NO_TORCH_SCANS)}), flush=True)
    huffman_phases(torch, here, dev, kernels)
    bsc_phases(torch, here, dev, kernels)
    bsc_e1_phase(torch, here, kernels)
    st_phase(torch, here, kernels)
    lz_phase(torch, here, kernels)
    culzss_phase(torch, here, kernels)
    dist_phase(torch, here, kernels)
    prim_phase(torch, here, kernels)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def huffman_phases(torch, here: str, dev, kernels: list) -> None:
    """Phases 5 and 6; appends K3 packed, K7 and K8 to `kernels`."""
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.huffman import decode as hdec
    from tpulc_torch.codecs.huffman import decode_kernels as dk
    from tpulc_torch.codecs.huffman import driver as hdrv
    from tpulc_torch.pipeline.container import Container

    L = HUFF_MAX_LEN
    big = corpus(here, HUFF_SIZE)
    mb = HUFF_SIZE / 1e6

    # 5. kernels vs plain on the full 100 MB group's real streams
    comp0, cold_c = synced(torch, lambda: hdrv.compress(
        big, block_size=HUFF_BLOCK, device="cuda"))
    payloads = Container.from_bytes(comp0).payloads
    words, tbits, lens, offs, ns, chunk = hdrv._parse_aligned_group(
        payloads, HUFF_BLOCK)
    nblocks = -(-HUFF_SIZE // HUFF_BLOCK)          # 96: one group
    require(len(payloads) == nblocks and chunk == 128
            and offs.shape == (nblocks, HUFF_BLOCK // 128)
            and ns[-1] == HUFF_SIZE - (nblocks - 1) * HUFF_BLOCK,
            f"unexpected group shape {offs.shape}, chunk {chunk}")
    group = hdrv._to_device(words, tbits, lens, offs, dev)
    wargs, _ = hdec.walk_args(*group, chunk, L)
    fargs, _ = hdec.flat_args(*group, chunk, L)
    shape = f"{wargs[2].shape[0]}x{chunk}"
    ops = wargs[2].shape[0] * chunk * (L + HUFF_OPS)
    kernels += check_kernels(torch, [
        dict(name="huffman_walk_packed", src="tpulc_torch/csrc/huffman_walk.cu",
             replaces="tpulc/codecs/huffman/pallas_decode.py:362",
             kern=partial(dk.huffman_walk, packed=True),
             plain=partial(dk.huffman_walk_plain, packed=True), args=wargs,
             shape=shape, ops=ops),
        dict(name="huffman_walk_v1", src="tpulc_torch/csrc/huffman_v1.cu",
             replaces="tpulc/codecs/huffman/pallas_decode.py:143",
             kern=dk.huffman_walk_v1, plain=dk.huffman_walk_v1_plain,
             args=wargs, shape=shape, ops=ops),
        dict(name="huffman_walk_flat", src="tpulc_torch/csrc/huffman_flat.cu",
             replaces="tpulc/codecs/huffman/pallas_decode.py:560",
             kern=dk.huffman_walk_flat, plain=dk.huffman_walk_flat_plain,
             args=fargs, shape=f"{fargs[1].shape[0]}x{chunk}",
             ops=fargs[1].shape[0] * chunk * (L + HUFF_OPS)),
    ])
    tiles = k3_tiles(torch, dk, cuda_lib, wargs, True,
                     dk.huffman_walk_plain(*wargs, packed=True))
    # the global-memory route: the first two streams with their chunks'
    # offsets in random order, so no tile's span fits the stage
    ccap = offs.shape[1]
    perm = torch.cat([b * ccap + torch.randperm(
        ccap, generator=torch.Generator().manual_seed(b)) for b in range(2)])
    hostile = (wargs[0][:2].contiguous(), wargs[1][:2].contiguous(),
               wargs[2][perm.to(dev)].contiguous(), wargs[3], wargs[4],
               wargs[5][: 2 * ccap].contiguous(), chunk, L)
    for packed in (True, False):
        got = dk.huffman_walk(*hostile, packed=packed)
        torch.cuda.synchronize()
        require(torch.equal(got, dk.huffman_walk_plain(*hostile,
                                                       packed=packed)),
                f"K3's global-memory route differs (packed={packed})")
        del got
    tiles["global_route_2_streams_device_ms"] = device_ms(
        torch, lambda: dk.huffman_walk(*hostile, packed=True))
    tiles["staged_route_2_streams_device_ms"] = device_ms(
        torch, lambda: dk.huffman_walk(*hostile[:2], wargs[2][: 2 * ccap],
                                       *hostile[3:], packed=True))
    print(json.dumps({"huffman_shape_builds": {
        "k3": tiles, "edges": walk_edges(torch, dk, wargs, fargs, hostile)}}),
        flush=True)
    del wargs, fargs, hostile

    # 6. the huffman main path, counted; then v1 and flat, each counted
    torch.cuda.reset_peak_memory_stats()
    path = {"huffman_walk": dk.huffman_walk,
            "huffman_walk_v1": dk.huffman_walk_v1,
            "huffman_walk_flat": dk.huffman_walk_flat}
    def round_trip():
        c = hdrv.compress(big, block_size=HUFF_BLOCK, device="cuda")
        return c, hdrv.decompress(c, device="cuda")

    (comp, back), dt, counts = counted(torch, path, round_trip)
    sha = hashlib.sha256(comp).hexdigest()
    print(f"huffman main path: {dt:.3f} s, {len(comp)} B, sha256 {sha}, "
          f"launches {counts}", flush=True)
    require(back == big, "huffman round trip is not exact")
    require(len(comp) == HUFF_BYTES and sha == HUFF_SHA256,
            "huffman container differs from tpulc's")
    require(comp == comp0, "huffman compress is not deterministic")
    require(counts["huffman_walk"] > 0, f"K3 packed never launched: {counts}")
    launches = {"huffman_walk_packed": counts["huffman_walk"]}
    for kern, name in (("v1", "huffman_walk_v1"),
                       ("flat", "huffman_walk_flat")):
        out, _, cnt = counted(torch, path, lambda: hdrv.decompress(
            comp, device="cuda", kernel=kern))
        require(out == big, f"decode with kernel={kern} differs")
        require(cnt[name] > 0, f"{name} never launched: {cnt}")
        launches[name] = cnt[name]
    for k in kernels:
        k["launches"] = launches.get(k["name"], k["launches"])
    x6 = corpus(here)
    require(hashlib.sha256(hdrv.compress(
        x6, block_size=HUFF_BLOCK, device="cuda")).hexdigest()
        == HUFF_X6_SHA256, "pg1661 x 6 container differs from tpulc's")

    cs, ds = [], []
    for _ in range(3):
        c, tc = synced(torch, lambda: hdrv.compress(
            big, block_size=HUFF_BLOCK, device="cuda"))
        _, td = synced(torch, lambda: hdrv.decompress(c, device="cuda"))
        cs.append(tc)
        ds.append(td)
    c_s, d_s = statistics.median(cs), statistics.median(ds)
    decode_s = decode_only_s(torch, hdrv, group, chunk, L)
    decode_gbps = {k: HUFF_SIZE / 1e9 / v for k, v in decode_s.items()}
    split = decode_split(torch, group, chunk, L, decode_s)
    peak = torch.cuda.max_memory_allocated()
    ss_comp = hdrv.compress(x6, block_size=HUFF_BLOCK, aligned=False,
                            device="cuda")
    ss_back, ss_s = synced(torch, lambda: hdrv.decompress(ss_comp,
                                                          device="cuda"))
    require(ss_back == x6, "self-sync round trip is not exact")
    print(json.dumps({"huffman_100MB": {
        "input_bytes": HUFF_SIZE, "block_size": HUFF_BLOCK,
        "container_bytes": len(comp), "ratio": HUFF_SIZE / len(comp),
        "sha256": sha, "sha256_equals_tpulc": sha == HUFF_SHA256,
        "first_compress_s": cold_c,
        "compress_s": c_s, "decompress_s": d_s,
        "compress_MBps": mb / c_s, "decompress_MBps": mb / d_s,
        "roundtrip_MBps": mb / (c_s + d_s),
        "decode_only_GBps": decode_gbps,
        "decode_only_split_ms": split,
        "selfsync_pg1661x6_decompress_s": ss_s,
        "timing": "median of 3 warm runs, host clock, synchronized",
        "peak_mem_bytes": peak,
    }}), flush=True)
    print(json.dumps({"huffman_100MB_profile": path_profile(
        torch,
        lambda: hdrv.compress(big, block_size=HUFF_BLOCK, device="cuda"),
        lambda c: hdrv.decompress(c, device="cuda"))}),
        flush=True)


def decode_only_s(torch, hdrv, group, chunk: int, L: int) -> dict:
    """bench.py:138-155's protocol on the card: each decoder on the
    device-resident parsed group, one warm call, then the median of 3
    (s, host clock, synchronised)."""
    out = {}
    for kern in hdrv.KERNELS:
        def fn():
            return hdrv.decode_batch_device(*group, chunk, L, kernel=kern)

        synced(torch, fn)
        out[kern] = statistics.median(synced(torch, fn)[1] for _ in range(3))
    return out


def decode_split(torch, group, chunk: int, L: int, total_s: dict) -> dict:
    """Where each walk decoder's decode-only time (`total_s`) goes, ms:
    `params` the canonical decode tables; `args` the rest of the kernel's
    arguments (walk_args: a table index a chunk; flat_args: the padding,
    bits_left, the left-justified limits and the per-tile table copies);
    `walk` the wrapper's call and `walk_device` the kernel alone
    (`device_ms`); `clamp` v1's clamp of K7's transposed int32 output;
    `map` `_ranks_to_symbols` (the ranks widened to int64 for a gather);
    `rest` what the total leaves.  Host clock, synchronised, median of 3
    after a warm call, except `walk_device`."""
    from tpulc_torch.codecs.huffman import decode as hdec
    from tpulc_torch.codecs.huffman import decode_kernels as dk
    from tpulc_torch.codecs.huffman.device_tables import (
        canonical_decode_params,
    )

    def ms(fn):
        synced(torch, fn)
        return statistics.median(synced(torch, fn)[1] for _ in range(3)) * 1e3

    words, _, lens, offs = group
    B, ccap = offs.shape
    params = ms(lambda: canonical_decode_params(lens, L))
    wargs, ss = hdec.walk_args(*group, chunk, L)
    fargs, _ = hdec.flat_args(*group, chunk, L)
    out = {"params": params}
    for kern in ("v1", "buffered", "flat"):
        row = {"total": total_s[kern] * 1e3, "params": params}
        if kern == "flat":
            row["args"] = ms(lambda: hdec.flat_args(*group, chunk, L)) - params
            walk = partial(dk.huffman_walk_flat, *fargs)
        else:
            row["args"] = ms(lambda: hdec.walk_args(*group, chunk, L)) - params
            walk = (partial(dk.huffman_walk_v1, *wargs) if kern == "v1"
                    else partial(dk.huffman_walk, *wargs, packed=True))
        row["walk"] = ms(walk)
        row["walk_device"] = device_ms(torch, walk)
        got = walk()
        row["clamp"] = 0.0
        if kern == "v1":
            row["clamp"] = ms(lambda: got.clamp(0, 255))
            ranks = got.clamp(0, 255)
        elif kern == "buffered":
            ranks = got.view(torch.uint8)
        else:
            ranks = got.view(torch.uint8).reshape(B, -1)[:, : ccap * chunk]
        row["map"] = ms(lambda: hdec._ranks_to_symbols(ranks, ss, B))
        del got, ranks
        row["rest"] = row["total"] - params - row["args"] - row["walk"] \
            - row["clamp"] - row["map"]
        out[kern] = row
    return out


def walk_edges(torch, dk, wargs, fargs, hostile) -> dict:
    """K7 and K8 off the path's own inputs at the full shape, each equal
    to its plain version, with device ms: K7 on K3's two streams of
    random-order offsets (the global-memory route) and on the whole group
    with bases of any int32 (indices wrap, unclipped); K8 on the same two
    streams, offsets and bits_left permuted alike, and on the whole group
    with two limits of every tile's table swapped (not nested: the count
    rule is not the first-hit rule) and bits_left of 0, below 0 and past
    C*L on every 5th, 7th and 11th chunk."""
    words, offs, left, lj, base, C, L = fargs
    dev = words.device
    g = torch.Generator().manual_seed(7)
    ccap2 = offs.shape[0] // words.shape[0]   # padded to a table tile
    fperm = torch.cat([b * ccap2 + torch.randperm(ccap2, generator=g)
                       for b in range(2)]).to(dev)
    f_far = (words[:2].contiguous(), offs[fperm].contiguous(),
             left[fperm].contiguous(), lj[: 2 * ccap2 // dk.TILE],
             base[: 2 * ccap2 // dk.TILE], C, L)
    lj_sw = lj.clone()
    lj_sw[:, [4, 6]] = lj[:, [6, 4]]
    left_e = left.clone()
    left_e[::5] = 0
    left_e[::7] = -1000
    left_e[::11] = 2**31 - 1
    f_odd = (words, offs, left_e, lj_sw, base, C, L)
    base_i32 = torch.randint(-2**31, 2**31 - 1, wargs[4].shape, generator=g,
                             dtype=torch.int32).to(dev)
    w_odd = (*wargs[:4], base_i32, *wargs[5:])
    out = {}
    for tag, kern, plain, args in (
            ("k7_global_route_2_streams", dk.huffman_walk_v1,
             dk.huffman_walk_v1_plain, hostile),
            ("k7_int32_bases", dk.huffman_walk_v1, dk.huffman_walk_v1_plain,
             w_odd),
            ("k8_global_route_2_streams", dk.huffman_walk_flat,
             dk.huffman_walk_flat_plain, f_far),
            ("k8_nonnested_bits_left", dk.huffman_walk_flat,
             dk.huffman_walk_flat_plain, f_odd)):
        got = kern(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, plain(*args)), f"{tag} differs from plain")
        del got
        out[f"{tag}_device_ms"] = device_ms(torch, lambda: kern(*args))
    return out


def block_ranks(torch, bsc, data: bytes, block: int, dev):
    """The MTF ranks of the first block of `data` as the bsc -e2 path
    makes them (filter, LZP, masked BWT + MTF) -> (ranks int32[cap] on
    the card, the stage's length)."""
    import numpy as np

    from tpulc_torch.codecs.bsclike.filters import apply_filter_np
    from tpulc_torch.codecs.bwt.masked import forward_ranks_anchored
    from tpulc_torch.gold.lzp import lzp_encode

    blk = np.frombuffer(data[:block], np.uint8)
    fb = bsc._filter_byte_for(blk, "auto")
    if fb:
        blk = apply_filter_np(blk, fb)
    stage = np.frombuffer(lzp_encode(blk) or blk.tobytes(), np.uint8)
    padded = np.zeros(bsc._tcap_for(stage.shape[0], bsc._cap_for(block)),
                      np.uint8)
    padded[: stage.shape[0]] = stage
    ranks, _, _, _ = forward_ranks_anchored(
        torch.from_numpy(padded).to(dev), stage.shape[0], bsc.ANCHOR_STRIDE)
    return ranks, stage.shape[0]


def grc_grid(torch, bsc, data: bytes, block: int, dev):
    """K5's inputs as the bsc -e2 path builds them for the first block
    of `data` (`block_ranks`, lane pre-pass, event grid, wired inits) ->
    (gmb, init, cinit, nsteps, lane_bits, ranks), ranks being the
    block's MTF ranks int32[cap]."""
    from tpulc_torch.codecs.bsclike import grc

    ranks, n = block_ranks(torch, bsc, data, block, dev)
    lane_bits, _ = grc.grc_lane_bits(ranks, n)
    nsteps = int(lane_bits.max())
    gmb, _ = grc._binarize(ranks, n, grc.bucket_bits(nsteps))
    init, cinit, _ = grc._stats_quant(gmb)
    return (gmb, init.contiguous(), cinit.contiguous(), nsteps, lane_bits,
            ranks)


def bsc_phases(torch, here: str, dev, kernels: list) -> None:
    """Phases 7 and 8; appends K5 and K6 (soup shape) to `kernels`."""
    from tpulc_torch.codecs.bsclike import driver as bsc
    from tpulc_torch.codecs.bsclike import grc
    from tpulc_torch.codecs.bsclike import grc_kernels as gk
    from tpulc_torch.pipeline.container import Container
    from tpulc_torch.primitives import mtf_kernels as mk

    pg6 = corpus(here)
    big = soup(SOUP_SIZE)
    require(hashlib.sha256(big).hexdigest() == SOUP_SHA256,
            "the word soup differs from bench.py's make_soup")

    # 7. K5, the emission and K6 against their plain versions on both
    # shapes' grids
    for label, data, block in (("pg1661x6_4MiB", pg6, BSC_BLOCK),
                               ("soup_25MiB", big, SOUP_BLOCK)):
        gmb, init, cinit, nsteps, lane_bits, ranks = grc_grid(
            torch, bsc, data, block, dev)
        if label == "soup_25MiB":
            mtf_entries = mtf_soup_entries(torch, ranks)
        del ranks
        W, L = gmb.shape
        events = int(lane_bits.sum())
        probs = gk.grc_walk_probs(gmb, init, cinit, nsteps)
        payload = Container.from_bytes(bsc.compress(
            data[:block], block_size=block, coder=2, device="cuda")
        ).payloads[0]
        require(payload[bsc._HEAD.size - 1] == bsc.CODER_GRC,
                f"{label}: block 0 is not a group-rank payload")
        nwords = int.from_bytes(payload[16:20], "little")
        _, k6 = bsc.grc_block_args(payload, block, dev)
        lanes = k6[0].shape[0]
        entries = check_kernels(torch, [
            dict(name="grc_walk_probs", src="tpulc_torch/csrc/grc_walk.cu",
                 replaces="tpulc/codecs/bsclike/grc_pallas.py:171",
                 kern=gk.grc_walk_probs, plain=gk.grc_walk_probs_plain,
                 args=(gmb, init, cinit, nsteps), shape=f"{W}x{L}",
                 bytes=4 * (nsteps * L + W * L + grc.NM + grc.NFAM),
                 ops=K5_OPS * events, plain_reps=1),
            dict(name="grc_reverse_rans", src="tpulc_torch/csrc/grc_rans.cu",
                 replaces="tpulc/codecs/bsclike/grc.py:754 (XLA loop, no "
                          "pallas_call)",
                 kern=gk.grc_reverse_rans, plain=gk.grc_reverse_rans_plain,
                 args=(gmb, probs, nsteps), shape=f"{W}x{L}",
                 bytes=8 * nsteps * L + 4 * L * (W + 2) + 16 * L,
                 ops=EMIT_OPS * events, chain=emission_chain(gmb, nsteps),
                 plain_reps=1),
            dict(name="grc_decode_walk", src="tpulc_torch/csrc/grc_decode.cu",
                 replaces="tpulc/codecs/bsclike/grc_pallas.py:438",
                 kern=gk.grc_decode_walk, plain=gk.grc_decode_walk_plain,
                 args=k6, shape=f"{lanes}x{k6[0].shape[1]}",
                 bytes=2 * nwords + 4 * (lanes + grc.NM + grc.NFAM)
                 + 4 * lanes * grc.GCHUNK,
                 ops=K6_OPS * events, plain_reps=1),
        ])
        # K5 and K6 at the other lanes a block the wrappers take
        for nl in (32, 64):
            require(torch.equal(gk.grc_walk_probs(gmb, init, cinit, nsteps,
                                                  lanes=nl), probs)
                    and torch.equal(gk.grc_decode_walk(*k6, lanes=nl),
                                    gk.grc_decode_walk(*k6)),
                    f"{label}: K5 or K6 at {nl} lanes differs")
        for e in entries:
            e["ns_per_step"] = e["ms"] * 1e6 / max(nsteps, 1)
        print(json.dumps({f"grc_kernels_{label}": {
            "lanes": L, "grid_width": W, "nsteps": nsteps,
            "events": events, "words": nwords,
            "entries": entries}}), flush=True)
        del gmb, probs, k6
    kernels += entries   # the full-width (soup) shape
    kernels += mtf_entries

    # 8. the bsc -e2 main path, counted
    path = {"mtf_recency": mk.mtf_recency,
            "mtf_start_tables": mk.mtf_start_tables,
            "mtf_encode_lockstep": mk.mtf_encode_lockstep,
            "mtf_lockstep": mk.mtf_lockstep,
            "grc_walk_probs": gk.grc_walk_probs,
            "grc_reverse_rans": gk.grc_reverse_rans,
            "grc_decode_walk": gk.grc_decode_walk,
            **stage_wrappers()}
    grc_path = ("grc_walk_probs", "grc_reverse_rans", "grc_decode_walk")

    def round_trip(data, block):
        c = bsc.compress(data, block_size=block, coder=2, device="cuda")
        return c, bsc.decompress(c, device="cuda")

    def warm(data, block, reps):
        return warm_runs(torch, lambda: bsc.compress(
            data, block_size=block, coder=2, device="cuda"),
            lambda c: bsc.decompress(c, device="cuda"), data, reps)

    ((comp, back), dt, counts), calls, _ = stage_calls(
        lambda: counted(torch, path, lambda: round_trip(pg6, BSC_BLOCK)))
    sha = hashlib.sha256(comp).hexdigest()
    ratio = len(pg6) / len(comp)
    print(f"bsc -e2 pg1661 x 6: {dt:.3f} s, {len(comp)} B, sha256 {sha}, "
          f"launches {counts}", flush=True)
    require(back == pg6, "bsc round trip is not exact")
    require(round(ratio, 3) == BSC_RATIO, f"bsc ratio {ratio} != {BSC_RATIO}")
    require(sha == BSC_SHA256, "bsc container differs from tpulc's")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the bsc path never launched: {counts}")
    nblocks = len(Container.from_bytes(comp).payloads)
    require(all(counts[k] == nblocks for k in (*grc_path, *MTF_FORWARD)),
            f"K1/start tables/K2/K5/emission/K6 not once per block: {counts}")
    require_stage_launches("bsc -e2 pg1661 x 6", counts, calls)
    small = pg6[:50_000]
    on_card = bsc.compress(small, block_size=1 << 16, coder=2, device="cuda")
    on_cpu = bsc.compress(small, block_size=1 << 16, coder=2, device="cpu")
    require(on_card == on_cpu, "bsc card and CPU containers differ")
    require(bsc.decompress(on_cpu, device="cuda") == small,
            "card fails to decode the CPU bsc container")
    print(json.dumps({"bsc_e2_pg1661x6": {
        "input_bytes": len(pg6), "block_size": BSC_BLOCK,
        "container_bytes": len(comp), "ratio": ratio, "sha256": sha,
        "sha256_equals_tpulc": sha == BSC_SHA256, "launches": counts,
        "first_roundtrip_s": dt, **warm(pg6, BSC_BLOCK, 3)}}), flush=True)

    torch.cuda.reset_peak_memory_stats()
    ((comp, back), dt, counts), calls, _ = stage_calls(
        lambda: counted(torch, path, lambda: round_trip(big, SOUP_BLOCK)))
    peak = torch.cuda.max_memory_allocated()
    nblocks = len(Container.from_bytes(comp).payloads)
    require_stage_launches("bsc -e2 soup", counts, calls, nblocks)
    print(f"bsc -e2 soup 100 MB: {dt:.3f} s, {len(comp)} B, {nblocks} "
          f"blocks, launches {counts}", flush=True)
    require(back == big, "bsc soup round trip is not exact")
    require(nblocks == 4, f"soup gave {nblocks} blocks, not 4")
    require(all(counts[k] == nblocks for k in grc_path),
            f"K5/emission/K6 not launched once per block: {counts}")
    require(all(counts[k] == n * nblocks for k, n in (
        *((k, 1) for k in MTF_FORWARD), ("mtf_lockstep", 2))),
        f"K1, the start tables, K2 not once and K4 not twice per block: "
        f"{counts}")
    for k in kernels:
        if k["name"] in grc_path:
            k["launches"] = counts[k["name"]]
        elif k["name"].endswith("@soup"):
            k["launches"] = counts[k["name"][: -len("@soup")]]
    reps = 3 if dt < 60 else 1
    print(json.dumps({"bsc_e2_soup100MB": {
        "input_bytes": SOUP_SIZE, "block_size": SOUP_BLOCK,
        "blocks": nblocks, "container_bytes": len(comp),
        "ratio": SOUP_SIZE / len(comp), "launches": counts,
        "first_roundtrip_s": dt, "peak_mem_bytes": peak,
        **warm(big, SOUP_BLOCK, reps)}}), flush=True)
    print(json.dumps({"bsc_e2_soup100MB_trace": {
        "compress": traced(torch, lambda: bsc.compress(
            big, block_size=SOUP_BLOCK, coder=2, device="cuda"),
            forbid=NO_TORCH_SCANS),
        "decompress": traced(torch, lambda: bsc.decompress(
            comp, device="cuda"), forbid=NO_TORCH_SCANS)}}), flush=True)


def warm_runs(torch, compress, decompress, data: bytes, reps: int) -> dict:
    """MB/s of `reps` warm round trips, each exact (median, host clock,
    synchronised), and the codec's stage timers over the first."""
    from tpulc_torch.utils import timing

    cs, ds, stages = [], [], None
    for i in range(reps):
        timer = timing.enable() if i == 0 else None
        c, tc = synced(torch, compress)
        back, td = synced(torch, lambda: decompress(c))
        if timer is not None:
            stages = timer.report()
            timing.disable()
        require(back == data, "warm round trip is not exact")
        cs.append(tc)
        ds.append(td)
    c_s, d_s = statistics.median(cs), statistics.median(ds)
    mb = len(data) / 1e6
    return {"compress_s": c_s, "decompress_s": d_s,
            "compress_MBps": mb / c_s, "decompress_MBps": mb / d_s,
            "roundtrip_MBps": mb / (c_s + d_s),
            "timing": f"median of {reps} warm runs, host clock, "
                      "synchronized",
            "stages_first_warm_run": stages}


def captured(module, name: str, fn) -> tuple:
    """The positional arguments of the last call of module.name while
    fn() runs.  A wrapper counts its launches on the module's name, so
    the spy carries the count while it stands there."""
    orig, calls = getattr(module, name), []

    def spy(*args):
        calls.append(args)
        return orig(*args)

    spy.launches = orig.launches
    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, orig)
        orig.launches = spy.launches
    return calls[-1]


def rans_checks(rans, enc: tuple, dec: tuple, suffix: str) -> list:
    """`check_kernels` entries of the coder-1 walks on the arguments the
    path gave them.  Bytes, as the kernels read and write them: encode,
    the valid steps' idx entries, the lane vector, the packed table and
    the reciprocals read once, every entry of `words` and the counts and
    states written once; decode, the words the lanes take, the lane
    vectors and the packed table read once (the slot table is not
    read), the symbols written once.  Operations RANS_OPS a valid
    step."""
    idx, nsym, fc, nlanes = enc
    C, L = idx.shape
    steps = int(nsym.sum())
    nwords = int(rans.rans_encode_walk(*enc)[1].sum())
    Ld = dec[0].shape[0]
    return [
        dict(name=f"rans_encode_walk{suffix}", src=RANS_SRC,
             replaces="tpulc/codecs/bsclike/rans.py:388-412 (XLA fori_loop, "
                      "no pallas_call)",
             kern=rans.rans_encode_walk,
             plain=lambda i, n, f, _: rans.rans_encode_walk_plain(i, n, f),
             args=enc, shape=f"{C}x{L}",
             bytes=4 * steps + 4 * L + 4 * fc.numel()
             + 4 * (rans.PROB_SCALE + 1) + 2 * L * (C + 2) + 16 * L,
             ops=RANS_OPS * steps, plain_reps=1,
             chain=int(nsym.max()) * RANS_ENC_CHAIN),
        dict(name=f"rans_decode_walk{suffix}", src=RANS_SRC,
             replaces="tpulc/codecs/bsclike/rans.py:458-480 (XLA fori_loop, "
                      "no pallas_call)",
             kern=rans.rans_decode_walk, plain=rans.rans_decode_walk_plain,
             args=dec, shape=f"{Ld}x{dec[7]}",
             bytes=2 * nwords + 20 * Ld + 4 * dec[5].numel()
             + 4 * Ld * dec[7],
             ops=RANS_OPS * int(dec[3].sum()), plain_reps=1,
             chain=int(dec[3].max()) * RANS_DEC_CHAIN),
    ]


def bsc_e1_phase(torch, here: str, kernels: list) -> None:
    """Phase 9: bsc -e1, tpulc's default coder, through
    get_codec("bsc") with tpulc's defaults, counted as in phase 4, on
    pg1661 x 6 at 4 MiB and on 100 MB of word soup at 25 MiB; first the
    coder-1 walks against their plain versions on the arguments each
    cell's path gives them.  Appends the walks at both shapes to
    `kernels`."""
    from tpulc_torch import cuda_lib
    from tpulc_torch.codecs.bsclike import rans
    from tpulc_torch.pipeline.container import Container
    from tpulc_torch.pipeline.registry import get_codec
    from tpulc_torch.primitives import mtf_kernels as mk

    bsc = get_codec("bsc")
    walks = ("rans_encode_walk", "rans_decode_walk")
    path = {k: getattr(mk, k) for k in (*MTF_FORWARD, "mtf_lockstep")}
    path.update((k, getattr(rans, k)) for k in walks)
    path.update(stage_wrappers())
    cells = (("bsc_e1_pg1661x6", corpus(here), BSC_BLOCK, BSC_E1_BYTES,
              BSC_E1_RATIO, BSC_E1_SHA256, ""),
             ("bsc_e1_soup100MB", soup(SOUP_SIZE), SOUP_BLOCK, SOUP_E1_BYTES,
              SOUP_E1_RATIO, SOUP_E1_SHA256, "@soup"))
    for label, data, block, size, want_ratio, want_sha, suffix in cells:
        compress = partial(bsc.compress, data, block_size=block,
                           device="cuda")

        def decompress(c):
            return bsc.decompress(c, device="cuda")

        def round_trip():
            c = compress()
            return c, decompress(c)

        # the soup's first block: its RLE2 scans and its anchored walk
        keep_enc = keep_dec = None
        if suffix:
            keep_enc = {(RLE_MOD, "running_max"): 2,
                        (RLE_MOD, "running_min"): 1}
            keep_dec = {(RLE_MOD, "running_max"): 1,
                        ("tpulc_torch.codecs.bwt.masked", "anchored_walk"): 1}
        comp = []
        enc, _, s_enc = stage_calls(lambda: captured(
            rans, "rans_encode_walk", lambda: comp.append(compress())),
            keep_enc)
        dec, _, s_dec = stage_calls(lambda: captured(
            rans, "rans_decode_walk", lambda: decompress(comp[0])), keep_dec)
        entries = check_kernels(torch, rans_checks(rans, enc, dec, suffix))
        if suffix:
            stage_line, stage_all = stage_checks(torch, cuda_lib, s_enc,
                                                 s_dec, suffix)
            print(json.dumps({f"bwt_stage_kernels_{label}": stage_all}),
                  flush=True)
            entries += stage_line
        del s_enc, s_dec, enc, dec, comp
        torch.cuda.reset_peak_memory_stats()
        ((comp, back), dt, counts), calls, _ = stage_calls(
            lambda: counted(torch, path, round_trip))
        peak = torch.cuda.max_memory_allocated()
        sha = hashlib.sha256(comp).hexdigest()
        ratio = len(data) / len(comp)
        nblocks = len(Container.from_bytes(comp).payloads)
        require_stage_launches(label, counts, calls,
                               nblocks if suffix else None)
        print(f"{label}: {dt:.3f} s, {len(comp)} B, {nblocks} blocks, "
              f"sha256 {sha}, launches {counts}", flush=True)
        require(back == data, f"{label}: round trip is not exact")
        require(len(comp) == size, f"{label}: {len(comp)} B != {size}")
        require(round(ratio, 3) == want_ratio,
                f"{label}: ratio {ratio} != {want_ratio}")
        require(sha == want_sha, f"{label}: container differs from tpulc's")
        require(all(counts[k] == nblocks for k in MTF_FORWARD)
                and counts["mtf_lockstep"] == 2 * nblocks,
                f"{label}: K1, the start tables, K2 not once and K4 not "
                f"twice per block: {counts}")
        require(all(counts[k] == 1 for k in walks),
                f"{label}: the coder-1 walks not once a call: {counts}")
        for e in entries:
            e["launches"] = counts[e["name"][: len(e["name"]) - len(suffix)]]
        kernels += entries
        res = {"walks": entries,
               "input_bytes": len(data), "block_size": block,
               "blocks": nblocks, "container_bytes": len(comp),
               "ratio": ratio, "sha256": sha,
               "sha256_equals_tpulc": sha == want_sha, "launches": counts,
               "first_roundtrip_s": dt, "peak_mem_bytes": peak,
               **warm_runs(torch, compress, decompress, data,
                           3 if dt < 60 else 1)}
        if label == "bsc_e1_pg1661x6":
            small = data[:50_000]
            on_card = bsc.compress(small, block_size=1 << 16, device="cuda")
            on_cpu = bsc.compress(small, block_size=1 << 16, device="cpu")
            require(on_card == on_cpu, "bsc -e1 card and CPU containers differ")
            require(bsc.decompress(on_cpu, device="cuda") == small,
                    "card fails to decode the CPU bsc -e1 container")
        else:
            res["trace"] = {"compress": traced(torch, compress,
                                               forbid=NO_TORCH_SCANS),
                            "decompress": traced(torch,
                                                 lambda: decompress(comp),
                                                 forbid=NO_TORCH_SCANS)}
        print(json.dumps({label: res}), flush=True)


def spying(targets: list, fn):
    """Run fn() with each (module, name) of `targets` wrapped to record
    the positional arguments of its last call -> (fn(), {name: args}).
    For wrappers that count their launches on another module's function
    object (the call site imported them), so the counts are untouched."""
    calls, origs = {}, [(m, n, getattr(m, n)) for m, n in targets]

    def spy_of(name, orig):
        def spy(*args):
            calls[name] = args
            return orig(*args)
        return spy

    for m, n, f in origs:
        setattr(m, n, spy_of(n, f))
    try:
        out = fn()
    finally:
        for m, n, f in origs:
            setattr(m, n, f)
    return out, calls


def abc_checks(torch, ak, enc: tuple, dec: tuple, suffix: str) -> list:
    """`check_kernels` entries of the adaptive coder's walks on the
    arguments the path gave them.  Bytes: the events read (one byte
    each, the grid's filled entries), the lane vectors and inits, the
    words written and the counts and states (encode); the words read,
    the lane vectors, the symbols written (decode).  Operations
    ABC_ENC_OPS / ABC_DEC_OPS an event; the chain, `abc_encode_chain`
    (encode) or the deepest lane's steps of ABC_DEC_CHAIN (decode)."""
    grid, nbits, inits, lcap = enc
    W, L = grid.shape
    events = int(nbits.sum())
    nwords = int(ak.abc_encode_walk(*enc)[1].sum())
    words, chunk = dec[0], dec[7]
    Ld = words.shape[0]
    return [
        dict(name=f"abc_encode_walk{suffix}", src=ABC_SRC,
             replaces="tpulc/codecs/bsclike/rans_adaptive.py:228-311 (XLA "
                      "fori_loops, no pallas_call)",
             kern=ak.abc_encode_walk, plain=ak.abc_encode_walk_plain,
             args=enc, shape=f"{W}x{L}",
             bytes=events + 4 * L + 4 * inits.numel() + 2 * nwords + 16 * L,
             ops=ABC_ENC_OPS * events, plain_reps=1,
             chain=abc_encode_chain(torch, grid, nbits)),
        dict(name=f"abc_decode_walk{suffix}", src=ABC_SRC,
             replaces="tpulc/codecs/bsclike/rans_adaptive.py:314-445 (XLA "
                      "fori_loop, no pallas_call)",
             kern=ak.abc_decode_walk, plain=ak.abc_decode_walk_plain,
             args=dec, shape=f"{Ld}x{words.shape[1]}",
             bytes=2 * nwords + 16 * Ld + 4 * inits.numel()
             + 4 * Ld * chunk, ops=ABC_DEC_OPS * events, plain_reps=1,
             chain=dec[6] * ABC_DEC_CHAIN),
    ]


def st_phase(torch, here: str, kernels: list) -> None:
    """Phase 10: bsc on the ST sorters through get_codec("bsc"), counted
    as in phase 4, on the five cells of ST_CELLS: each container's size,
    ratio and sha256 equal to tpulc's, an exact round trip, K1, the
    start tables and K2 once a compress block, K4 twice a decompress
    block, each coder walk once a call, the host walk once a hybrid
    block.  The adaptive coder's walks are held against their plain
    versions on the arguments each `-e2` cell's run gave them, and K1,
    the start tables, K2 and K4 at st8w's soup shape (409,600 chunks).
    The hybrid soup cell decodes once, under the profiler (its host
    walk takes a minute); the others run warm repeats.  Appends every
    entry to `kernels`."""
    from tpulc_torch.codecs.bsclike import abc_kernels as ak
    from tpulc_torch.codecs.bsclike import rans
    from tpulc_torch.codecs.bsclike import rans_adaptive as ra
    from tpulc_torch.gold import st_inverse as sti
    from tpulc_torch.pipeline.container import Container
    from tpulc_torch.pipeline.registry import get_codec
    from tpulc_torch.primitives import mtf as mtf_mod
    from tpulc_torch.primitives import mtf_kernels as mk
    from tpulc_torch.utils import timing

    bsc = get_codec("bsc")
    inputs = {"pg": corpus(here), "soup": soup(ST_SOUP_SIZE)}
    require(hashlib.sha256(inputs["soup"]).hexdigest() == ST_SOUP_SHA256,
            "the 25 MiB soup differs from bench.py's make_soup")
    small = inputs["pg"][:50_000]
    on_card = bsc.compress(small, block_size=1 << 16, sorter="st8", coder=2,
                           device="cuda")
    require(on_card == bsc.compress(small, block_size=1 << 16, sorter="st8",
                                    coder=2, device="cpu"),
            "bsc -m st8 -e2 card and CPU containers differ")
    require(bsc.decompress(on_card, device="cpu") == small,
            "the CPU fails to decode the card's st8 -e2 container")
    for (label, src, block, sorter, coder, size, want_ratio,
         want_sha) in ST_CELLS:
        data = inputs[src]
        walks = ((ak.abc_encode_walk, ak.abc_decode_walk) if coder == 2
                 else (rans.rans_encode_walk, rans.rans_decode_walk))
        path = {k: getattr(mk, k) for k in (*MTF_FORWARD, "mtf_lockstep")}
        path.update((w.__name__, w) for w in walks)
        path["st_inverse"] = sti.st_inverse
        hybrid = sorter != "st8w"
        one_decode = src == "soup" and hybrid
        compress = partial(bsc.compress, data, block_size=block,
                           sorter=sorter, coder=coder, device="cuda")

        def decompress(c):
            return bsc.decompress(c, device="cuda")

        res = {}

        def round_trip():
            c, tc = synced(torch, compress)
            if one_decode:
                keep = []
                res["trace_decompress"] = traced(
                    torch, lambda: decompress(c), keep)
                return c, keep[0], tc, res["trace_decompress"]["wall_s"]
            back, td = synced(torch, lambda: decompress(c))
            return c, back, tc, td

        timer = timing.enable()
        torch.cuda.reset_peak_memory_stats()
        ((comp, back, tc, td), dt, counts), calls = spying(
            [(ra, "abc_encode_walk"), (ra, "abc_decode_walk"),
             (mtf_mod, "mtf_encode_lockstep")],
            lambda: counted(torch, path, round_trip))
        stages = timer.report()
        timing.disable()
        peak = torch.cuda.max_memory_allocated()
        sha = hashlib.sha256(comp).hexdigest()
        ratio = len(data) / len(comp)
        nblocks = len(Container.from_bytes(comp).payloads)
        print(f"{label}: compress {tc:.3f} s, decompress {td:.3f} s, "
              f"{len(comp)} B, {nblocks} blocks, sha256 {sha}, launches "
              f"{counts}", flush=True)
        require(back == data, f"{label}: round trip is not exact")
        require(len(comp) == size, f"{label}: {len(comp)} B != {size}")
        require(round(ratio, 3) == want_ratio,
                f"{label}: ratio {ratio} != {want_ratio}")
        require(sha == want_sha, f"{label}: container differs from tpulc's")
        require(all(counts[k] == nblocks for k in MTF_FORWARD)
                and counts["mtf_lockstep"] == 2 * nblocks,
                f"{label}: K1, the start tables, K2 not once and K4 not "
                f"twice per block: {counts}")
        require(all(counts[w.__name__] == 1 for w in walks),
                f"{label}: the coder's walks not once a call: {counts}")
        require(counts["st_inverse"] == (nblocks if hybrid else 0),
                f"{label}: the host walk not once a hybrid block: {counts}")
        walk_s = stages.get("bsc.unsort.walk", {}).get("seconds", 0.0)
        res.update({
            "input_bytes": len(data), "block_size": block,
            "sorter": sorter, "coder": coder, "blocks": nblocks,
            "container_bytes": len(comp), "ratio": ratio, "sha256": sha,
            "sha256_equals_tpulc": sha == want_sha, "launches": counts,
            "first_compress_s": tc, "first_decompress_s": td,
            "stages_first_run": stages,
            "host_walk_s_a_block": walk_s / nblocks if hybrid else None,
            "peak_mem_bytes": peak})
        entries = []
        if coder == 2:
            entries = check_kernels(torch, abc_checks(
                torch, ak, calls["abc_encode_walk"], calls["abc_decode_walk"],
                "@" + label))
        if label == "soup25_st8w_e2":
            table0, d = calls["mtf_encode_lockstep"]
            ranks = mk.mtf_encode_lockstep(table0, d)[0].reshape(-1)
            del table0, d
            entries += mtf_soup_entries(torch, ranks, "@st8w", builds=False)
            del ranks
        for e in entries:
            e["launches"] = counts[e["name"].split("@")[0]]
        kernels += entries
        res["kernels"] = entries
        del calls
        if one_decode:
            cs = [synced(torch, compress) for _ in range(3)]
            require(all(c == comp for c, _ in cs),
                    f"{label}: compress is not deterministic")
            c_s = statistics.median(t for _, t in cs)
            mb = len(data) / 1e6
            res.update({"compress_s": c_s, "decompress_s": td,
                        "compress_MBps": mb / c_s, "decompress_MBps": mb / td,
                        "roundtrip_MBps": mb / (c_s + td),
                        "timing": "compress: median of 3 warm runs; "
                                  "decompress: the one counted run, under "
                                  "the profiler; host clock, synchronized"})
        else:
            res.update(warm_runs(torch, compress, decompress, data,
                                 3 if dt < 60 else 1))
        if src == "soup":
            res["trace_compress"] = traced(torch, compress)
            if not one_decode:
                res["trace_decompress"] = traced(
                    torch, lambda: decompress(comp))
        print(json.dumps({label: res}), flush=True)


def lz_phase(torch, here: str, kernels: list) -> None:
    """Phase 11: bzip2 at level 9 and lzss at 1 MiB blocks on pg1661 x 6
    through get_codec, each counted as in phase 4.  bzip2: the bytes of
    Python's `bz2.compress` (ratio 4.395), K1, the start tables and K2
    once a block, an exact round trip through the port and through
    `bz2.decompress`, and K1, the start tables and K2 held against their
    plain versions on the arguments the path gave them (appended to
    `kernels`).  lzss: tpulc's container (size, ratio 1.916, sha256), an
    exact round trip, the card's container equal to the CPU path's on
    150 KB, and the decode's host-synced steps.  For both: stage times,
    MB/s from warm repeats, peak device memory and a trace of each
    direction (bzip2's decompress runs on the host: no device time)."""
    import bz2

    import numpy as np

    from tpulc_torch.codecs.bwt.bz2stream import rle1_split_blocks
    from tpulc_torch.codecs.lzss import decode as lzd
    from tpulc_torch.pipeline.container import Container
    from tpulc_torch.pipeline.registry import get_codec
    from tpulc_torch.primitives import mtf as mtf_mod
    from tpulc_torch.primitives import mtf_kernels as mk
    from tpulc_torch.utils import timing

    data = corpus(here)

    # bzip2
    bzip2 = get_codec("bzip2")
    want, stdlib_s = synced(torch, lambda: bz2.compress(data, BZIP2_LEVEL))
    want_sha = hashlib.sha256(want).hexdigest()
    nblocks = len(rle1_split_blocks(np.frombuffer(data, np.uint8),
                                    BZIP2_LEVEL))
    compress = partial(bzip2.compress, data, level=BZIP2_LEVEL,
                       device="cuda")

    def decompress(c):
        return bzip2.decompress(c, device="cuda")

    def round_trip():
        c = compress()
        return c, decompress(c)

    path = {k: getattr(mk, k) for k in MTF_FORWARD}
    timer = timing.enable()
    torch.cuda.reset_peak_memory_stats()
    ((comp, back), dt, counts), calls = spying(
        [(mtf_mod, "mtf_encode_lockstep")],
        lambda: counted(torch, path, round_trip))
    stages = timer.report()
    timing.disable()
    peak = torch.cuda.max_memory_allocated()
    sha = hashlib.sha256(comp).hexdigest()
    ratio = len(data) / len(comp)
    print(f"bzip2_pg1661x6: {dt:.3f} s, {len(comp)} B, {nblocks} blocks, "
          f"sha256 {sha}, launches {counts}", flush=True)
    require(back == data, "bzip2: round trip is not exact")
    require(bz2.decompress(comp) == data,
            "bzip2: bz2.decompress disagrees")
    require(sha == want_sha, "bzip2: not the bytes of bz2.compress")
    require(round(ratio, 3) == BZIP2_RATIO,
            f"bzip2: ratio {ratio} != {BZIP2_RATIO}")
    require(all(counts[k] == nblocks for k in MTF_FORWARD),
            f"bzip2: K1, the start tables, K2 not once per block: {counts}")
    table0, d = calls.pop("mtf_encode_lockstep")
    ranks = mk.mtf_encode_lockstep(table0, d)[0]
    rec, part, tile = mk.mtf_recency(d, partials=True)
    entries = check_kernels(torch, [
        *mtf_pair_checks(mk, d, rec, part, tile, "@bzip2",
                         k1_library(torch, d)),
        dict(name="mtf_encode_lockstep@bzip2", src="tpulc_torch/csrc/mtf.cu",
             replaces="tpulc/primitives/mtf_pallas.py:156",
             kern=mk.mtf_encode_lockstep, plain=mk.mtf_encode_lockstep_plain,
             args=(table0, d), shape="x".join(map(str, d.shape)),
             ops=int((2 * ranks.long() + 2).sum())),
    ])
    del table0, d, ranks, rec, part
    for e in entries:
        e["launches"] = counts[e["name"].split("@")[0]]
    kernels += entries
    res = {"kernels_last_block": entries, "input_bytes": len(data),
           "level": BZIP2_LEVEL, "blocks": nblocks, "bytes": len(comp),
           "ratio": ratio, "sha256": sha, "sha256_equals_bz2": True,
           "bz2_compress_s": stdlib_s, "launches": counts,
           "first_roundtrip_s": dt, "stages_first_run": stages,
           "peak_mem_bytes": peak,
           **warm_runs(torch, compress, decompress, data, 3),
           "trace": {"compress": traced(torch, compress),
                     "decompress": traced(torch, lambda: decompress(comp),
                                          on_device=False)}}
    print(json.dumps({"bzip2_pg1661x6": res}), flush=True)

    # lzss
    lzss = get_codec("lzss")
    small = data[:150_000]
    on_card = lzss.compress(small, block_size=1 << 16, device="cuda")
    require(on_card == lzss.compress(small, block_size=1 << 16,
                                     device="cpu"),
            "lzss card and CPU containers differ")
    require(lzss.decompress(on_card, device="cpu") == small,
            "the CPU fails to decode the card's lzss container")
    compress = partial(lzss.compress, data, block_size=LZSS_BLOCK,
                       device="cuda")

    def decompress(c):
        return lzss.decompress(c, device="cuda")

    timer = timing.enable()
    torch.cuda.reset_peak_memory_stats()
    comp, tc = synced(torch, compress)
    lzd.lzss_decode_device.synced_steps = 0
    back, td = synced(torch, lambda: decompress(comp))
    steps = lzd.lzss_decode_device.synced_steps
    stages = timer.report()
    timing.disable()
    peak = torch.cuda.max_memory_allocated()
    sha = hashlib.sha256(comp).hexdigest()
    ratio = len(data) / len(comp)
    nblocks = len(Container.from_bytes(comp).payloads)
    print(f"lzss_pg1661x6: compress {tc:.3f} s, decompress {td:.3f} s, "
          f"{len(comp)} B, {nblocks} blocks, sha256 {sha}, synced decode "
          f"steps {steps}", flush=True)
    require(back == data, "lzss: round trip is not exact")
    require(len(comp) == LZSS_BYTES, f"lzss: {len(comp)} B != {LZSS_BYTES}")
    require(round(ratio, 3) == LZSS_RATIO,
            f"lzss: ratio {ratio} != {LZSS_RATIO}")
    require(sha == LZSS_SHA256, "lzss: container differs from tpulc's")
    res = {"input_bytes": len(data), "block_size": LZSS_BLOCK,
           "blocks": nblocks, "container_bytes": len(comp), "ratio": ratio,
           "sha256": sha, "sha256_equals_tpulc": True,
           "decode_synced_steps": steps, "first_compress_s": tc,
           "first_decompress_s": td, "stages_first_run": stages,
           "peak_mem_bytes": peak,
           **warm_runs(torch, compress, decompress, data, 3),
           "trace": {"compress": traced(torch, compress),
                     "decompress": traced(torch, lambda: decompress(comp))}}
    print(json.dumps({"lzss_pg1661x6": res}), flush=True)

    # lzss on the soup
    _, _, size, want_ratio, want_sha = LZSS_SOUP
    data = soup(CORPUS_SIZE)
    comp, tc = synced(torch, partial(lzss.compress, data,
                                     block_size=LZSS_BLOCK, device="cuda"))
    back, td = synced(torch, lambda: decompress(comp))
    sha = hashlib.sha256(comp).hexdigest()
    ratio = len(data) / len(comp)
    print(f"lzss_soup: compress {tc:.3f} s, decompress {td:.3f} s, "
          f"{len(comp)} B, sha256 {sha}", flush=True)
    require(back == data, "lzss soup: round trip is not exact")
    require(len(comp) == size and round(ratio, 3) == want_ratio
            and sha == want_sha, "lzss soup: container differs from tpulc's")
    print(json.dumps({"lzss_soup": {
        "input_bytes": len(data), "block_size": LZSS_BLOCK,
        "container_bytes": len(comp), "ratio": ratio, "sha256": sha,
        "sha256_equals_tpulc": True, "first_compress_s": tc,
        "first_decompress_s": td,
        "compress_MBps": len(data) / 1e6 / tc,
        "decompress_MBps": len(data) / 1e6 / td}}), flush=True)


def stage_wrappers() -> dict:
    """The running max / min scans' and the anchored walk's wrappers, by
    name."""
    from tpulc_torch.codecs.bwt import ibwt_kernels as ik
    from tpulc_torch.primitives import scan_kernels as sk

    return {"running_max": sk.running_max, "running_min": sk.running_min,
            "anchored_walk": ik.anchored_walk}


def hand_kernels() -> dict:
    """Every hand kernel's wrapper (each counts its launches), by name."""
    from tpulc_torch.codecs.bsclike import abc_kernels as ak
    from tpulc_torch.codecs.bsclike import grc_kernels as gk
    from tpulc_torch.codecs.bsclike import rans
    from tpulc_torch.codecs.huffman import decode_kernels as dk
    from tpulc_torch.codecs.lzss import culzss
    from tpulc_torch.primitives import mtf_kernels as mk

    fns = (mk.mtf_recency, mk.mtf_start_tables, mk.mtf_encode_lockstep,
           mk.mtf_lockstep, dk.huffman_walk, dk.huffman_walk_v1,
           dk.huffman_walk_flat, gk.grc_walk_probs, gk.grc_reverse_rans,
           gk.grc_decode_walk, rans.rans_encode_walk, rans.rans_decode_walk,
           ak.abc_encode_walk, ak.abc_decode_walk, culzss.culzss_match)
    return {**{f.__name__: f for f in fns}, **stage_wrappers()}


def culzss_phase(torch, here: str, kernels: list) -> None:
    """Phase 12: culzss at 1 MiB blocks through get_codec, counted as in
    phase 4 (the match kernel once an encode group, no other hand
    kernel).  Each cell of CULZSS_CELLS: tpulc's container (size,
    ratio, sha256), an exact round trip, stage times, the decode's
    doubling rounds, peak device memory, MB/s from warm repeats and a
    trace of each direction; the card's container equal to the CPU
    path's on 150 KB; then 100,000,000 B of the soup, round-tripped
    exactly, its compress counted, with its peak device memory beside
    the packet groups; then the match kernel against its plain version
    on that soup's packets, a group and the call's groups (appended to
    `kernels`, their launches the counted compress's)."""
    import numpy as np

    from tpulc_torch.codecs.lzss import culzss as core
    from tpulc_torch.codecs.lzss import culzss_driver as drv
    from tpulc_torch.pipeline.registry import get_codec
    from tpulc_torch.utils import timing

    culzss = get_codec("culzss")
    pg = corpus(here)
    small = pg[:150_000]
    on_card = culzss.compress(small, block_size=1 << 16, device="cuda")
    require(on_card == culzss.compress(small, block_size=1 << 16,
                                       device="cpu"),
            "culzss card and CPU containers differ")
    require(culzss.decompress(on_card, device="cpu") == small,
            "the CPU fails to decode the card's culzss container")
    wrappers = hand_kernels()

    def decompress(c):
        return culzss.decompress(c, device="cuda")

    for label, src, size, want_ratio, want_sha in CULZSS_CELLS:
        data = pg if src == "pg" else soup(CORPUS_SIZE)
        compress = partial(culzss.compress, data, block_size=CULZSS_BLOCK,
                           device="cuda")
        timer = timing.enable()
        torch.cuda.reset_peak_memory_stats()
        comp, tc, n_c = counted(torch, wrappers, compress)
        core.culzss_decode_block.rounds = 0
        back, td, n_d = counted(torch, wrappers, lambda: decompress(comp))
        rounds = core.culzss_decode_block.rounds
        stages = timer.report()
        timing.disable()
        peak = torch.cuda.max_memory_allocated()
        sha = hashlib.sha256(comp).hexdigest()
        ratio = len(data) / len(comp)
        print(f"culzss_{label}: compress {tc:.3f} s, decompress {td:.3f} s, "
              f"{len(comp)} B, sha256 {sha}, doubling rounds {rounds}",
              flush=True)
        require(back == data, f"culzss {label}: round trip is not exact")
        require(len(comp) == size, f"culzss {label}: {len(comp)} B != {size}")
        require(round(ratio, 3) == want_ratio,
                f"culzss {label}: ratio {ratio} != {want_ratio}")
        require(sha == want_sha, f"culzss {label}: container differs from "
                                 "tpulc's")
        launched = {k: n_c[k] + n_d[k] for k in wrappers if n_c[k] + n_d[k]}
        packets = sum(drv.block_packets(len(data), CULZSS_BLOCK))
        groups = -(-packets // core.ENCODE_GROUP)
        require(launched == {"culzss_match": groups} == {
            k: v for k, v in n_c.items() if v},
            f"culzss launched {launched}, not the match kernel once in "
            f"each of {groups} encode groups")
        res = {"input_bytes": len(data), "block_size": CULZSS_BLOCK,
               "packets": packets,
               "container_bytes": len(comp), "ratio": ratio, "sha256": sha,
               "sha256_equals_tpulc": True, "hand_kernel_launches": launched,
               "decode_doubling_rounds": rounds, "first_compress_s": tc,
               "first_decompress_s": td, "stages_first_run": stages,
               "peak_mem_bytes": peak, "encode_group": core.ENCODE_GROUP,
               "decode_group": core.DECODE_GROUP,
               **warm_runs(torch, compress, decompress, data, 3),
               "trace": {"compress": traced(torch, compress),
                         "decompress": traced(torch,
                                              lambda: decompress(comp))}}
        print(json.dumps({f"culzss_{label}": res}), flush=True)

    big = soup(CULZSS_BIG)
    timer = timing.enable()
    torch.cuda.reset_peak_memory_stats()
    comp, tc, n_c = counted(torch, wrappers, partial(
        culzss.compress, big, block_size=CULZSS_BLOCK, device="cuda"))
    peak_c = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    core.culzss_decode_block.rounds = 0
    back, td = synced(torch, lambda: decompress(comp))
    peak_d = torch.cuda.max_memory_allocated()
    stages = timer.report()
    timing.disable()
    require(back == big, "culzss 100 MB soup: round trip is not exact")
    counts = drv.block_packets(len(big), CULZSS_BLOCK)
    packets = sum(counts)
    groups = -(-packets // core.ENCODE_GROUP)
    launched = {k: v for k, v in n_c.items() if v}
    require(launched == {"culzss_match": groups},
            f"culzss 100 MB soup: compress launched {launched}, not the "
            f"match kernel once in each of {groups} encode groups")
    print(json.dumps({"culzss_soup100MB": {
        "input_bytes": len(big), "block_size": CULZSS_BLOCK,
        "packets": packets, "container_bytes": len(comp),
        "ratio": len(big) / len(comp), "roundtrip_exact": True,
        "compress_s": tc, "decompress_s": td,
        "compress_MBps": len(big) / 1e6 / tc,
        "decompress_MBps": len(big) / 1e6 / td,
        "encode_group_packets": core.ENCODE_GROUP,
        "decode_group_packets": core.DECODE_GROUP,
        "peak_mem_bytes_compress": peak_c, "peak_mem_bytes_decompress": peak_d,
        "decode_doubling_rounds": core.culzss_decode_block.rounds,
        "hand_kernel_launches_compress": launched,
        "stages": stages, "timing": "first run, host clock, synchronized"}}),
        flush=True)
    grid = torch.from_numpy(drv.packet_grid(
        np.frombuffer(big, np.uint8), CULZSS_BLOCK, counts)).cuda().view(
        -1, core.PCKT)
    del comp, back, big
    # the encode's groups, each its own launch
    parts = tuple(grid[g: g + core.ENCODE_GROUP]
                  for g in range(0, packets, core.ENCODE_GROUP))

    def by_group(fn):
        return lambda *ps: tuple(fn(p) for p in ps)

    one = parts[0]
    kernels += check_kernels(torch, [
        dict(name="culzss_match", src="tpulc_torch/csrc/culzss_match.cu",
             replaces="tpulc/codecs/lzss/culzss.py:38-79 `_encode_packet`'s "
                      "equality rows and doubling (XLA, no pallas_call)",
             kern=core.culzss_match, plain=core.culzss_match_plain,
             args=(one,), shape=f"{one.shape[0]}x{core.PCKT}",
             ops=one.numel() * core.WIN),
        dict(name="culzss_match", src="tpulc_torch/csrc/culzss_match.cu",
             replaces="as above", kern=by_group(core.culzss_match),
             plain=by_group(core.culzss_match_plain), args=parts,
             shape=f"{packets}x{core.PCKT} as {len(parts)} launches",
             ops=grid.numel() * core.WIN, plain_reps=1),
    ])
    kernels[-2]["launches"] = kernels[-1]["launches"] = n_c["culzss_match"]


def dist_phase(torch, here: str, kernels: list) -> None:
    """Phase 13: the distribution layer on the card: the port's dry run
    as a user calls it (no group: it spawns one NCCL rank a card), then
    in an NCCL group of world size 1: the dry run; each sharded step of
    DIST_STEPS on make_args(2, 0) with tpulc's outputs (their pinned
    sha256) and equal to its body run without a group on the same card
    (`step.body`), with the same hand-kernel launches, which must be the
    kernels its functions launch and are printed; compress_multihost of
    pg1661 x 6 as bz (900,000 B blocks) writes tpulc's single-process
    compress_multihost bytes and as culzss (1 MiB) phase 12's container.
    `kernels` gains no entry: the steps launch earlier phases' kernels."""
    import torch.distributed as dist

    from tpulc_torch.codecs.bwt import driver
    from tpulc_torch.dist import sharded
    from tpulc_torch.dist.dryrun import dryrun_multichip, free_port
    from tpulc_torch.dist.mesh import make_mesh, mesh_device
    from tpulc_torch.dist.multihost import compress_multihost

    require(not dist.is_initialized(), "dist: a group exists before phase 13")
    _, spawned_s = synced(torch, lambda: dryrun_multichip(1))
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0)
    try:
        init_s = time.perf_counter() - t0
        wrappers = hand_kernels()
        _, dry_s, dry_n = counted(torch, wrappers, lambda: dryrun_multichip(1))
        mesh = make_mesh(1)
        dev = mesh_device(mesh)
        steps = {}
        for name, size, expect, digest in DIST_STEPS:
            step, make_args = getattr(sharded, "sharded_" + name)(mesh, size)
            args = make_args(2, 0)
            got, t_step, n_step = counted(torch, wrappers, lambda: step(*args))
            want, t_body, n_body = counted(torch, wrappers, lambda: step.body(
                *[sharded._tensor(a).to(dev) for a in args]))
            require(outputs_sha256([g.cpu().numpy() for g in got]) == digest,
                    f"dist: {name} differs from tpulc's step")
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"dist: {name} differs from its functions without a "
                    "group")
            launched = {k: v for k, v in n_step.items() if v}
            require(n_step == n_body, f"dist: {name} launches {launched}, "
                    f"its functions {n_body}")
            require(set(launched) == set(expect),
                    f"dist: {name} launched {launched}, not {expect}")
            steps[name] = {"launches": launched, "step_s": t_step,
                           "without_group_s": t_body}
        data = corpus(here)
        c_bz, bz_s = synced(torch, lambda: compress_multihost(
            data, BLOCK, "bz", device="cuda"))
        require(hashlib.sha256(c_bz).hexdigest() == DIST_BZ_SHA256,
                "dist: bz compress_multihost differs from tpulc's")
        require(c_bz == driver.compress(data, block_size=BLOCK,
                                        device="cuda"),
                "dist: bz compress_multihost differs from compress")
        require(driver.decompress(c_bz, device="cuda") == data,
                "dist: bz compress_multihost does not round-trip")
        c_cz, cz_s = synced(torch, lambda: compress_multihost(
            data, CULZSS_BLOCK, "culzss", device="cuda"))
        require(hashlib.sha256(c_cz).hexdigest() == CULZSS_CELLS[0][4],
                "dist: culzss compress_multihost is not phase 12's "
                "container")
        print(json.dumps({"dist_world1_nccl": {
            "backend": dist.get_backend(), "world_size":
            dist.get_world_size(), "init_s": init_s,
            "dryrun_multichip_spawned_s": spawned_s,
            "dryrun_multichip_s": dry_s,
            "dryrun_launches": {k: v for k, v in dry_n.items() if v},
            "steps": steps, "multihost": {
                "bz": {"bytes": len(c_bz), "sha256_equals_tpulc": True,
                       "s": bz_s},
                "culzss": {"bytes": len(c_cz),
                           "sha256_equals_phase12": True, "s": cz_s}},
            "scaling": "not measured: one card"}}), flush=True)
    finally:
        dist.destroy_process_group()


def warm3(torch, fn):
    """-> (fn()'s first result, the median ms of 3 more runs, each
    between two torch.cuda.synchronize() calls, and the peak device
    memory over the four calls, the first result alive)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    ts = [synced(torch, fn)[1] for _ in range(3)]
    return out, statistics.median(ts) * 1e3, torch.cuda.max_memory_allocated()


def prim_line(name: str, in_bytes: int, ms: float, peak: int, **extra):
    print(json.dumps({f"prim_{name}": {
        "input_bytes": in_bytes, "ms": ms, "GBps": in_bytes / ms / 1e6,
        "peak_mem_bytes": peak,
        "timing": "median of 3 warm runs, host clock, synchronized",
        **extra}}), flush=True)


def prim_suffix(torch, here: str) -> None:
    """Phase 14's suffix arrays, the SA-based BWT beside the rotation
    sort, and sort_strings_full."""
    import numpy as np

    from tpulc_torch.primitives import parallel as par
    from tpulc_torch.primitives.dc3 import dc3_suffix_array
    from tpulc_torch.primitives.dc3_device import (
        _suffix_ranks,
        suffix_array_dc3,
    )
    from tpulc_torch.primitives.suffix import sa_to_bwt, suffix_array

    dev = torch.device("cuda")
    pg = corpus(here)

    def on_card(b: bytes):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)

    for label, data in (("pg1661x6", pg), ("soup25MiB", soup(PRIM_SOUP))):
        d = on_card(data)
        sa, ms, peak = warm3(torch, lambda: suffix_array(d))
        rounds = suffix_array.rounds
        sa3, ms3, peak3 = warm3(torch, lambda: suffix_array_dc3(d))
        require(torch.equal(sa, sa3), f"suffix arrays differ on {label}")
        prim_line(f"suffix_array_{label}", len(data), ms, peak,
                  doubling_rounds=rounds)
        prim_line(f"suffix_array_dc3_{label}", len(data), ms3, peak3,
                  sample_doubling_rounds=_suffix_ranks.rounds,
                  equals_doubling=True)
        del d, sa, sa3

    # bz's block: SA + sa_to_bwt beside the production rotation sort
    head = np.frombuffer(pg[:BLOCK], np.uint8)
    want, host_s = synced(torch, lambda: dc3_suffix_array(head))
    blk = on_card(pg[:BLOCK])

    def sa_bwt():
        sa = suffix_array(blk)
        return sa, *sa_to_bwt(blk, sa)

    (sa, bwt, idx0), ms, peak = warm3(torch, sa_bwt)
    require(np.array_equal(sa.cpu().numpy(), want),
            "suffix_array differs from the host DC3 on 900,000 B")
    require(np.array_equal(suffix_array_dc3(blk).cpu().numpy(), want),
            "suffix_array_dc3 differs from the host DC3 on 900,000 B")
    require(np.array_equal(bwt.cpu().numpy(), head[(want - 1) % BLOCK])
            and int(idx0) == int(np.flatnonzero(want == 0)[0]),
            "sa_to_bwt differs from the host DC3's BWT")
    prim_line("sa_bwt_900000", BLOCK, ms, peak,
              doubling_rounds=suffix_array.rounds, host_dc3_s=host_s,
              equals_host_dc3=True)
    del sa, bwt, blk

    # sort_strings_full of pg1661 x 6's lines
    lines = pg.split(b"\n")
    packed = np.frombuffer(pg.replace(b"\n", b"\0") + b"\0", np.uint8)
    starts = np.concatenate([[0], np.flatnonzero(packed[:-1] == 0) + 1])
    chars = torch.from_numpy(packed.copy()).to(dev)
    st = torch.from_numpy(starts).to(dev)
    order, ms, peak = warm3(torch, lambda: par.sort_strings_full(chars, st))
    got = order.cpu().numpy()
    require([lines[i] for i in got] == sorted(lines),
            "sort_strings_full differs from Python's sorted")
    rank = torch.empty_like(chars, dtype=torch.int64)
    rank[suffix_array_dc3(chars)] = torch.arange(chars.shape[0], device=dev)
    ties = torch.sort(rank[st], stable=True).indices.cpu().numpy()
    require(np.array_equal(got, ties),
            "sort_strings_full breaks ties unlike the device DC3's ranks")
    prim_line("sort_strings_full_pg1661x6", len(packed), ms, peak,
              strings=len(lines), doubling_rounds=suffix_array.rounds)


def prim_parallel(torch) -> None:
    """Phase 14's scans, segmented scan, compaction, sorts, reduction
    and listrank against numpy."""
    import numpy as np

    from tpulc_torch.primitives import parallel as par

    dev = torch.device("cuda")
    rng = np.random.default_rng(PRIM_SEED)
    xn = rng.integers(-(1 << 30), 1 << 30, PRIM_N, dtype=np.int32)
    x = torch.from_numpy(xn).to(dev)
    nb = xn.nbytes

    def check(name, fn, want, **extra):
        got, ms, peak = warm3(torch, fn)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for g, w in zip(got, want):
            require(np.array_equal(g.cpu().numpy(), w), f"{name} differs "
                                                        "from numpy")
        prim_line(name, nb, ms, peak, **extra)
        return ms

    def excl(incl, ident):
        return np.concatenate([[ident], incl[:-1]]).astype(incl.dtype)

    cs = np.cumsum(xn, dtype=np.int32)
    check("scan_add", lambda: par.scan(x), cs)
    check("scan_add_exclusive", lambda: par.scan(x, exclusive=True),
          excl(cs, 0))
    rev = np.cumsum(xn[::-1], dtype=np.int32)[::-1]
    check("scan_add_reverse", lambda: par.scan(x, reverse=True), rev)
    mx = np.maximum.accumulate(xn)
    cm = check("scan_max_cummax", lambda: par.scan(x, op=torch.maximum), mx)
    ls = check("scan_max_log_step",
               lambda: par.scan(x, op=lambda a, b: torch.maximum(a, b)), mx)
    check("scan_min_reverse_exclusive",
          lambda: par.scan(x, op=torch.minimum, exclusive=True,
                           reverse=True),
          excl(np.minimum.accumulate(xn[::-1]),
               np.iinfo(np.int32).max)[::-1])
    check("scan_or_log_step", lambda: par.scan(x, op=torch.bitwise_or),
          np.bitwise_or.accumulate(xn))
    check("multi_scan_add_4096_rows", lambda: par.multi_scan(x.view(4096, -1)),
          np.cumsum(xn.reshape(4096, -1), axis=1, dtype=np.int32))
    print(json.dumps({"prim_cummax_vs_log_step": {
        "n": PRIM_N, "cummax_ms": cm, "log_step_ms": ls}}), flush=True)

    # segmented scans: segments of ~1,000
    fl = rng.random(PRIM_N) < 1e-3
    f = torch.from_numpy(fl).to(dev)
    head = fl.copy()
    head[0] = True
    seg = np.cumsum(head) - 1
    c64 = np.cumsum(xn, dtype=np.int64)
    base = (c64 - xn)[np.flatnonzero(head)]
    check("segmented_scan_add", lambda: par.segmented_scan(x, f),
          (c64 - base[seg]).astype(np.int32))
    off = seg.astype(np.int64) << 33
    check("segmented_scan_max_log_step",
          lambda: par.segmented_scan(x, f, op=torch.maximum),
          (np.maximum.accumulate(off + xn) - off).astype(np.int32))
    del fl, f, head, seg, c64, base, off

    mk = rng.random(PRIM_N) < 0.3
    m = torch.from_numpy(mk).to(dev)
    want = np.full(PRIM_N, -1, np.int32)
    want[: int(mk.sum())] = xn[mk]
    got, ms, peak = warm3(torch, lambda: par.compact(x, m, fill=-1))
    require(np.array_equal(got[0].cpu().numpy(), want)
            and int(got[1]) == int(mk.sum()), "compact differs from numpy")
    prim_line("compact", nb, ms, peak, kept=int(mk.sum()))
    del mk, m, want, got

    bk = rng.integers(0, 256, PRIM_N).astype(np.uint8)
    order = np.argsort(bk, kind="stable")
    counts = np.bincount(bk, minlength=256)
    b = torch.from_numpy(bk.astype(np.int32)).to(dev)
    check("multisplit_256", lambda: par.multisplit(x, b, 256),
          (xn[order], np.cumsum(counts) - counts))
    kk = rng.integers(0, 1 << 16, PRIM_N).astype(np.uint16)
    order = np.argsort(kk, kind="stable")
    k = torch.from_numpy(kk.astype(np.int32)).to(dev)
    check("sort_pairs", lambda: par.sort_pairs(k, x),
          (kk[order].astype(np.int32), xn[order]))
    h = PRIM_N // 2
    a_s = torch.sort(k[:h]).values
    b_s = torch.sort(k[h:]).values
    check("merge_sorted", lambda: par.merge_sorted(a_s, b_s),
          np.sort(kk, kind="stable").astype(np.int32))
    del bk, order, counts, b, kk, k, a_s, b_s
    s64 = int(xn.sum(dtype=np.int64))
    for name, op, want in (
            ("add", torch.add, (s64 + (1 << 31)) % (1 << 32) - (1 << 31)),
            ("max", torch.maximum, int(xn.max())),
            ("min", torch.minimum, int(xn.min()))):
        got, ms, peak = warm3(torch, lambda: par.reduce(x, op=op))
        require(int(got) == want, f"reduce {name} differs from numpy")
        prim_line(f"reduce_{name}", nb, ms, peak)
    del x

    order = rng.permutation(PRIM_NODES)
    nxt = np.empty(PRIM_NODES, np.int32)
    nxt[order] = np.roll(order, -1)
    rank = np.empty(PRIM_NODES, np.int64)
    rank[order] = np.arange(PRIM_NODES)
    t = torch.from_numpy(nxt).to(dev)
    got, ms, peak = warm3(torch, lambda: par.listrank(t, int(order[0])))
    require(np.array_equal(got.cpu().numpy(), rank),
            "listrank differs from the known ranks")
    prim_line("listrank", nxt.nbytes, ms, peak, nodes=PRIM_NODES)


def prim_aux(torch, here: str) -> None:
    """Phase 14's MD5 rand, spmv, tridiagonal solver, cuckoo table and
    histograms."""
    import struct

    import numpy as np

    from tpulc_torch.primitives import cudpp_aux, histogram

    dev = torch.device("cuda")
    rng = np.random.default_rng(PRIM_SEED + 1)

    words, ms, peak = warm3(
        torch, lambda: cudpp_aux.md5_rand(PRIM_N, PRIM_SEED, device="cuda"))
    require(torch.equal(words, cudpp_aux.md5_rand(PRIM_N, PRIM_SEED,
                                                  device="cuda")),
            "md5_rand is not deterministic")
    blocks = rng.choice(PRIM_N // 4, 4096, replace=False)
    w = words.view(-1, 4)[torch.from_numpy(blocks).to(dev)].cpu().numpy()
    for j, blk in enumerate(blocks):
        want = np.frombuffer(hashlib.md5(struct.pack(
            "<II", PRIM_SEED, int(blk))).digest(), "<u4")
        require(np.array_equal(w[j], want), f"md5_rand block {blk} differs "
                                            "from hashlib.md5")
    prim_line("md5_rand", PRIM_N * 4, ms, peak, words=PRIM_N,
              blocks_checked=4096, bytes_are="output (uint32 words)")
    del words

    nnz = SPMV_ROWS * SPMV_ROW_NNZ
    cols = rng.integers(0, SPMV_ROWS, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz, dtype=np.float32)
    xv = rng.standard_normal(SPMV_ROWS, dtype=np.float32)
    row_ptr = np.arange(0, nnz + 1, SPMV_ROW_NNZ, dtype=np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (vals, cols, row_ptr, xv)]
    y, ms, peak = warm3(torch, lambda: cudpp_aux.spmv(*args))
    prod = (vals.astype(np.float64) * xv.astype(np.float64)[cols]).reshape(
        SPMV_ROWS, SPMV_ROW_NNZ)
    err = np.abs(y.cpu().numpy() - prod.sum(1)) / np.abs(prod).sum(1)
    require(float(err.max()) <= 1e-5, f"spmv off by {float(err.max())}")
    prim_line("spmv", sum(a.nbytes for a in (vals, cols, row_ptr, xv)), ms,
              peak, rows=SPMV_ROWS, nnz=nnz, max_rel_err=float(err.max()))
    del args, prod, y

    shape = (TRI_SYSTEMS, TRI_N)
    a = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    c = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    b = (2.0 + np.abs(rng.standard_normal(shape))).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    args = [torch.from_numpy(z).to(dev) for z in (a, b, c, d)]
    xs, ms, peak = warm3(torch, lambda: cudpp_aux.tridiagonal_solve(*args))
    x64 = xs.cpu().numpy().astype(np.float64)
    r = b * x64 - d
    r[:, 1:] += a[:, 1:] * x64[:, :-1]
    r[:, :-1] += c[:, :-1] * x64[:, 1:]
    rel = np.linalg.norm(r, axis=1) / np.linalg.norm(d.astype(np.float64),
                                                     axis=1)
    require(float(rel.max()) <= 1e-4,
            f"tridiagonal residual {float(rel.max())}")
    prim_line("tridiagonal_solve", 4 * a.nbytes, ms, peak,
              systems=TRI_SYSTEMS, n=TRI_N, max_rel_residual=float(rel.max()))
    del args, xs

    cand = np.unique(rng.integers(0, 0xFFFFFFFF, int(2.2 * CUCKOO_KEYS),
                                  dtype=np.uint64)).astype(np.uint32)
    rng.shuffle(cand)
    keys, absent = cand[:CUCKOO_KEYS], cand[CUCKOO_KEYS: 2 * CUCKOO_KEYS]
    vals = rng.integers(0, 1 << 32, CUCKOO_KEYS, dtype=np.uint64).astype(
        np.uint32)
    table, ms, peak = warm3(
        torch, lambda: cudpp_aux.CuckooTable(keys, vals, device="cuda"))
    q = torch.from_numpy(np.concatenate([keys, absent]).astype(
        np.int64)).to(dev)
    (v, f), ms_l, peak_l = warm3(torch, lambda: table.lookup(q))
    v, f = v.cpu().numpy(), f.cpu().numpy()
    require(bool(f[:CUCKOO_KEYS].all())
            and np.array_equal(v[:CUCKOO_KEYS], vals.astype(np.int64)),
            "cuckoo: a key's value is wrong")
    require(not f[CUCKOO_KEYS:].any(), "cuckoo: an absent key was found")
    prim_line("cuckoo_build", keys.nbytes + vals.nbytes, ms, peak,
              keys=CUCKOO_KEYS, slots=table.size, build_rounds=table.rounds,
              stash=int(table.stash_k.shape[0]) - 1)
    prim_line("cuckoo_lookup", 4 * 2 * CUCKOO_KEYS, ms_l, peak_l,
              present=CUCKOO_KEYS, absent=CUCKOO_KEYS)
    del table, q

    data = np.frombuffer(corpus(here, HUFF_SIZE), np.uint8)
    t = torch.from_numpy(data.copy()).to(dev)
    got, ms, peak = warm3(torch, lambda: histogram.byte_histogram(t))
    require(np.array_equal(got.cpu().numpy(),
                           np.bincount(data, minlength=256)),
            "byte_histogram differs from np.bincount")
    prim_line("byte_histogram", data.nbytes, ms, peak)
    rows = np.frombuffer(corpus(here, HIST_ROWS << 20), np.uint8).reshape(
        HIST_ROWS, -1)
    t = torch.from_numpy(rows.copy()).to(dev)
    got, ms, peak = warm3(torch, lambda: histogram.batched_byte_histogram(t))
    require(np.array_equal(got.cpu().numpy(), np.stack(
        [np.bincount(r, minlength=256) for r in rows])),
            "batched_byte_histogram differs from np.bincount")
    prim_line("batched_byte_histogram", rows.nbytes, ms, peak,
              rows=HIST_ROWS)


def prim_golds(torch, here: str) -> None:
    """Phase 14's golds on the card's streams: the lzss gold and the card
    decode each other's streams of phase 11's blocks; every culzss packet
    of phase 12's container decodes by the serial gold."""
    from tpulc_torch.codecs.lzss import driver as lzss
    from tpulc_torch.codecs.lzss.culzss_driver import _parse
    from tpulc_torch.gold import culzss_gold, lzss_gold
    from tpulc_torch.pipeline.container import Container
    from tpulc_torch.pipeline.registry import get_codec

    pg = corpus(here)
    c = Container.from_bytes(lzss.compress(pg, block_size=LZSS_BLOCK,
                                           device="cuda"))
    dec_s = enc_s = card_s = 0.0
    for j, (p, info) in enumerate(zip(c.payloads, c.block_infos())):
        blk = pg[j * LZSS_BLOCK: j * LZSS_BLOCK + info.raw_size]
        back, dt = synced(torch, lambda: lzss_gold.lzss_decode(p, len(blk)))
        require(back == blk, f"lzss gold fails on the card's block {j}")
        enc, et = synced(torch, lambda: lzss_gold.lzss_encode(blk))
        back, ct = synced(torch, lambda: lzss.decompress_raw(
            enc, len(blk), device="cuda"))
        require(back == blk, f"the card fails on the gold's block {j}")
        dec_s, enc_s, card_s = dec_s + dt, enc_s + et, card_s + ct
    print(json.dumps({"prim_lzss_golds": {
        "blocks": len(c.payloads), "gold_decodes_card": True,
        "card_decodes_gold": True, "gold_decode_s": dec_s,
        "gold_encode_s": enc_s, "card_decode_s": card_s}}), flush=True)

    c = Container.from_bytes(get_codec("culzss").compress(
        pg, block_size=CULZSS_BLOCK, device="cuda"))
    packets = raw_packets = 0
    t0 = time.perf_counter()
    for j, (p, info) in enumerate(zip(c.payloads, c.block_infos())):
        sizes, raw, coded, _ = _parse(p, info.raw_size)
        blk = pg[j * CULZSS_BLOCK: j * CULZSS_BLOCK + info.raw_size]
        ends = sizes.cumsum()
        for k in range(sizes.shape[0]):
            want = blk[k * 4096: (k + 1) * 4096]
            if raw[k]:
                raw_packets += 1
                continue
            got = culzss_gold.decode_packet(
                coded[ends[k] - sizes[k]: ends[k]].tobytes())
            require(got[: len(want)] == want
                    and got[len(want):] == bytes(len(got) - len(want))
                    and len(got) in (4096, len(want)),
                    f"culzss gold fails on packet {k} of block {j}")
            packets += 1
    print(json.dumps({"prim_culzss_gold": {
        "packets_decoded": packets, "raw_packets": raw_packets,
        "gold_decode_s": time.perf_counter() - t0}}), flush=True)


def prim_phase(torch, here: str, kernels: list) -> None:
    """Phase 14: the primitive layer and the golds at the sizes users
    run (see the module docstring).  No hand kernel may launch but the
    culzss match kernel of the codec that writes the golds' packets: the
    layer is plain torch, and `kernels` gains no entry."""
    _, dt, launches = counted(torch, hand_kernels(), lambda: (
        prim_suffix(torch, here), prim_parallel(torch),
        prim_aux(torch, here), prim_golds(torch, here)))
    # the golds' culzss packets come from the codec, whose match search
    # is a hand kernel
    launched = {k: v for k, v in launches.items()
                if v and k != "culzss_match"}
    require(not launched, f"the primitive layer launched hand kernels: "
                          f"{launched}")
    prim_rotsort(torch, here)
    print(f"phase 14: {dt:.1f} s", flush=True)


def prim_rotsort(torch, here: str) -> None:
    """bz's production rotation sort on the 900,000 B block of
    `prim_suffix`'s SA-based BWT, beside it: a codec stage, outside the
    primitive layer (its pair resolver may launch the running-min
    scan, whose launches are printed)."""
    from tpulc_torch.codecs.bwt import rotsort

    blk = torch.frombuffer(bytearray(corpus(here)[:BLOCK]),
                           dtype=torch.uint8).to("cuda")
    (_, ms, peak), _, launches = counted(torch, hand_kernels(), lambda: warm3(
        torch, lambda: rotsort.bwt_encode_anchored(blk, 512)))
    prim_line("rotsort_bwt_encode_anchored_900000", BLOCK, ms, peak,
              hand_kernel_launches={k: v for k, v in launches.items() if v})


def mtf_soup_entries(torch, ranks, suffix: str = "@soup",
                     builds: bool = True) -> list:
    """K1, the start tables, K2 and K4 at a bsc soup shape: a 25 MiB
    block's MTF ranks int32[cap] as chunks of 128 (204,800 after the
    BWT; 409,600 for st8w's last column and next-char stream), its
    sorted stream recovered through `mtf_decode`, K1 and the start
    tables as the forward path calls them.  The plain K2 and K4 run
    once (~0.3 s each at 204,800 chunks).  With `builds`, also prints
    K2's walk and every K4, K1 and start-table build at this shape."""
    from tpulc_torch import cuda_lib
    from tpulc_torch.primitives import mtf_kernels as mk
    from tpulc_torch.primitives.mtf import mtf_decode

    r = ranks.reshape(-1, 128).contiguous()
    d = mtf_decode(ranks.to(torch.uint8)).to(torch.int32).reshape(
        -1, 128).contiguous()
    rec, part, tile = mk.mtf_recency(d, partials=True)
    table0 = mk.mtf_start_tables(rec, 128, tile=tile, part=part)
    require(torch.equal(mk.mtf_encode_lockstep(table0, d)[0], r),
            "K2 does not re-encode the soup block's ranks")
    shape = "x".join(map(str, d.shape))
    src = "tpulc_torch/csrc/mtf.cu"
    entries = check_kernels(torch, [
        *mtf_pair_checks(mk, d, rec, part, tile, suffix,
                         k1_library(torch, d)),
        dict(name="mtf_encode_lockstep" + suffix, src=src,
             replaces="tpulc/primitives/mtf_pallas.py:156",
             kern=mk.mtf_encode_lockstep,
             plain=mk.mtf_encode_lockstep_plain, args=(table0, d),
             shape=shape, ops=int((2 * r.long() + 2).sum()), plain_reps=1),
        dict(name="mtf_lockstep" + suffix, src=src,
             replaces="tpulc/primitives/mtf_pallas.py:89",
             kern=mk.mtf_lockstep, plain=mk.mtf_lockstep_plain,
             args=(table0, r), shape=shape, ops=k4_ops(r), plain_reps=1),
    ])
    for e in entries:
        e["shape"] = shape
        e["ns_per_step"] = e["device_ms"] * 1e6 / d.shape[1]
    if not builds:
        return entries
    k4 = k4_variants(torch, mk, cuda_lib, table0, r,
                     mk.mtf_lockstep_plain(table0, r))
    entries[-1]["calls"] = {t: k4[t] for t in ("perm", "syms")}
    print(json.dumps({"soup_shape_builds": {
        "k2": k2_walk(torch, cuda_lib, table0, d, entries[2]["device_ms"]),
        "start_tables": start_tiles(torch, mk, cuda_lib, d,
                                    mk.mtf_start_tables_plain(rec, 128),
                                    split=True),
        "k4": k4, "zero_rank_share": float((r == 0).float().mean())}}),
        flush=True)
    return entries


def traced(torch, fn, keep: list | None = None,
           on_device: bool = True, forbid: tuple = ()) -> dict:
    """One run of fn under torch.profiler: host wall, device-busy time
    (the union of the device events' intervals: kernels and copies) and
    share, the kernels the trace recorded beside the kernel launches the
    host made (fewer kernels than launches: the trace lost device
    records, and its busy share is low), and the ten largest device
    times by name; fn's output is
    appended to `keep` when one is given.  A run `on_device` must show
    device time; one that runs on the host alone must show none; no op
    named in `forbid` (e.g. "aten::cummax") may run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall = synced(torch, fn)
    if keep is not None:
        keep.append(out)
    spans, by_name, kernel_events, launch_calls = [], {}, 0, 0
    ran = set()
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            launch_calls += ev.name in LAUNCH_CALLS
            ran.add(ev.name)
            continue
        kernel_events += not ev.name.startswith(("Memcpy", "Memset"))
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        us, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (us + t1 - t0, n + 1)
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    require((busy_us > 0) == on_device,
            "the profiler saw no device time" if on_device else
            "a host-only run put work on the device")
    require(not ran & set(forbid), f"the run called {sorted(ran & set(forbid))}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall,
            "kernel_events": kernel_events, "launch_calls": launch_calls,
            "top": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                    for k, (us, n) in top]}


def path_profile(torch, compress, decompress, forbid: tuple = ()) -> dict:
    """Where a warm round trip's time goes: the codec's own stage
    timers over one compress() and one decompress(comp), then each
    under torch.profiler (`traced`, no op of `forbid` allowed)."""
    from tpulc_torch.utils import timing

    timer = timing.enable()
    comp, _ = synced(torch, compress)
    synced(torch, lambda: decompress(comp))
    stages = timer.report()
    timing.disable()
    return {"stages": stages,
            "compress": traced(torch, compress, forbid=forbid),
            "decompress": traced(torch, lambda: decompress(comp),
                                 forbid=forbid)}


if __name__ == "__main__":
    sys.exit(main())
