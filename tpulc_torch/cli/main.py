"""tpulc_torch command-line driver (port of `tpulc/cli/main.py`).

Usage:
    python -m tpulc_torch.cli compress   [-c huffman] -i IN -o OUT [-b 1048576]
                                         [--device cuda|cpu] [--timings]
                                         [bsc: -m bwt|st3..st8|st8w -e 1|2
                                          --no-lzp --filter F]
                                         [lzss: --exact] [bzip2: --level N]
    python -m tpulc_torch.cli decompress -i IN -o OUT [--device cuda|cpu]
    python -m tpulc_torch.cli info       -i IN

The container is tpulc's and so are the defaults (huffman, 1 MiB
blocks), so either CLI decodes what the other wrote, and the same
codec arguments write the same bytes.  `bzip2` writes a bare .bz2
stream, which `info` and `decompress` recognise by its `BZh` magic, as
tpulc's do.  Every tpulc codec is ported: huffman, bz, store, bsc on
every sorter (`-m bwt`, the default, `st3`..`st8`, `st8w`) with either
coder (`-e 1`, the default, or `-e 2`), bzip2, lzss and culzss.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import (
    available_codecs,
    codec_name_of,
    get_codec,
)


def _parse(argv):
    p = argparse.ArgumentParser(prog="tpulc_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("compress")
    c.add_argument("-c", "--codec", default="huffman",
                   choices=sorted(available_codecs()))
    c.add_argument("-i", "--input", required=True)
    c.add_argument("-o", "--output", required=True)
    c.add_argument("-b", "--block-size", type=int, default=1 << 20)
    c.add_argument("--no-lzp", action="store_true",
                   help="bsc: disable the LZP preprocessor")
    c.add_argument("-m", "--sorter", default="bwt",
                   choices=["bwt", "st3", "st4", "st5", "st6", "st7", "st8",
                            "st8w"],
                   help="bsc: block sorter — bwt (the default), ST-k "
                        "(st3..st8, inverse walk on the host) or st8w "
                        "(ST-8 with its next-char stream, inverse on the "
                        "device)")
    c.add_argument("--filter", default="none", dest="filter_mode",
                   help="bsc: preprocessing filter "
                        "(none|reverse|reorder:N|auto); `none` passes "
                        "nothing, so the codec's default `auto` applies")
    c.add_argument("-e", "--coder", type=int, default=1, choices=[1, 2],
                   help="bsc: entropy coder — 1 static order-2 context "
                        "rANS (the default), 2 the best-ratio coder (the "
                        "group-rank coder on bwt, the adaptive binary "
                        "coder on an ST sorter)")
    c.add_argument("--exact", action="store_true",
                   help="lzss: reference-parity longest-match search")
    c.add_argument("--level", type=int, default=None, choices=range(1, 10),
                   metavar="1..9",
                   help="bzip2: block level 1-9 (default from block size)")
    d = sub.add_parser("decompress")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output", required=True)
    for q in (c, d):
        q.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the codec runs (cuda raises when absent)")
        q.add_argument("--timings", action="store_true",
                       help="print the seconds of each stage, then every "
                       "span, the waits by site and their totals, as two "
                       "JSON lines on stderr")
    n = sub.add_parser("info", help="inspect a container without decoding")
    n.add_argument("-i", "--input", required=True)
    return p.parse_args(argv)


def _info(data: bytes) -> int:
    """Container introspection: codec, block geometry, per-block
    compressed sizes and checksums — no decode; a .bz2 stream reports
    its level and stream count (tpulc's `BZh` count)."""
    if data[:3] == b"BZh":
        print(json.dumps({"format": ".bz2", "level": int(chr(data[3])),
                          "streams": data.count(b"BZh")}))
        return 0
    c = Container.from_bytes(data)
    blocks = [
        {"index": b.index, "offset": b.offset, "comp_size": b.comp_size,
         "raw_size": b.raw_size,
         "payload_adler": c.payload_adlers[b.index]}
        for b in c.block_infos()
    ]
    print(json.dumps({
        "format": "tplc",
        "codec": codec_name_of(c.codec_id),
        "orig_len": c.orig_len,
        "block_size": c.block_size,
        "nblocks": len(c.payloads),
        "comp_len": len(data),
        "ratio": round(c.orig_len / max(len(data), 1), 3),
        "data_adler": c.data_adler,
        "blocks": blocks,
    }))
    return 0


def _codec_kwargs(args) -> dict:
    """tpulc's CLI passes a codec option only when it differs from the
    CLI default (`tpulc/cli/main.py:108-121`), so the same argv writes
    the same bytes."""
    if args.codec == "lzss" and args.exact:
        return {"exact": True}
    if args.codec == "bzip2" and args.level is not None:
        return {"level": args.level}
    if args.codec != "bsc":
        return {}
    kw = {}
    if args.no_lzp:
        kw["use_lzp"] = False
    if args.sorter != "bwt":
        kw["sorter"] = args.sorter
    if args.filter_mode != "none":
        kw["filter_mode"] = args.filter_mode
    if args.coder != 1:
        kw["coder"] = args.coder
    return kw


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    with open(args.input, "rb") as f:
        data = f.read()
    if args.cmd == "info":
        return _info(data)
    from tpulc_torch.device import resolve
    from tpulc_torch.utils import timing

    try:
        resolve(args.device)
    except RuntimeError as e:
        print(f"tpulc_torch: {e}", file=sys.stderr)
        return 2
    timer = timing.enable() if args.timings else None
    try:
        t0 = time.perf_counter()
        if args.cmd == "compress":
            codec = get_codec(args.codec)
            out = codec.compress(data, block_size=args.block_size,
                                 device=args.device, **_codec_kwargs(args))
            dt = time.perf_counter() - t0
            ratio = len(data) / max(len(out), 1)
            print(f"compressed {len(data)} -> {len(out)} bytes "
                  f"(ratio {ratio:.3f}) in {dt:.3f}s on {args.device} "
                  f"({len(data) / dt / 1e6:.2f} MB/s)")
        else:
            codec = get_codec("bzip2" if data[:3] == b"BZh"
                              else Container.from_bytes(data).codec_id)
            out = codec.decompress(data, device=args.device)
            dt = time.perf_counter() - t0
            print(f"decompressed {len(data)} -> {len(out)} bytes in "
                  f"{dt:.3f}s on {args.device} "
                  f"({len(out) / dt / 1e6:.2f} MB/s)")
    finally:
        if timer is not None:
            timing.disable()
    with open(args.output, "wb") as f:
        f.write(out)
    if timer is not None:
        print(timer.json(), file=sys.stderr)
        print(json.dumps(timer.trace()), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
