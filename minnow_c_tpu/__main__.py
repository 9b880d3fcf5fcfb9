"""Command-line interface: compress / decompress / inspect minnow files.

Usage::

    python -m minnow_c_tpu compress   snap.g2 out.g2.min [--pos-delta X]
    python -m minnow_c_tpu compress   snap.0.hdf5 snap.1.hdf5 out.il.min
    python -m minnow_c_tpu decompress out.g2.min snap.g2
    python -m minnow_c_tpu decompress out.il.min snap.hdf5
    python -m minnow_c_tpu info       out.g2.min
    python -m minnow_c_tpu verify     out.g2.min
    python -m minnow_c_tpu repack     out.g2.min out.cart.min --algo Cart
    python -m minnow_c_tpu query     out.g2.min --origin X Y Z --size W H D
"""

from __future__ import annotations

import argparse
import sys


_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def _is_hdf5(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _HDF5_MAGIC


def _is_illustris_min(path: str) -> bool:
    """.il.min carries a JSON meta record first; .g2.min carries the raw
    256-byte Gadget-2 header record.  Peek past the 4-byte record length."""
    import struct
    with open(path, "rb") as f:
        raw = f.read(5)
    return len(raw) == 5 and struct.unpack("<I", raw[:4])[0] > 0 \
        and raw[4:5] == b"{"


def _skip_client_header(f) -> bytes:
    """Archive commands accept both layouts: ``.g2.min`` files carry the
    raw Gadget-2 header record before the IOHeader chain
    (header_format.tex IO_format figure); plain ``.min`` files written
    through the library API start directly at the 'Mnw\\0' magic.  Skips
    and returns the client record if present, else b"" with the file
    positioned at the chain start."""
    import struct
    from .drivers.gadget2 import _read_record
    from .segment.io import MAGIC
    pos = f.tell()
    head = f.read(4)
    f.seek(pos)
    if len(head) == 4 and struct.unpack("<I", head)[0] == MAGIC:
        return b""
    return _read_record(f)


def main(argv=None):
    p = argparse.ArgumentParser(prog="minnow_c_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser(
        "compress",
        help="Gadget-2 or Illustris-HDF5 snapshot -> .min (HDF5 chunk "
             "files may be listed together and merge into one archive)")
    c.add_argument("input", nargs="+")
    c.add_argument("output")
    c.add_argument("--pos-delta", type=float, default=1e-3)
    c.add_argument("--vel-delta", type=float, default=1.0)
    c.add_argument("--blocks", type=int, default=None)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--scale-mode", choices=("div", "recip"),
                   default="div", dest="scale_mode",
                   help="float bin map: 'div' = C-exact division "
                        "(default), 'recip' = reciprocal multiply "
                        "(wire-compatible, see doc/wire_format.md "
                        "section 6)")

    d = sub.add_parser("decompress",
                       help=".g2.min -> Gadget-2 / .il.min -> HDF5")
    d.add_argument("input")
    d.add_argument("output")

    i = sub.add_parser("info", help="list segments of a .min file")
    i.add_argument("input")

    t = sub.add_parser("repack", help="losslessly re-encode every "
                                      "segment with a different codec")
    t.add_argument("input")
    t.add_argument("output")
    t.add_argument("--algo", required=True,
                   help="target codec: Trim, Diff, Coil, Octo, Sort, Cart")
    t.add_argument("--codec-version", default=None, metavar="X.Y.Z",
                   help="codec version (default: newest registered). "
                        "'Sort --codec-version 1.2.1' selects the "
                        "order-free profile: the rank stream is dropped "
                        "(much smaller files, Diff-class decode) and "
                        "values decode in ASCENDING order -- scalar "
                        "(Unsf/Unsi) fields only; choose it for "
                        "order-free analysis archives")

    v = sub.add_parser("verify", help="integrity-check every segment, "
                                      "field, and block checksum")
    v.add_argument("input")

    q = sub.add_parser("query", help="count segments intersecting a box "
                                     "(skip-ahead spatial query)")
    q.add_argument("input")
    q.add_argument("--origin", type=float, nargs=3, required=True,
                   metavar=("X", "Y", "Z"))
    q.add_argument("--size", type=float, nargs=3, required=True,
                   metavar=("W", "H", "D"))
    q.add_argument("--periodic", type=float, default=None,
                   help="box length for wrap-aware intersection")

    args = p.parse_args(argv)
    from .utils import compile_cache
    compile_cache.enable()

    if args.cmd == "compress":
        import os
        hdf5 = [_is_hdf5(path) for path in args.input]
        if any(hdf5) and not all(hdf5):
            raise SystemExit("cannot mix HDF5 and Gadget-2 inputs")
        if all(hdf5):
            from .drivers import illustris
            with open(args.output, "wb") as fout:
                if len(args.input) == 1:
                    stats = illustris.compress(
                        args.input[0], fout, pos_delta=args.pos_delta,
                        vel_delta=args.vel_delta, seed=args.seed,
                        scale_mode=args.scale_mode)
                else:
                    stats = illustris.compress_multi(
                        args.input, fout, pos_delta=args.pos_delta,
                        vel_delta=args.vel_delta, seed=args.seed,
                        scale_mode=args.scale_mode)
            n = sum(e["n"] for e in stats["meta"]["part_types"])
            types = ", ".join(e["name"] for e in stats["meta"]["part_types"])
        else:
            if len(args.input) != 1:
                raise SystemExit(
                    "Gadget-2 compress takes exactly one input file")
            from .drivers import gadget2
            with open(args.input[0], "rb") as fin, \
                    open(args.output, "wb") as fout:
                stats = gadget2.compress(
                    fin, fout, pos_delta=args.pos_delta,
                    vel_delta=args.vel_delta,
                    num_blocks=args.blocks, seed=args.seed,
                    scale_mode=args.scale_mode)
            n = stats["n"]
            types = f"{stats['num_blocks']} segments"
        raw = sum(os.path.getsize(path) for path in args.input)
        out = os.path.getsize(args.output)
        src = args.input[0] if len(args.input) == 1 else \
            f"{len(args.input)} chunk files"
        print(f"{src}: {n} particles ({types}), {raw} -> {out} bytes "
              f"(ratio {out / raw:.3f})")
    elif args.cmd == "decompress":
        if _is_illustris_min(args.input):
            from .drivers import illustris
            with open(args.input, "rb") as fin:
                meta = illustris.decompress(fin, args.output)
            n = sum(e["n"] for e in meta["part_types"])
            print(f"{args.output}: box {meta['box_size']}, "
                  f"z={meta['redshift']}, {n} particles, "
                  f"{len(meta['part_types'])} particle types")
        else:
            from .drivers import gadget2
            with open(args.input, "rb") as fin, \
                    open(args.output, "wb") as fout:
                hdr = gadget2.decompress(fin, fout)
            print(f"{args.output}: box {hdr.box_size}, z={hdr.redshift}, "
                  f"npart {sum(hdr.npart)}")
    elif args.cmd == "info":
        from .segment import io as seg_io
        from . import semver
        with open(args.input, "rb") as f:
            _skip_client_header(f)
            for k, hd in enumerate(seg_io.iter_headers(
                    f, all_chains=True)):
                geom = "no geometry" if all(
                    w == 0.0 for w in hd.width) else \
                    (f"box {tuple(round(o, 3) for o in hd.origin)} + "
                     f"{tuple(round(w, 3) for w in hd.width)}")
                print(f"segment {k}: {hd.segment_bytes} bytes, "
                      f"library v{semver.to_string(hd.version)}, {geom}")
    elif args.cmd == "repack":
        from .drivers.gadget2 import _write_record
        from .segment import io as seg_io
        from .segment.api import transcode_segment
        from .types import AlgoCode
        try:
            algo = getattr(AlgoCode, args.algo.upper())
        except AttributeError:
            raise SystemExit(f"unknown codec {args.algo!r}")
        cver = None
        if args.codec_version is not None:
            from . import semver as _sv
            try:
                cver = _sv.from_string(args.codec_version)
            except ValueError as e:
                raise SystemExit(str(e))
        import os
        with open(args.input, "rb") as fin, open(args.output, "wb") as fo:
            client = _skip_client_header(fin)
            if client:
                _write_record(fo, client)  # client header verbatim
            # Transcode chain by chain so multi-chain archives (e.g.
            # .il.min: one chain per particle type) keep their chain
            # boundaries -- readers rely on NextIOHeader = 0 per chain.
            n = 0
            while True:
                pos = fin.tell()
                if len(fin.read(1)) == 0:
                    break  # end of file
                fin.seek(pos)
                pairs = ((transcode_segment(seg, algo, version=cver),
                          (hd.origin, hd.width))
                         for hd, seg in seg_io.iter_segments(fin))
                n += seg_io.write_segments_streaming(fo, pairs)
        a = os.path.getsize(args.input)
        b = os.path.getsize(args.output)
        print(f"{args.output}: {n} segments transcoded to "
              f"{args.algo}, {a} -> {b} bytes ({b / a:.3f}x)")
    elif args.cmd == "verify":
        from .segment import io as seg_io, format as seg_fmt
        bad = total_seg = total_blocks = bad_blocks = 0
        with open(args.input, "rb") as f:
            try:
                _skip_client_header(f)
                for k, (hd, seg_bytes) in enumerate(
                        seg_io.iter_segments(f, all_chains=True)):
                    total_seg += 1
                    try:
                        parsed = seg_fmt.deserialize(seg_bytes)
                    except Exception as e:
                        print(f"segment {k}: UNPARSEABLE ({e})")
                        bad += 1
                        continue
                    for fld in parsed.fields:
                        total_blocks += len(fld.blocks)
                        nbad = sum(b is None for b in fld.blocks)
                        bad_blocks += nbad
                        if nbad:
                            code = fld.field_code.to_bytes(
                                4, "little").decode("ascii", "replace")
                            print(f"segment {k} field {code!r}: {nbad} of "
                                  f"{len(fld.blocks)} blocks corrupt")
                            bad += 1
            except ValueError as e:
                # a corrupt IOHeader chain ends the walk, not the tool
                print(f"chain walk aborted: {e}")
                bad += 1
        status = "OK" if bad == 0 else "CORRUPT"
        print(f"{args.input}: {status} -- {total_seg} segments, "
              f"{total_blocks} blocks, {bad_blocks} corrupt")
        return 0 if bad == 0 else 1
    elif args.cmd == "query":
        from .segment import io as seg_io
        with open(args.input, "rb") as f:
            _skip_client_header(f)
            total = hits = 0
            start = f.tell()
            for hd in seg_io.iter_headers(f, all_chains=True):
                total += 1
            f.seek(start)
            for hd, _seg in seg_io.iter_segments_intersecting(
                    f, tuple(args.origin), tuple(args.size),
                    args.periodic, all_chains=True):
                hits += 1
            print(f"{hits} of {total} segments intersect "
                  f"[{args.origin}, +{args.size}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
