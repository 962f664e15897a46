"""The ``zeekstd`` command line: compress / decompress / list.

The command line of ``zeekstd_tpu.cli`` on the port:
``python -m zeekstd_tpu_torch compress --backend tpu ...`` encodes and
decodes on the CUDA card, ``--device cpu`` runs the kernels' plain
versions instead. With no card, ``--backend tpu`` exits with an error
before it opens a file. The default backend, ``auto``, is the native
runtime whenever it builds, as in the JAX package.

Mirrors the reference CLI's commands, flags, and behaviors
(reference: cli/src/):

- no subcommand = compress (reference: cli/src/main.rs:29-31)
- checksums ON by default, ``--no-checksum`` disables
  (reference: cli/src/compress.rs:41)
- byte-size values accept B/K(iB)/M(iB)/G(iB) suffixes
  (reference: cli/src/args.rs:20-42)
- output-path derivation: compress appends ``.zst``; decompress strips it
  and refuses unknown extensions (reference: cli/src/command.rs:107-125)
- overwrite protection with interactive y/n prompt, refused when quiet or
  reading stdin (reference: cli/src/command.rs:45-79)
- ``--seek-table-file`` writes a standalone Head-format table
  (reference: cli/src/compress.rs:84-95)
- ``list`` prints a summary row or per-frame detail table
  (reference: cli/src/command.rs:408-473)
"""

from __future__ import annotations

import argparse
import mmap
import os
import sys
import time

from .codec.compress import CCtx
from .codec.decompress import DCtx
from .decode import DecodeOptions
from .device import resolve_device
from .encode import EncodeOptions, Encoder, FrameSizePolicy
from .errors import ZeekstdError
from .seek_table import Format, SeekTable

#: Prefix files at or above this size are memory-mapped by default
#: (reference: cli/src/args.rs:8-9).
MMAP_THRESHOLD = 0x0010_0000


def parse_byte_value(text: str) -> int:
    """B/K/M/G-suffixed sizes (reference: cli/src/args.rs:20-42)."""
    t = text.strip()
    low = t.lower()
    for suffix, mult in (
        ("kib", 1 << 10), ("mib", 1 << 20), ("gib", 1 << 30),
        ("kb", 1 << 10), ("mb", 1 << 20), ("gb", 1 << 30),
        ("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30), ("b", 1),
    ):
        if low.endswith(suffix):
            num = t[: -len(suffix)].strip()
            if not num:
                raise argparse.ArgumentTypeError(f"missing number in {text!r}")
            return int(num) * mult
    try:
        return int(t)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid byte value {text!r}") from None


def parse_offset_limit(text: str):
    """A byte value or the literal "end" (reference: cli/src/args.rs:56-67)."""
    if text.strip().lower() == "end":
        return "end"
    return parse_byte_value(text)


def parse_last_frame(text: str):
    """A frame index or the literal "end" (reference: cli/src/args.rs:75-86)."""
    if text.strip().lower() == "end":
        return "end"
    v = int(text)
    if v < 0:
        raise argparse.ArgumentTypeError("frame index must be >= 0")
    return v


def parse_num_frames(text: str) -> int:
    v = int(text)
    if v <= 0:
        raise argparse.ArgumentTypeError("number of frames must be > 0")
    return v


def human_bytes(n: float, raw: bool = False) -> str:
    if raw:
        return str(int(n))
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.2f} TiB"


class Progress:
    """Throttled progress meter on stderr (reference renders at 5 Hz:
    cli/src/command.rs:196-200)."""

    def __init__(self, enabled: bool, label: str):
        self.enabled = enabled and sys.stderr.isatty()
        self.label = label
        self.last = 0.0
        self.n = 0

    def update(self, delta: int) -> None:
        self.n += delta
        now = time.monotonic()
        if self.enabled and now - self.last >= 0.2:
            self.last = now
            sys.stderr.write(f"\r{self.label}: {human_bytes(self.n)}   ")
            sys.stderr.flush()

    def finish(self) -> None:
        if self.enabled:
            sys.stderr.write("\r\x1b[K")
            sys.stderr.flush()


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="zeekstd",
        description="Compress/decompress data in the Zstandard Seekable Format.",
    )
    p.add_argument("-V", "--version", action="version", version=f"zeekstd_tpu_torch {__version__}")
    p.add_argument("-q", "--quiet", action="store_true", help="suppress output")
    p.add_argument(
        "--raw-bytes", action="store_true", help="print byte counts without units"
    )
    sub = p.add_subparsers(dest="command")

    def add_globals(sp):
        # Global flags are accepted before OR after the subcommand (clap's
        # `global = true` behavior, reference cli/src/args.rs:111-136).
        # SUPPRESS keeps the subparser from clobbering a value the main
        # parser already set from a pre-subcommand flag.
        sp.add_argument("-q", "--quiet", action="store_true",
                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)
        sp.add_argument("--raw-bytes", action="store_true",
                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)

    def add_common(sp):
        add_globals(sp)
        sp.add_argument(
            "--backend", choices=["auto", "python", "native", "tpu"],
            default="auto",
            help="execution backend (default: native runtime when "
            "available; tpu = batched device archive pipeline on the CUDA card)",
        )
        sp.add_argument(
            "--device", choices=["cuda", "cpu"], default="cuda",
            help="device of the tpu backend (default: cuda; cpu runs the "
            "kernels' plain versions)",
        )
        sp.add_argument("-f", "--force", action="store_true", help="overwrite without asking; allow tty output")
        sp.add_argument("-c", "--stdout", action="store_true", help="write to standard output")
        sp.add_argument("--no-progress", action="store_true", help="disable the progress bar")
        sp.add_argument("-o", "--output-file", help="output file path")
        sp.add_argument("input", nargs="?", default="-", help="input file (default: stdin)")

    def add_compress_args(sp):
        add_common(sp)
        sp.add_argument("-l", "--compression-level", type=int, default=3, help="compression level 1-19 (default 3)")
        sp.add_argument("--no-checksum", action="store_true", help="disable per-frame content checksums")
        sp.add_argument("-s", "--frame-size", type=parse_byte_value, default=parse_byte_value("2M"), help="frame size (default 2M)")
        sp.add_argument("--frame-size-policy", choices=["compressed", "uncompressed"], default="uncompressed")
        sp.add_argument("--patch-from", help="file the input is diffed against (binary patch creation)")
        sp.add_argument("--seek-table-file", help="write the seek table to this separate file (Head format)")
        sp.add_argument("--mmap-prefix", dest="mmap_prefix", action="store_true", default=None, help="memory-map the prefix file")
        sp.add_argument("--no-mmap-prefix", dest="mmap_prefix", action="store_false", help="never memory-map the prefix file")

    comp = sub.add_parser("compress", help="compress input (default command)")
    add_compress_args(comp)

    dec = sub.add_parser("decompress", aliases=["d"], help="decompress a seekable archive")
    add_common(dec)
    start = dec.add_mutually_exclusive_group()
    start.add_argument("--from", dest="from_offset", type=parse_byte_value, default=None, help="decompressed byte offset to start from")
    start.add_argument("--from-frame", type=int, default=None, help="frame index to start from")
    end = dec.add_mutually_exclusive_group()
    end.add_argument("--to", dest="to_offset", type=parse_offset_limit, default=None, help="decompressed byte offset to stop at, or 'end'")
    end.add_argument("--to-frame", type=parse_last_frame, default=None, help="last frame index (inclusive), or 'end'")
    dec.add_argument("--patch-apply", help="prefix file to apply a binary patch against")
    dec.add_argument("--seek-table-file", help="read the seek table from this separate file")
    dec.add_argument("--mmap-prefix", dest="mmap_prefix", action="store_true", default=None)
    dec.add_argument("--no-mmap-prefix", dest="mmap_prefix", action="store_false")

    lst = sub.add_parser("list", aliases=["l"], help="print seek table information")
    add_globals(lst)
    lst.add_argument("input", help="seekable archive or standalone seek table")
    lst.add_argument("--from-frame", type=int, default=None)
    ex = lst.add_mutually_exclusive_group()
    ex.add_argument("--to-frame", type=parse_last_frame, default=None)
    ex.add_argument("--num-frames", type=parse_num_frames, default=None)
    lst.add_argument("--detail", action="store_true", help="per-frame table")
    lst.add_argument(
        "--seek-table-format", choices=["foot", "head"], default="foot",
        help="where the seek table lives in the input (default foot)",
    )
    return p


class CliError(Exception):
    pass


def _confirm_overwrite(path: str, force: bool, quiet: bool, interactive_ok: bool) -> None:
    """(reference: cli/src/command.rs:45-79)"""
    if not os.path.exists(path) or force:
        return
    if quiet or not interactive_ok or not sys.stdin.isatty():
        raise CliError(f"{path} already exists; use --force to overwrite")
    sys.stderr.write(f"{path} already exists. Overwrite? (y/n) ")
    sys.stderr.flush()
    answer = input().strip().lower()
    if answer not in ("y", "yes"):
        raise CliError("not overwritten")


def _derive_compress_output(input_path: str) -> str:
    """compress appends .zst (reference: cli/src/command.rs:107-109)."""
    return input_path + ".zst"


def _derive_decompress_output(input_path: str) -> str:
    """decompress strips .zst, refusing unknown extensions
    (reference: cli/src/command.rs:110-125)."""
    if input_path.endswith(".zst"):
        return input_path[: -len(".zst")]
    raise CliError(
        f"cannot derive output name: {input_path!r} has no .zst extension "
        "(use -o or --stdout)"
    )


def _load_prefix(path: str | None, mmap_flag):
    """Read or mmap the prefix file (reference: cli/src/command.rs:372-395)."""
    if path is None:
        return None
    size = os.path.getsize(path)
    use_mmap = mmap_flag if mmap_flag is not None else size >= MMAP_THRESHOLD
    f = open(path, "rb")
    if use_mmap and size > 0:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    data = f.read()
    f.close()
    return data


def _open_input(path: str):
    if path == "-":
        return sys.stdin.buffer, True
    if not os.path.exists(path):
        raise CliError(f"{path}: no such file")
    return open(path, "rb"), False


def _open_output(args, derive, is_stdin: bool):
    if args.stdout or (args.output_file is None and is_stdin):
        if sys.stdout.isatty() and not args.force:
            # (reference: cli/src/command.rs:152-155)
            raise CliError("refusing to write to a terminal; use -f to force or -o FILE")
        return sys.stdout.buffer, None
    path = args.output_file or derive()
    _confirm_overwrite(path, args.force, args.quiet, interactive_ok=not is_stdin)
    return open(path, "wb"), path


def _check_backend(args) -> None:
    """Refuse, before any file is opened, the ``tpu`` backend on a device
    that is not there."""
    if args.backend == "tpu":
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            raise CliError(str(e)) from None


def cmd_compress(args) -> int:
    _check_backend(args)
    if args.backend == "tpu":
        if args.frame_size_policy == "compressed":
            raise CliError(
                "--frame-size-policy compressed is not supported with "
                "--backend tpu"
            )
    src, is_stdin = _open_input(args.input)
    out, out_path = _open_output(
        args, lambda: _derive_compress_output(args.input), is_stdin
    )
    prefix = _load_prefix(args.patch_from, args.mmap_prefix)

    cctx = CCtx()
    if prefix is not None:
        # Patch mode: window must cover the prefix; enable long-distance
        # matching semantics (reference: cli/src/compress.rs:31-37).
        cctx.set_window_log(max(len(prefix).bit_length() + 1, 10))
        cctx.set_enable_ldm(True)

    policy = (
        FrameSizePolicy.compressed(args.frame_size)
        if args.frame_size_policy == "compressed"
        else FrameSizePolicy.uncompressed(args.frame_size)
    )
    opts = (
        EncodeOptions(cctx)
        .with_compression_level(args.compression_level)
        .with_checksum_flag(not args.no_checksum)
        .with_frame_size_policy(policy)
        .with_backend(args.backend)
        .with_device(args.device)
    )
    enc = Encoder(opts, out)
    progress = Progress(not args.no_progress and not args.quiet, "compressing")

    read_total = 0
    while True:
        chunk = src.read(1 << 17)
        if not chunk:
            break
        if prefix is not None:
            enc.compress_with_prefix(chunk, prefix)
            prefix_sent = True
        else:
            enc.compress(chunk)
        read_total += len(chunk)
        progress.update(len(chunk))

    if args.seek_table_file:
        # Frames to the main output, table to a separate Head-format file
        # (reference: cli/src/compress.rs:84-95).
        enc.end_frame()
        written = enc.written_compressed()
        table = enc.seek_table().to_bytes(Format.HEAD)
        _confirm_overwrite(args.seek_table_file, args.force, args.quiet, not is_stdin)
        with open(args.seek_table_file, "wb") as tf:
            tf.write(table)
        written_all = written + len(table)
    else:
        written_all = enc.finish()
    progress.finish()
    if hasattr(out, "flush"):
        out.flush()
    if out_path is not None:
        out.close()

    if not args.quiet:
        ratio = (written_all / read_total * 100) if read_total else 0.0
        name = "stdin" if is_stdin else args.input
        sys.stderr.write(
            f"{name} : {ratio:.2f}% ( {human_bytes(read_total, args.raw_bytes)} => "
            f"{human_bytes(written_all, args.raw_bytes)}, "
            f"{out_path or 'stdout'})\n"
        )
    if not is_stdin:
        src.close()
    return 0


def _resolve_decode_range(args, st: SeekTable):
    """Frame indices override byte offsets (reference: cli/src/args.rs:274-298)."""
    offset = None
    limit = None
    if args.from_frame is not None:
        offset = st.frame_start_decomp(args.from_frame)
    elif args.from_offset is not None:
        offset = args.from_offset
    if args.to_frame is not None:
        limit = None if args.to_frame == "end" else st.frame_end_decomp(args.to_frame)
    elif args.to_offset is not None:
        limit = None if args.to_offset == "end" else args.to_offset
    return offset, limit


def cmd_decompress(args) -> int:
    _check_backend(args)
    src, is_stdin = _open_input(args.input)
    if is_stdin:
        raise CliError("decompress requires a seekable input file")
    out, out_path = _open_output(
        args, lambda: _derive_decompress_output(args.input), is_stdin
    )
    prefix = _load_prefix(args.patch_apply, args.mmap_prefix)

    if args.seek_table_file:
        with open(args.seek_table_file, "rb") as tf:
            st = SeekTable.from_reader(tf)
    else:
        st = None

    dctx = DCtx()
    if prefix is not None:
        # (reference: cli/src/decompress.rs:54-63)
        dctx.set_parameter_window_log_max(max(len(prefix).bit_length() + 1, 10))

    opts = DecodeOptions(src, dctx).with_backend(args.backend).with_device(args.device)
    if st is not None:
        opts = opts.with_seek_table(st)
    if prefix is not None:
        opts = opts.with_prefix(bytes(prefix))
    dec = opts.into_decoder()
    offset, limit = _resolve_decode_range(args, dec.seek_table())
    if offset is not None:
        dec.set_offset(offset)
    if limit is not None:
        dec.set_offset_limit(limit)

    progress = Progress(not args.no_progress and not args.quiet, "decompressing")
    written = 0
    while True:
        chunk = dec.read(1 << 17)
        if not chunk:
            break
        out.write(chunk)
        written += len(chunk)
        progress.update(len(chunk))
    progress.finish()
    if hasattr(out, "flush"):
        out.flush()
    if out_path is not None:
        out.close()

    if not args.quiet:
        read = dec.read_compressed
        ratio = (read / written * 100) if written else 0.0
        sys.stderr.write(
            f"{args.input} : {ratio:.2f}% ( {human_bytes(read, args.raw_bytes)} => "
            f"{human_bytes(written, args.raw_bytes)}, {out_path or 'stdout'})\n"
        )
    src.close()
    return 0


def cmd_list(args) -> int:
    fmt = Format.HEAD if args.seek_table_format == "head" else Format.FOOT
    with open(args.input, "rb") as f:
        st = SeekTable.from_seekable_format(f, fmt)

    lower = args.from_frame if args.from_frame is not None else 0
    if args.num_frames is not None:
        upper = min(lower + args.num_frames - 1, st.num_frames - 1)
    elif args.to_frame is not None and args.to_frame != "end":
        upper = min(args.to_frame, st.num_frames - 1)
    else:
        upper = st.num_frames - 1

    raw = args.raw_bytes
    out = sys.stdout
    if args.detail:
        # Per-frame table, flushed in batches (reference: cli/src/command.rs:446-470).
        out.write(
            f"{'Frame':>8} {'C-Offset':>12} {'D-Offset':>12} {'C-Size':>12} {'D-Size':>12}\n"
        )
        lines = 0
        for i in range(lower, upper + 1):
            out.write(
                f"{i:>8} {st.frame_start_comp(i):>12} {st.frame_start_decomp(i):>12} "
                f"{human_bytes(st.frame_size_comp(i), raw):>12} "
                f"{human_bytes(st.frame_size_decomp(i), raw):>12}\n"
            )
            lines += 1
            if lines % 100 == 0:
                out.flush()
    else:
        # Summary row (reference: cli/src/command.rs:422-428).
        c_size = sum(st.frame_size_comp(i) for i in range(lower, upper + 1)) if st.num_frames else 0
        d_size = sum(st.frame_size_decomp(i) for i in range(lower, upper + 1)) if st.num_frames else 0
        ratio = (c_size / d_size * 100) if d_size else 0.0
        out.write(
            f"{'Frames':>8} {'Compressed':>12} {'Uncompressed':>14} "
            f"{'Max-Frame-Size':>15} {'Ratio':>8} {'Filename':>10}\n"
        )
        out.write(
            f"{upper - lower + 1:>8} {human_bytes(c_size, raw):>12} "
            f"{human_bytes(d_size, raw):>14} "
            f"{human_bytes(st.max_frame_size_decomp, raw):>15} {ratio:>7.2f}% "
            f"{os.path.basename(args.input):>10}\n"
        )
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    # No subcommand = compress (reference: cli/src/main.rs:29-31).
    known = {"compress", "decompress", "d", "list", "l", "-h", "--help"}
    passthrough = {"-h", "--help", "-V", "--version"}
    first_positional = next((a for a in argv if not a.startswith("-")), None)
    if first_positional not in known and not passthrough.intersection(argv):
        # Find insertion point after global flags.
        insert_at = 0
        for i, a in enumerate(argv):
            if a in ("-q", "--quiet", "--raw-bytes"):
                insert_at = i + 1
            else:
                break
        argv.insert(insert_at, "compress")
    args = parser.parse_args(argv)
    if args.command in ("d",):
        args.command = "decompress"
    if args.command in ("l",):
        args.command = "list"
    try:
        if args.command == "compress":
            return cmd_compress(args)
        if args.command == "decompress":
            return cmd_decompress(args)
        if args.command == "list":
            return cmd_list(args)
        parser.print_help()
        return 2
    except (CliError, ZeekstdError) as e:
        sys.stderr.write(f"zeekstd: error: {e}\n")
        return 1
    except BrokenPipeError:
        return 1


if __name__ == "__main__":
    sys.exit(main())
