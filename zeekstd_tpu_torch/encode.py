"""Streaming seekable encoder: frame-size policies, RawEncoder, Encoder.

Mirrors the reference's encode layer (reference: lib/src/encode.rs):

- ``FrameSizePolicy`` — when to cut frames: by uncompressed size (default
  2 MiB) or by compressed size (reference: lib/src/encode.rs:15-39).
- ``EncodeOptions`` — builder carrying the compression context/parameters
  (reference: lib/src/encode.rs:94-207).
- ``RawEncoder`` — reusable caller-driven streaming encoder producing
  compressed bytes + a seek table (reference: lib/src/encode.rs:209-545).
- ``Encoder`` — single-use writer-backed wrapper whose ``finish()`` appends
  the serialized seek table (reference: lib/src/encode.rs:547-800).

Two calling conventions are offered on the raw layer:

- ``compress()``/``end_frame()`` return produced bytes (the Pythonic
  surface; the resumable unit is the internal step).
- ``compress_into()``/``end_frame_into()`` implement the reference's
  byte-granular caller-owned-buffer contract (reference:
  lib/src/encode.rs:41-92, 295-355): each call reports
  ``CompressionProgress``/``EpilogueProgress``, the caller re-presents
  unconsumed input and drains full output buffers, and arbitrarily tiny
  buffers (the reference tortures with input/500 steps) produce the
  identical archive.

The ``tpu`` backend feeds buffered input to ``archive.compress_archive``
on the CUDA card, several frames per call, and logs the frames into the
same ``SeekTable``; ``with_device("cpu")`` runs the kernels' plain
versions instead. ``auto`` picks the native runtime (``native/``) where
the JAX package does: whenever it builds, except on the compressed
policy with a prefix or an explicit window, which stay on the Python
frame encoder.

Three faults of ``zeekstd_tpu.encode`` are not copied: a compressed-policy
cut stops at ``SEEKABLE_MAX_FRAME_SIZE`` and carries the rest into the
next frame; the compressed-policy probe keeps the sizes of the whole steps
it has probed and probes only new input; and input buffered for the
device is flushed, in order, before a prefix moves the stream onto the
host frame encoder.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import archive
from .codec.compress import CCtx, FrameEncoder
from .constants import (
    DEFAULT_COMPRESSION_LEVEL,
    DEFAULT_FRAME_SIZE,
    SEEKABLE_MAX_FRAME_SIZE,
)
from .device import resolve_device, trace_range
from .errors import NumberConversionError
from .native import loader
from .native.frame import NativeFrameEncoder, NativeStreamFrameEncoder
from .seek_table import Format, SeekTable


@dataclass(frozen=True)
class CompressionProgress:
    """Progress of one ``compress_into`` step (reference:
    lib/src/encode.rs:41-63): bytes consumed from the caller's input and
    bytes written to the caller's output buffer."""

    in_progress: int
    out_progress: int


@dataclass(frozen=True)
class EpilogueProgress:
    """Progress of one ``end_frame_into`` step (reference:
    lib/src/encode.rs:65-92). ``data_left`` means the caller must call
    again with a fresh buffer."""

    out_progress: int
    data_left: bool


@dataclass(frozen=True)
class FrameSizePolicy:
    """Frame-cutting policy (reference: lib/src/encode.rs:15-39).

    ``kind='uncompressed'``: start a new frame once the current one holds
    ``size`` uncompressed bytes (default, 2 MiB).
    ``kind='compressed'``: start a new frame once the current one's
    compressed payload reaches ``size`` bytes.
    The 1 GiB hard cap always applies (reference: lib/src/encode.rs:17-19).
    """

    kind: str
    size: int

    def __post_init__(self):
        if self.kind not in ("compressed", "uncompressed"):
            raise ValueError(f"unknown frame size policy kind {self.kind!r}")
        if not 0 < self.size <= SEEKABLE_MAX_FRAME_SIZE:
            raise NumberConversionError(
                f"frame size {self.size} out of range (1..{SEEKABLE_MAX_FRAME_SIZE})"
            )

    @classmethod
    def uncompressed(cls, size: int = DEFAULT_FRAME_SIZE) -> "FrameSizePolicy":
        return cls("uncompressed", size)

    @classmethod
    def compressed(cls, size: int) -> "FrameSizePolicy":
        return cls("compressed", size)


class EncodeOptions:
    """Builder for encoders (reference: lib/src/encode.rs:94-207).

    Checksums default OFF in the library (reference: lib/src/encode.rs:146)
    and are enabled explicitly by the CLI (reference: cli/src/compress.rs:41).

    ``backend``: "auto" (the native runtime when it builds), "python",
    "native", or "tpu"; ``device``: the ``tpu`` backend's device.
    """

    def __init__(self, cctx: CCtx | None = None):
        self.cctx = cctx if cctx is not None else CCtx()
        self.frame_size_policy = FrameSizePolicy.uncompressed()
        self.checksum_flag = False
        self.compression_level = DEFAULT_COMPRESSION_LEVEL
        self.backend = "auto"
        self.device = None

    def with_backend(self, backend: str) -> "EncodeOptions":
        """"auto" (native when available), "python", "native", or "tpu" -
        the batched device archive pipeline on the CUDA card (prefix/patch
        mode supported; the compressed policy by two passes)."""
        if backend not in ("auto", "python", "native", "tpu"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        return self

    def with_device(self, device) -> "EncodeOptions":
        """The ``tpu`` backend's device: ``None`` (the default) is the CUDA
        card, ``"cpu"`` runs the kernels' plain versions."""
        self.device = device
        return self

    def with_cctx(self, cctx: CCtx) -> "EncodeOptions":
        self.cctx = cctx
        return self

    def with_frame_size_policy(self, policy: FrameSizePolicy) -> "EncodeOptions":
        self.frame_size_policy = policy
        return self

    def with_checksum_flag(self, flag: bool) -> "EncodeOptions":
        self.checksum_flag = flag
        return self

    def with_compression_level(self, level: int) -> "EncodeOptions":
        self.compression_level = level
        return self

    def into_raw_encoder(self) -> "RawEncoder":
        return RawEncoder(self)

    def into_encoder(self, writer) -> "Encoder":
        return Encoder(self, writer)


class RawEncoder:
    """Reusable streaming seekable encoder (reference: lib/src/encode.rs:209-545).

    ``compress()`` returns compressed bytes as frames fill per the policy;
    ``end_frame()`` force-closes the current frame; ``finish_seek_table()``
    is NOT part of this layer — callers serialize via
    ``into_seek_table().into_serializer()`` exactly as in the reference
    (lib/src/lib.rs:112-119).
    """

    def __init__(self, options: EncodeOptions | None = None):
        self.options = options if options is not None else EncodeOptions()
        # A missing card raises here, not in the middle of a write.
        self._device = (resolve_device(self.options.device)
                        if self.options.backend == "tpu" else None)
        self.cctx = self.options.cctx
        self.cctx.set_compression_level(self.options.compression_level)
        self.cctx.set_checksum_flag(self.options.checksum_flag)
        self._seek_table = SeekTable()
        self._frame: FrameEncoder | None = None
        self._frame_c_size = 0
        self._frame_d_size = 0
        self._prefix: bytes | None = None
        # (compressed size, size) of the whole steps at the head of
        # ``_tpu_buf`` that the compressed policy's pass 1 has probed.
        self._probe_steps: list[tuple[int, int]] = []

    # -- internal ----------------------------------------------------------

    def _policy_window_log(self) -> int:
        pol = self.options.frame_size_policy
        if pol.kind == "uncompressed":
            need = max(pol.size, 1 << 10)
            log = need.bit_length() - (0 if need & (need - 1) else 1)
            return min(log, 27)
        return 24  # compressed policy: uncompressed size unknown upfront

    def _use_native(self) -> bool:
        if self.options.backend == "python":
            return False
        pol = self.options.frame_size_policy
        if pol.kind == "compressed":
            # Served by the native streaming context (one compressed
            # block per step) unless a prefix or explicit window is in
            # play — those stay on the Python frame encoder.
            if (self._prefix or b"") or self.cctx.window_log > 0:
                return False
            return loader.available()
        if self.options.backend == "native":
            return True
        # auto: the native runtime serves every level; the Python path
        # stays available via backend="python".
        return loader.available()

    def _begin_frame(self) -> None:
        prefix = self._prefix if self._prefix is not None else b""
        pol = self.options.frame_size_policy
        if self._use_native():
            if pol.kind == "compressed":
                # Input-step granularity scales with the threshold so the
                # cut lands within ~a quarter threshold of it (the Python
                # frame encoder uses the same heuristic).
                self._frame = NativeStreamFrameEncoder(
                    checksum=self.cctx.checksum, level=self.cctx.level,
                    block_size=max(pol.size // 4, 1024),
                )
            else:
                self._frame = NativeFrameEncoder(
                    checksum=self.cctx.checksum, prefix=prefix,
                    level=self.cctx.level, ldm=self.cctx.ldm,
                )
            self._frame_c_size = 0
            self._frame_d_size = 0
            return
        # Compressed-size policy needs fine-grained block flushes so the
        # cut threshold is observable as the frame grows.
        block_size = max(pol.size // 4, 1024) if pol.kind == "compressed" else None
        self._frame = FrameEncoder(
            level=self.cctx.level,
            checksum=self.cctx.checksum,
            prefix=prefix,
            window_log=max(self.cctx.window_log, 0) or self._policy_window_log(),
            block_size=block_size,
            enable_ldm=self.cctx.ldm,
        )
        self._frame_c_size = 0
        self._frame_d_size = 0

    def _remaining_frame_size(self) -> int:
        """Uncompressed bytes until an auto frame cut
        (reference: lib/src/encode.rs:528-535)."""
        pol = self.options.frame_size_policy
        if pol.kind == "uncompressed":
            return min(pol.size, SEEKABLE_MAX_FRAME_SIZE) - self._frame_d_size
        # The native streaming encoder declares a fixed 16 MiB window;
        # the frame must cut before input exceeds it.
        cap = getattr(self._frame, "d_cap", SEEKABLE_MAX_FRAME_SIZE)
        return min(cap, SEEKABLE_MAX_FRAME_SIZE) - self._frame_d_size

    def _is_frame_complete(self) -> bool:
        """(reference: lib/src/encode.rs:537-544)"""
        pol = self.options.frame_size_policy
        if pol.kind == "compressed" and self._frame_c_size >= pol.size:
            return True
        return self._remaining_frame_size() <= 0

    # -- public API --------------------------------------------------------

    def compress(self, data) -> bytes:
        return self.compress_with_prefix(data, None)

    # How many policy-sized frames the TPU backend batches per device
    # dispatch: every dispatch pays a launch, a sync and a pull, so the
    # streaming layer feeds the archive pipeline several frames at once.
    TPU_BATCH_FRAMES = 8

    def _tpu_flush(self, final: bool) -> bytes:
        """Flush buffered input through the batched device archive pipeline
        in whole policy-frames (plus the trailing partial frame when
        ``final``), logging the produced frames into this seek table."""
        buf = self._tpu_buf
        fsize = self.options.frame_size_policy.size
        usable = len(buf) if final else (len(buf) // fsize) * fsize
        if usable == 0:
            return b""
        with trace_range("enc.flush"):
            chunk = bytes(buf[:usable])
            del buf[:usable]
            blob, st = archive.compress_archive(
                chunk,
                frame_size=fsize,
                checksum=self.cctx.checksum,
                level=self.cctx.level,
                prefix=self._prefix or b"",
                device=self._device,
            )
            for i in range(st.num_frames):
                self._seek_table.log_frame(
                    st.frame_size_comp(i), st.frame_size_decomp(i)
                )
            return blob

    def _tpu_flush_compressed(self, final: bool) -> bytes:
        """Compressed frame-size policy on the TPU backend, two-pass
        (reference cut rule: frame completes when its compressed size
        reaches the threshold, lib/src/encode.rs:537-544):

        pass 1 compresses the buffered input at step granularity
        (step = threshold/4, the host FrameEncoder's feed heuristic) to
        get per-step compressed-size estimates; cut points come from
        their prefix sums. Pass 1 probes only input it has not probed
        before: the sizes of whole steps stay in ``_probe_steps`` until a
        cut consumes them (probe frames are independent frames, so the
        cuts are those of a probe of the whole buffer), and the trailing
        partial step is probed again as it grows. A frame that reaches
        ``SEEKABLE_MAX_FRAME_SIZE`` is cut there and the rest of its last
        step carried into the next one. Pass 2 re-compresses the cut
        variable-length frames in ONE batched device dispatch via
        ``frame_spans``. Steps past the last cut stay buffered unless
        ``final``."""
        buf = self._tpu_buf
        if not buf:
            return b""
        with trace_range("enc.flush"):
            pol = self.options.frame_size_policy
            threshold = min(pol.size, SEEKABLE_MAX_FRAME_SIZE)
            step = max(threshold // 4, 1024)
            chunk = bytes(buf)
            steps = self._probe_steps
            probe = list(steps)
            if len(steps) * step < len(chunk):
                _, probe_st = archive.compress_archive(
                    chunk[len(steps) * step :], frame_size=step, checksum=False,
                    level=self.cctx.level, device=self._device,
                )
                new = [(probe_st.frame_size_comp(i), probe_st.frame_size_decomp(i))
                       for i in range(probe_st.num_frames)]
                probe += new
                steps += [e for e in new if e[1] == step]
            cap = SEEKABLE_MAX_FRAME_SIZE
            spans = []
            start = 0
            cum = 0
            pos = 0
            for c_size, d_size in probe:
                cum += c_size
                pos += d_size
                while pos - start > cap:
                    spans.append((start, cap))
                    start += cap
                    cum = 0
                if cum >= threshold or pos - start >= cap:
                    spans.append((start, pos - start))
                    start = pos
                    cum = 0
            if final and start < len(chunk):
                spans.append((start, len(chunk) - start))
                start = len(chunk)
            if not spans:
                return b""
            blob, st = archive.compress_archive(
                chunk[: spans[-1][0] + spans[-1][1]],
                checksum=self.cctx.checksum,
                level=self.cctx.level,
                frame_spans=spans,
                device=self._device,
            )
            del buf[:start]
            if start % step:
                steps.clear()
            else:
                del steps[: start // step]
            for i in range(st.num_frames):
                self._seek_table.log_frame(
                    st.frame_size_comp(i), st.frame_size_decomp(i)
                )
            return blob

    def _tpu_compress(self, data) -> bytes:
        buf = getattr(self, "_tpu_buf", None)
        if buf is None:
            buf = self._tpu_buf = bytearray()
        buf += bytes(data)
        pol = self.options.frame_size_policy
        if pol.kind == "compressed":
            # Two-pass cuts: flush once enough input is buffered that
            # several frames are all but certain (compressed threshold /
            # a conservative 10% floor on the ratio).
            if len(buf) >= max(10 * self.TPU_BATCH_FRAMES * pol.size, 1 << 23):
                return self._tpu_flush_compressed(final=False)
            return b""
        fsize = pol.size
        if len(buf) >= self.TPU_BATCH_FRAMES * fsize:
            return self._tpu_flush(final=False)
        return b""

    def _tpu_flush_final(self) -> bytes:
        """All input buffered for the device, as frames (``final``)."""
        if self.options.frame_size_policy.kind == "compressed":
            return self._tpu_flush_compressed(final=True)
        return self._tpu_flush(final=True)

    def _end_host_frame(self) -> bytes:
        """Close the host frame encoder's frame, with any input and output
        the ``_into`` contract holds."""
        out = bytearray()
        if getattr(self, "_inbuf", None):
            self._flush_inbuf(final=True)
        if getattr(self, "_pending", None):
            out += self._pending
            self._pending.clear()
        out += self._end_frame_internal()
        return bytes(out)

    def compress_with_prefix(self, data, prefix) -> bytes:
        """Compress ``data``, cutting frames per the policy; the optional
        prefix is re-applied at every frame start
        (reference: lib/src/encode.rs:311-355).

        On the ``tpu`` backend a change of path keeps input order: input
        buffered for the device is flushed as frames before a prefix moves
        the stream onto the host frame encoder (the compressed policy),
        and a host frame left open is closed before the stream moves back
        onto the device."""
        if prefix is not None:
            self._prefix = bytes(prefix)
        if self.options.backend == "tpu" and (
            self.options.frame_size_policy.kind == "uncompressed"
            # Compressed-policy cuts use frame_spans, which cannot carry
            # a prefix — patch mode keeps the host frame encoder.
            or not (self._prefix or b"")
        ):
            head = self._end_host_frame() if self._frame is not None else b""
            return head + self._tpu_compress(data)
        head = self._tpu_flush_final() if getattr(self, "_tpu_buf", None) else b""
        data = memoryview(bytes(data) if not isinstance(data, (bytes, memoryview)) else data)
        out = bytearray(head)
        # Interop with the _into contract: flush any buffered step input and
        # hand back bytes it produced.
        if getattr(self, "_inbuf", None):
            self._flush_inbuf(final=True)
        if getattr(self, "_pending", None):
            out += self._pending
            self._pending.clear()
        pos = 0
        pol = self.options.frame_size_policy
        while pos < len(data):
            if self._frame is None:
                self._begin_frame()
            take = min(len(data) - pos, self._remaining_frame_size())
            if pol.kind == "compressed":
                # Feed block-by-block so the threshold check below sees the
                # compressed size advance (reference checks after each
                # compress_stream2 step: lib/src/encode.rs:317-327).
                take = min(take, self._frame.block_max)
            if take > 0:
                produced = self._frame.compress(bytes(data[pos : pos + take]))
                self._frame_c_size += len(produced)
                self._frame_d_size += take
                out += produced
                pos += take
            if self._is_frame_complete():
                out += self._end_frame_internal()
        return bytes(out)

    def end_frame(self) -> bytes:
        """Close the current frame and log it in the seek table
        (reference: lib/src/encode.rs:438-472)."""
        if self.options.backend == "tpu" and getattr(self, "_tpu_buf", None):
            return self._tpu_flush_final()
        if (
            self.options.backend == "tpu"
            and self.options.frame_size_policy.kind == "uncompressed"
        ):
            return b""
        return self._end_host_frame()

    # -- byte-granular caller-owned-buffer contract -------------------------

    def _drain_into(self, out) -> int:
        pend = getattr(self, "_pending", None)
        if pend is None:
            pend = self._pending = bytearray()
        n = min(len(out), len(pend))
        if n:
            out[:n] = pend[:n]
            del pend[:n]
        return n

    def _feed_step_target(self) -> int:
        # The step granularity the one-shot path feeds the frame encoder
        # with; buffering caller bytes up to it keeps the emitted blocks —
        # and therefore the archive bytes — independent of how finely the
        # caller steps (the reference gets this from libzstd's internal
        # input buffer).
        target = self._remaining_frame_size()
        if self.options.frame_size_policy.kind == "compressed":
            target = min(target, self._frame.block_max)
        return target

    def _flush_inbuf(self, final: bool) -> None:
        buf = getattr(self, "_inbuf", None)
        if not buf:
            return
        while buf:
            if self._frame is None:
                self._begin_frame()
            target = self._feed_step_target()
            if len(buf) < target and not final:
                return
            chunk = bytes(buf[:target])
            del buf[:target]
            produced = self._frame.compress(chunk)
            self._frame_c_size += len(produced)
            self._frame_d_size += len(chunk)
            self._pending += produced
            if self._is_frame_complete():
                self._pending += self._end_frame_internal()

    def compress_into(self, data, out) -> CompressionProgress:
        """One resumable byte-granular step (reference contract,
        lib/src/encode.rs:295-355): consumes part of ``data``, writes part
        of the compressed stream into the writable buffer ``out``, and
        reports both. The caller re-presents input from ``in_progress`` and
        presents a fresh/drained buffer while output remains. Frames cut
        per the policy, and the archive bytes are identical to one-shot
        ``compress()`` regardless of step sizes."""
        out = memoryview(out)
        written = self._drain_into(out)
        if len(self._pending):
            return CompressionProgress(0, written)  # caller buffer full
        data = memoryview(data)
        if len(data) == 0:
            return CompressionProgress(0, written)
        if self._frame is None:
            self._begin_frame()
        buf = getattr(self, "_inbuf", None)
        if buf is None:
            buf = self._inbuf = bytearray()
        take = min(len(data), max(self._feed_step_target() - len(buf), 1))
        buf += data[:take]
        self._flush_inbuf(final=False)
        written += self._drain_into(out[written:])
        return CompressionProgress(take, written)

    def end_frame_into(self, out) -> EpilogueProgress:
        """Resumable frame epilogue (reference: lib/src/encode.rs:438-472
        with EpilogueProgress semantics): call until ``data_left`` is
        False."""
        out = memoryview(out)
        written = self._drain_into(out)
        if not len(self._pending):
            self._flush_inbuf(final=True)
            if self._frame is not None:
                self._pending += self._end_frame_internal()
            written += self._drain_into(out[written:])
        return EpilogueProgress(written, bool(len(self._pending)))

    def _end_frame_internal(self) -> bytes:
        if self._frame is None:
            return b""
        tail = self._frame.finish()
        self._frame_c_size += len(tail)
        self._seek_table.log_frame(self._frame_c_size, self._frame_d_size)
        self._frame = None
        self._frame_c_size = 0
        self._frame_d_size = 0
        return tail

    def reset_frame(self) -> None:
        """Drop in-progress frame state, keep parameters and seek table
        (reference: lib/src/encode.rs:501-507)."""
        self._frame = None
        self._frame_c_size = 0
        self._frame_d_size = 0
        if getattr(self, "_pending", None):
            self._pending.clear()
        if getattr(self, "_inbuf", None):
            self._inbuf.clear()

    def reset_seek_table(self) -> None:
        """(reference: lib/src/encode.rs:524-526)"""
        self._seek_table = SeekTable()

    def seek_table(self) -> SeekTable:
        return self._seek_table

    def into_seek_table(self) -> SeekTable:
        st = self._seek_table
        self.reset_frame()
        return st

    @property
    def frame_progress(self) -> tuple[int, int]:
        """(uncompressed, compressed) bytes of the in-progress frame —
        the pythonic stand-in for CompressionProgress
        (reference: lib/src/encode.rs:41-92)."""
        return self._frame_d_size, self._frame_c_size


class Encoder:
    """Single-use writer-backed seekable encoder
    (reference: lib/src/encode.rs:547-800). Implements the file-object
    ``write``/``flush`` protocol the way the reference implements
    ``io::Write`` (lib/src/encode.rs:791-800)."""

    def __init__(self, options: EncodeOptions | None = None, writer=None):
        if writer is None:
            raise ValueError("Encoder requires a writer")
        self.raw = RawEncoder(options)
        self._writer = writer
        self._written = 0
        self._finished = False

    @classmethod
    def new(cls, writer) -> "Encoder":
        return cls(EncodeOptions(), writer)

    def compress(self, data) -> int:
        return self.compress_with_prefix(data, None)

    def compress_with_prefix(self, data, prefix) -> int:
        chunk = self.raw.compress_with_prefix(data, prefix)
        self._writer.write(chunk)
        self._written += len(chunk)
        return len(data)

    def end_frame(self) -> int:
        chunk = self.raw.end_frame()
        self._writer.write(chunk)
        self._written += len(chunk)
        return len(chunk)

    def finish(self, fmt: Format = Format.FOOT) -> int:
        """End the last frame, serialize the seek table to the writer, and
        return the total bytes written (reference: lib/src/encode.rs:743-775)."""
        assert not self._finished
        self.end_frame()
        table = self.raw.seek_table().to_bytes(fmt)
        self._writer.write(table)
        self._written += len(table)
        self._finished = True
        return self._written

    def written_compressed(self) -> int:
        """(reference: lib/src/encode.rs:614-617)"""
        return self._written

    def seek_table(self) -> SeekTable:
        return self.raw.seek_table()

    # file-object protocol
    def write(self, data) -> int:
        return self.compress(data)

    def flush(self) -> None:
        if hasattr(self._writer, "flush"):
            self._writer.flush()
