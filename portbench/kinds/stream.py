"""The command line's path without files: the ``Encoder`` fed
``write_bytes`` pieces and finished, then a ``Decoder`` read in
``read_bytes`` pieces to the end."""

from __future__ import annotations

import io

from portbench import driver


class Loop(driver.Loop):
    def round(self) -> None:
        zt, cfg, n = self.zt, self.cfg, len(self.data)
        step = self.mix["write_bytes"]
        view = memoryview(self.data)
        with self.rec.span("encode", n) as c:
            sink = io.BytesIO()
            opts = (zt.EncodeOptions().with_backend("tpu").with_device(self.device)
                    .with_frame_size_policy(zt.FrameSizePolicy.uncompressed(cfg["frame_size"]))
                    .with_checksum_flag(cfg["checksum"]).with_compression_level(cfg["level"]))
            enc = opts.into_encoder(sink)
            for i in range(0, n, step):
                enc.write(view[i:i + step])
            enc.finish(self.fmt)
            arc = sink.getvalue()
            c.out_bytes = len(arc)
        self.keep_archive(arc)
        with self.rec.span("decode", len(arc)) as c:
            dec = (zt.DecodeOptions(zt.BytesWrapper(arc)).with_backend("tpu")
                   .with_device(self.device).into_decoder())
            parts = []
            while True:
                piece = dec.read(self.mix["read_bytes"])
                if not piece:
                    break
                parts.append(piece)
            out = b"".join(parts)
            c.out_bytes = len(out)
        self.compare(out, 0, n)
