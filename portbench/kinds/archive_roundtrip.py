"""``archive.compress_archive`` of the whole input from host bytes to the
archive (frames and the serialised seek table), then the seek table parsed
back and ``archive.decompress_archive`` of that archive to host bytes."""

from __future__ import annotations

from portbench import driver


class Loop(driver.Loop):
    def round(self) -> None:
        zt, cfg, n = self.zt, self.cfg, len(self.data)
        with self.rec.span("encode", n) as c:
            blob, st = zt.archive.compress_archive(
                self.data, frame_size=cfg["frame_size"], checksum=cfg["checksum"],
                level=cfg["level"], device=self.device)
            arc = blob + st.to_bytes(self.fmt)
            c.out_bytes = len(arc)
        self.keep_archive(arc)
        with self.rec.span("decode", len(arc)) as c:
            table = zt.SeekTable.from_bytes(arc, self.fmt)
            out = zt.archive.decompress_archive(
                arc, table, verify_checksum=cfg["checksum"], device=self.device)
            c.out_bytes = len(out)
        self.compare(out, 0, n)
