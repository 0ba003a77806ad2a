"""Fixed-record shard files.

Format::

    [magic 'RIO1'][u32 record_size][u32 count][pad to 16] records...

Records live at ``HEADER + i * record_size``.  This is the on-disk format
the training data pipeline reads (one record = one tokenized sequence) and
a convenient substrate for regular-I/O-loop experiments (paper §4.1).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional

from repro_torch.core.api import Foreactor, io
from repro_torch.core.device import Device
from repro_torch.core.patterns import build_write_file_graph

MAGIC = b"RIO1"
HEADER = 16
_HDR = struct.Struct("<4sII4x")


class RecordShardWriter:
    def __init__(self, device: Device, path: str, record_size: int):
        self.device = device
        self.path = path
        self.record_size = record_size
        self.count = 0
        self.fd = io.open(device, path, "w")
        io.pwrite(device, self.fd, _HDR.pack(MAGIC, record_size, 0), 0)

    def append(self, payload: bytes) -> int:
        if len(payload) != self.record_size:
            raise ValueError(f"record must be exactly {self.record_size} bytes")
        off = HEADER + self.count * self.record_size
        io.pwrite(self.device, self.fd, payload, off)
        self.count += 1
        return self.count - 1

    def close(self) -> None:
        io.pwrite(self.device, self.fd, _HDR.pack(MAGIC, self.record_size, self.count), 0)
        io.fsync(self.device, self.fd)
        io.close(self.device, self.fd)


class RecordShardReader:
    def __init__(self, device: Device, path: str):
        self.device = device
        self.path = path
        self.fd = io.open(device, path, "r")
        magic, self.record_size, self.count = _HDR.unpack(io.pread(device, self.fd, HEADER, 0))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad shard magic {magic!r}")

    def offset_of(self, i: int) -> int:
        return HEADER + i * self.record_size

    def read_record(self, i: int) -> bytes:
        if not (0 <= i < self.count):
            raise IndexError(i)
        return io.pread(self.device, self.fd, self.record_size, self.offset_of(i))

    def __len__(self) -> int:
        return self.count

    def __iter__(self) -> Iterator[bytes]:
        for i in range(self.count):
            yield self.read_record(i)

    def close(self) -> None:
        io.close(self.device, self.fd)


def write_shard(device: Device, path: str, records: List[bytes],
                fa: Optional[Foreactor] = None) -> None:
    """Write one complete shard file.

    Without ``fa`` this is the original serial path (header, appends,
    header rewrite, fsync, close).  With a Foreactor it becomes one
    ``write_file`` foreaction chain: the create is staged (undoable), the
    final header and every record pre-issue as guaranteed writes, fsync and
    close ride behind as harvest barriers, and the file publishes onto
    ``path`` at the close — a crashed or aborted writer leaves no partial
    shard in the committed namespace.  Final bytes are identical either
    way (the speculative path just writes the true record count once
    instead of rewriting the header at close).
    """
    if not records:
        raise ValueError("empty shard")
    record_size = len(records[0])
    if fa is None:
        w = RecordShardWriter(device, path, record_size)
        for r in records:
            w.append(r)
        w.close()
        return
    for r in records:
        if len(r) != record_size:
            raise ValueError(f"record must be exactly {record_size} bytes")
    writes = [(_HDR.pack(MAGIC, record_size, len(records)), 0)]
    writes += [(r, HEADER + i * record_size) for i, r in enumerate(records)]
    fa.register("write_file", build_write_file_graph)

    @fa.wrap("write_file", lambda: {"path": path, "writes": writes})
    def _write_all():
        fd = io.open(device, path, "w")
        for data, off in writes:
            io.pwrite(device, fd, data, off)
        io.fsync(device, fd)
        io.close(device, fd)

    _write_all()
