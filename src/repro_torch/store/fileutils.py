"""du / cp analogues (paper §4.1, §6.1) — serially-written application code.

These functions are deliberately written exactly as a naive serial utility
would be: ``du_dir`` loops ``fstatat`` over directory entries; ``cp_file``
loops read->write over fixed-size buffers.  Foreactor parallelizes them
*without modifying this file* — the foreaction graphs live in
:mod:`repro_torch.store.plugins`.
"""

from __future__ import annotations

from repro_torch.core.api import io
from repro_torch.core.device import Device

CP_BUF = 128 * 1024  # the paper's cp copies in 128 KB buffers


def du_dir(device: Device, root: str) -> int:
    """Total size of all entries in ``root`` (flat, like the paper's du
    benchmark directories)."""
    total = 0
    for name in io.getdents(device, root):
        st = io.fstatat(device, f"{root}/{name}")
        total += st.st_size
    return total


def cp_file(device: Device, src: str, dst: str, buf_size: int = CP_BUF) -> int:
    """Copy ``src`` to ``dst`` in ``buf_size`` chunks (read->write loop)."""
    size = io.fstatat(device, src).st_size
    sfd = io.open(device, src, "r")
    dfd = io.open(device, dst, "w")
    off = 0
    while off < size:
        n = min(buf_size, size - off)
        data = io.pread(device, sfd, n, off)
        io.pwrite(device, dfd, data, off)
        off += n
    io.fsync(device, dfd)
    io.close(device, sfd)
    io.close(device, dfd)
    return size
