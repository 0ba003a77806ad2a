"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, under ``<checkout>/build/kernels/`` (listed in
``.gitignore``).  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
All sources are built on first use, in parallel, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module, and
there is no ``nvcc`` on a machine without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable[..., int]] = {}
build_seconds: float = 0.0   # wall time of the last build_all() that compiled
ptxas_log: Dict[str, str] = {}  # per source: what ptxas reported (registers, spills)


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; return name -> .so path."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(src) for name, src in sources().items()}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        ptxas_log[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, todo[name])  # atomic: a reader never sees half a library
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def function(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, building all
    sources on first use; declared once, with ``argtypes`` and an ``int``
    (``cudaError_t``) result."""
    fn = _fns.get((name, symbol))
    if fn is None:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all()[name]))
        fn = getattr(_libs[name], symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[(name, symbol)] = fn
    return fn
