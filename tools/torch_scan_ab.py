#!/usr/bin/env python3
"""Same-card A/B of two checkouts of one of the PyTorch port's scan kernels.

    python3 tools/torch_scan_ab.py --base build/parent [--head .] [--kernel rwkv6|mamba2]
                                   [--out FILE]

In turns base, head, head, base, each in a fresh process over that tree's
``src``:
- the bf16 kernel at its serve shape (``rwkv6_scan``: r/k/v (8, 1024, 64,
  64) bf16, w fp32, rwkv6-7b's; ``mamba2_scan``: x (8, 1024, 64, 64),
  B/C (8, 1024, 1, 64) bf16, dt fp32, zamba2-1.2b's; CUDA events, mean of
  20 calls cycling through input copies that exceed L2), and its largest
  difference from the plain version in fp32 on the same bf16 values (y and
  final state);
- the architecture that runs it (rwkv6-7b or zamba2-1.2b) served by that
  tree's ``launch/serve.py`` (batch 8, prompt 1024, 4 tokens): prefill ms
  (min of 3).
The timing helpers are this checkout's ``chip_smoke.py`` for both trees.
Prints one JSON line per turn and writes them all to ``--out``.  Needs one
CUDA card; each tree builds its own kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# kernel: (serve shape, architecture served); rwkv6 B, S, H, K = V; mamba2
# B, S, H, P, G, N
KERNELS = {"rwkv6": ((8, 1024, 64, 64), "rwkv6-7b"),
           "mamba2": ((8, 1024, 64, 64, 1, 64), "zamba2-1.2b")}


def _run(cmd, **kw) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if proc.returncode:
        raise RuntimeError(f"{cmd} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def worker(tree: Path, kernel: str) -> dict:
    """One turn: the kernel's time at the serve shape, then its
    architecture's prefill."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs  # this checkout's timing helpers
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6

    if not torch.cuda.is_available():
        raise SystemExit("torch_scan_ab: no CUDA device")
    shape, arch = KERNELS[kernel]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    if kernel == "rwkv6":
        B, S, H, K = shape
        scan, plain = r6.rwkv6_scan, r6.rwkv6_plain
        make = lambda: cs._rwkv_inputs(torch, gen, B, S, H, K, bf)[:5]  # noqa: E731
        nbytes = 3 * 2 * B * S * H * K + 4 * B * S * H * K + 2 * B * S * H * K \
            + 4 * B * H * K * K
    else:
        B, S, H, P, G, N = shape
        scan, plain = m2.mamba2_scan, m2.mamba2_plain
        make = lambda: cs._mamba_inputs(torch, gen, B, S, H, P, G, N, bf)[:5]  # noqa: E731
        nbytes = 2 * 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * G * N \
            + 4 * B * H * P * N
    args = make()
    got = scan(*args)
    want = plain(*cs._upcast(args))
    row = {"tree": str(tree), "kernel": kernel,
           "max_abs_err_y": (got[0].float() - want[0]).abs().max().item(),
           "max_abs_err_state": (got[1] - want[1]).abs().max().item()}
    del args, got, want
    inputs = cs.copies_beyond_l2(make, nbytes)
    row["kernel_ms"] = cs.time_ms(torch, scan, inputs)
    del inputs
    torch.cuda.empty_cache()
    out = _run([sys.executable, str(tree / "src/repro_torch/launch/serve.py"), "--arch", arch,
                "--batch", "8", "--prompt-len", "1024", "--gen", "4"],
               env=dict(os.environ, PYTHONPATH=str(tree / "src")))
    m = re.search(r"prefill ([\d.]+) ms", out)
    if m is None:
        raise RuntimeError(f"serve.py printed no prefill line:\n{out}")
    row[f"{arch.split('-')[0]}_prefill_ms"] = float(m.group(1))
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, help="checkout of the parent commit")
    ap.add_argument("--head", type=Path, default=ROOT)
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="rwkv6")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.kernel)))
        return 0
    if args.base is None:
        ap.error("--base is required")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).strip()
    print(f"[ab] {smi}", flush=True)
    rows = []
    for role, tree in (("base", args.base), ("head", args.head), ("head", args.head),
                       ("base", args.base)):
        out = _run([sys.executable, __file__, "--worker", str(tree.resolve()),
                    "--kernel", args.kernel])
        row = dict(json.loads(out.strip().splitlines()[-1]), role=role, card=smi)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
