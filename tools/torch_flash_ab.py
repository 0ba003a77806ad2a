#!/usr/bin/env python3
"""Same-card A/B of two checkouts of the PyTorch port's flash attention.

    python3 tools/torch_flash_ab.py --base build/parent [--head .] [--out FILE]

In turns base, head, head, base, each in a fresh process over that tree's
``src``: the bf16 ``flash_attention_fwd`` kernel and PyTorch's
``scaled_dot_product_attention`` (the yardstick) at the serve shape (B=8,
H=32, KV=4, S=T=1000, D=64, causal; CUDA events, mean of 20 calls cycling
through input copies that exceed L2), then tinyllama-1.1b served by that
tree's ``launch/serve.py`` (batch 8, prompt 1000, 64 tokens: prefill ms and
decode ms per step).  Prints one JSON line per turn and writes them all to
``--out``.  Needs one CUDA card; each tree builds its own kernels.
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
SHAPE = (8, 32, 4, 1000, 1000, 64)  # B, H, KV, S, T, D


def _run(cmd, **kw) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if proc.returncode:
        raise RuntimeError(f"{cmd} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def worker(tree: Path) -> dict:
    """One turn: kernel and SDPA times, then the served tinyllama run."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs  # this checkout's timing helpers
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: no CUDA device")
    B, H, KV, S, T, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * T * D)
    inputs = cs.copies_beyond_l2(
        lambda: cs._prefill_inputs(torch, gen, B, H, KV, S, T, D, torch.bfloat16), nbytes)
    got = fa.flash_attention_fwd(*inputs[0], True)
    err = (got.float() - fa.attention_plain(*inputs[0], True).float()).abs().max().item()
    row = {"tree": str(tree), "max_abs_err_vs_plain": err,
           "kernel_ms": cs.time_ms(torch, lambda q, k, v: fa.flash_attention_fwd(q, k, v, True),
                                   inputs),
           "sdpa_ms": cs.time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True), inputs)}
    del inputs, got
    torch.cuda.empty_cache()
    out = _run([sys.executable, str(tree / "src/repro_torch/launch/serve.py"), "--arch",
                "tinyllama-1.1b", "--batch", "8", "--prompt-len", "1000", "--gen", "64"],
               env=dict(os.environ, PYTHONPATH=str(tree / "src")))
    m = re.search(r"prefill ([\d.]+) ms .*decode ([\d.]+) ms/step", out)
    if m is None:
        raise RuntimeError(f"serve.py printed no prefill line:\n{out}")
    row.update(prefill_ms=float(m.group(1)), decode_ms_per_step=float(m.group(2)))
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, help="checkout of the parent commit")
    ap.add_argument("--head", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    if args.base is None:
        ap.error("--base is required")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).strip()
    print(f"[ab] {smi}", flush=True)
    rows = []
    for role, tree in (("base", args.base), ("head", args.head), ("head", args.head),
                       ("base", args.base)):
        out = _run([sys.executable, __file__, "--worker", str(tree.resolve())])
        row = dict(json.loads(out.strip().splitlines()[-1]), role=role, card=smi)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
