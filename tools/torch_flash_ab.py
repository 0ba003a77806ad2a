#!/usr/bin/env python3
"""Same-card A/B of two checkouts of the PyTorch port's attention kernels.

    python3 tools/torch_flash_ab.py --base build/parent [--head .] [--out FILE]

In turns base, head, head, base, each in a fresh process over that tree's
``src``:
- the bf16 ``flash_attention_fwd`` kernel and PyTorch's
  ``scaled_dot_product_attention`` (the yardstick) at the prefill serve
  shape (B=8, H=32, KV=4, S=T=1000, D=64, causal; CUDA events, mean of 20
  calls cycling through input copies that exceed L2);
- the bf16 ``flash_decode`` kernel and SDPA with a prebuilt mask at
  TinyLlama's GQA decode shape (B=8, H=32, KV=4, T=1065, length 1064) and
  Zamba2's MHA one (B=8, H=KV=32, T=1089, length 1088): device time per
  call from the profiler's device events and host µs per call
  (``chip_smoke.device_ms``);
- tinyllama-1.1b served by that tree's ``launch/serve.py`` (batch 8, prompt
  1000, 64 tokens: prefill ms and decode ms per step).
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
SHAPE = (8, 32, 4, 1000, 1000, 64)  # B, H, KV, S, T, D
DECODE = {"gqa": (8, 32, 4, 1065, 64), "mha": (8, 32, 32, 1089, 64)}  # B, H, KV, T, D


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
    from repro_torch.kernels import decode_attention as dec
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
    for name, (B, H, KV, T, D) in DECODE.items():
        length = [T - 1] * B
        nbytes = 2 * (2 * B * H * D + 2 * KV * D * sum(length)) + 4 * B
        inputs = cs.copies_beyond_l2(lambda: cs._decode_inputs(
            torch, gen, B, H, KV, T, D, torch.bfloat16, length), nbytes)
        sdpa_in = [(q[:, :, None], k, v, (torch.arange(T, device="cuda")[None, :]
                                          < ln[:, None])[:, None, None])
                   for q, k, v, ln in inputs]
        got = dec.flash_decode(*inputs[0])
        row[f"decode_{name}_max_abs_err_vs_plain"] = (
            got.float() - dec.decode_plain(*inputs[0]).float()).abs().max().item()
        row[f"decode_{name}_kernel_ms"], row[f"decode_{name}_host_us"] = cs.device_ms(
            torch, dec.flash_decode, inputs)
        row[f"decode_{name}_sdpa_ms"] = cs.device_ms(
            torch, lambda q, k, v, mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), sdpa_in)[0]
        del inputs, sdpa_in, got
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
