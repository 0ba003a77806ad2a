#!/usr/bin/env python3
"""Try edited copies of the port's attention and scan kernels on one card.

    python3 tools/torch_flash_variants.py [VARIANT.cu ...]
    python3 tools/torch_flash_variants.py --kernel decode [--splits 2,4,8] [VARIANT.cu ...]
    python3 tools/torch_flash_variants.py --kernel rwkv6|mamba2 [VARIANT.cu ...]
    python3 tools/torch_flash_variants.py --kernel flash32 [VARIANT.cu ...]

Builds the package's source ("head": ``src/repro_torch/csrc/
flash_attention.cu``, ``decode_attention.cu`` with ``--kernel decode``,
``rwkv6_scan.cu`` with ``--kernel rwkv6`` or ``mamba2_scan.cu`` with
``--kernel mamba2``)
and every variant given (each a complete copy of that source with one
change, kept outside the package, e.g. under ``build/``), all at once with
the package's nvcc flags, and prints what ptxas reports for the bf16
kernels.  Each build is swapped in for the package's own by replacing
``repro_torch.kernels.build.function``; each is held in bf16 against the
plain version (2e-2) and a dense fp32 reference (atol 5e-3 + rtol 1e-2) on
``chip_smoke.py``'s cases for that kernel; those that pass are timed in
turns (a, b, ..., b, a) at the TinyLlama serve shape and Zamba2's
multi-head shape, beside ``scaled_dot_product_attention``: the flash
kernel with CUDA events (mean of 20 calls over input copies that exceed
L2), the decode kernel in device time per call (``chip_smoke.device_ms``),
once per split count of ``--splits`` (default: the wrapper's own choice).

With ``--kernel rwkv6`` each build is held in bf16 against the plain
version in fp32 on the same bf16 values (y 2e-2, final state 5e-5) at the
serve shape and on ``chip_smoke.py``'s edge cases, with the largest share
of each limit, and every build is timed in turns at the serve shape (B=8,
S=1024, H=64, K=V=64) with CUDA events, beside the CTAs an SM it holds;
one that fails the check is marked so, since a copy with a phase left
out is a timing reading whose results are wrong by design.  ``--kernel
mamba2`` does the same for the bf16 Mamba2 kernel: y within 2e-2 and the
final state within 1e-4 of the plain version in fp32 on the same bf16
values (the token recurrence for a ragged S), at zamba2-1.2b's serve
shape (B=8, S=1024, H=64, P=N=64, G=1) and ``chip_smoke.py``'s edge cases,
timed at the serve shape.  ``--kernel flash32`` takes copies of
``flash_attention.cu`` and checks their fp32 kernel (``fa_fwd_f32``)
against the plain version at 2e-5 on the same cases and at
train_100m's shape (8, 12, 4, 256, 256, 64, causal), printing the largest
error and share of the limit; it times every build that passes in three
turns (a, b, ..., b, a, a, b, ...; mean of 200 calls each) at that shape,
the same shape full, at batch 64 and at S = T = 1024, beside SDPA in
fp32.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

CASES = [(8, 32, 4, 1000, 1000, 64, True), (8, 32, 32, 1024, 1024, 64, True),
         (2, 8, 2, 130, 257, 64, True), (1, 4, 2, 130, 130, 128, True),
         (2, 4, 1, 257, 257, 256, True), (1, 2, 1, 257, 130, 64, False),
         (2, 8, 2, 128, 128, 64, True), (2, 8, 2, 129, 129, 64, True),
         (2, 32, 4, 1, 1065, 64, True), (2, 8, 2, 127, 300, 64, True),
         (2, 8, 8, 200, 200, 128, True), (1, 4, 2, 100, 60, 64, True)]
TIMED = {"serve": (8, 32, 4, 1000, 1000, 64), "mha": (8, 32, 32, 1024, 1024, 64)}
# decode: (B, H, KV, T, D), lengths; the edges of chip_smoke.py's cases
DECODE_CASES = [((8, 32, 4, 1065, 64), [1, 2, 511, 512, 513, 100, 1025, 1065]),
                ((8, 32, 32, 1089, 64), [1088] * 8), ((3, 8, 2, 300, 128), [1, 300, 157]),
                ((2, 8, 8, 77, 64), [77, 13]), ((2, 8, 2, 60, 64), [60, 17]),
                ((2, 16, 1, 150, 128), [150, 65]), ((2, 32, 1, 200, 64), [200, 33])]
DECODE_TIMED = {"serve": (8, 32, 4, 1065, 64), "mha": (8, 32, 32, 1089, 64)}
# rwkv6: (B, S, H, K, view offset), nonzero s0; the edges of chip_smoke.py's
# cases (offset 1: r, k, v are views whose rows are not 16-byte aligned)
RWKV_CASES = [(8, 1024, 64, 64, None), (2, 1, 4, 64, None), (2, 9, 4, 64, None),
              (2, 33, 4, 64, None), (2, 256, 4, 16, None), (2, 256, 4, 32, None),
              (2, 256, 4, 64, 8), (2, 33, 4, 64, 1)]
RWKV_TIMED = (8, 1024, 64, 64)
# mamba2: (B, S, H, P, G, N, view offset), nonzero h0; the edges of
# chip_smoke.py's cases (offset 1: x, B, C are views whose rows are not
# 16-byte aligned)
MAMBA_CASES = [(8, 1024, 64, 64, 1, 64, None), (2, 1, 4, 64, 1, 64, None),
               (2, 65, 4, 64, 1, 64, None), (2, 256, 4, 16, 1, 64, None),
               (2, 256, 4, 64, 1, 16, None), (2, 256, 4, 64, 1, 128, None),
               (2, 256, 4, 64, 4, 64, None), (2, 256, 4, 64, 1, 64, 8),
               (2, 65, 4, 64, 1, 64, 1)]
MAMBA_TIMED = (8, 1024, 64, 64, 1, 64)
# flash32: chip_smoke.py's fp32 cases and train_100m's shape; that shape is
# timed, and beside it the same full, at 8x the batch, and at 4x the length
FLASH32_CASES = CASES + [cs.EXAMPLES_FA, (1, 4, 4, 130, 257, 192, True),
                         (2, 8, 8, 129, 129, 192, True), (2, 6, 6, 47, 150, 64, False)]
FLASH32_TIMED = {"train_100m": cs.EXAMPLES_FA,
                 "train_100m full": cs.EXAMPLES_FA[:6] + (False,),
                 "batch 64": (64,) + cs.EXAMPLES_FA[1:],
                 "S = T = 1024": cs.EXAMPLES_FA[:3] + (1024, 1024) + cs.EXAMPLES_FA[5:]}


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("flash", "flash32", "decode", "rwkv6", "mamba2"),
                    default="flash")
    ap.add_argument("--splits", default="", help="decode: split counts to time, e.g. 2,4,8")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    source, symbol, argtypes, entry = {
        "flash": ("flash_attention.cu", "flash_attention_fwd", fa._ARGTYPES, "fa_fwd_bf16"),
        "flash32": ("flash_attention.cu", "flash_attention_fwd", fa._ARGTYPES, "fa_fwd_f32"),
        "decode": ("decode_attention.cu", "flash_decode", dec._ARGTYPES, "decode_bf16"),
        "rwkv6": ("rwkv6_scan.cu", "rwkv6_scan", r6._ARGTYPES, "rwkv6_bf16"),
        "mamba2": ("mamba2_scan.cu", "mamba2_scan", m2._ARGTYPES, "mamba2_bf16"),
    }[args.kernel]
    out_dir = ROOT / "build" / f"{args.kernel}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"head": build.CSRC / source}
    srcs.update((Path(a).stem, Path(a).resolve()) for a in args.variants)

    def compile_one(item):
        name, src = item
        lib = out_dir / f"lib{name}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        return name, lib, proc.returncode, proc.stdout + proc.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(compile_one, srcs.items()))
    print(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    fns = {}
    for name, lib, rc, log in built:
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if entry in line and "Compiling" in line:
                print(f"[ptxas {name}] {line.split(entry)[1][:12]}: "
                      + " ".join(x.strip() for x in lines[i + 2:i + 4]))
            elif "C75" in line or "error" in line:
                print(f"[ptxas {name}] {line.strip()}")
        if rc:
            print(f"[build {name}] failed")
            continue
        cdll = ctypes.CDLL(str(lib))
        fn = getattr(cdll, symbol)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = fn
        if args.kernel == "rwkv6":
            occ = cdll.rwkv6_ctas_per_sm
            occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int]
            print(f"[occupancy {name}] {occ(64)} CTAs an SM at K = V = 64", flush=True)
        elif args.kernel == "mamba2":
            occ = cdll.mamba2_ctas_per_sm
            occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
            print(f"[occupancy {name}] {occ(64, 64)} CTAs an SM at P = N = 64", flush=True)

    def use(name):
        build.function = lambda *a, **k: fns[name]

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.kernel == "rwkv6":
        _rwkv6(torch, r6, fns, use, gen)
        print(f"[card] {cs.nvidia_smi_line()}")
        return 0
    if args.kernel == "mamba2":
        _mamba2(torch, m2, fns, use, gen)
        print(f"[card] {cs.nvidia_smi_line()}")
        return 0
    if args.kernel == "flash32":
        _flash32(torch, F, fa, fns, use, gen)
        print(f"[card] {cs.nvidia_smi_line()}")
        return 0
    if args.kernel == "decode":
        splits = [int(c) for c in args.splits.split(",") if c]
        _decode(torch, F, dec, fns, use, gen, splits)
        print(f"[card] {cs.nvidia_smi_line()}")
        return 0
    passed = []
    for name in fns:
        use(name)
        bad = 0
        for B, H, KV, S, T, D, causal in CASES:
            q, k, v = cs._prefill_inputs(torch, gen, B, H, KV, S, T, D, torch.bfloat16)
            got = fa.flash_attention_fwd(q, k, v, causal)
            bad += cs.beyond(got, fa.attention_plain(q, k, v, causal), 2e-2, 2e-2)[1]
            bad += cs.beyond(got, cs.attention_f32(torch, q, k, v, causal),
                             cs.TIGHT_ATOL, cs.TIGHT_RTOL)[1]
        print(f"[check {name}] {'ok' if bad == 0 else f'FAIL ({bad} elements)'}", flush=True)
        if bad == 0:
            passed.append(name)

    for label, (B, H, KV, S, T, D) in TIMED.items():
        nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * T * D)
        ins = cs.copies_beyond_l2(
            lambda: cs._prefill_inputs(torch, gen, B, H, KV, S, T, D, torch.bfloat16), nbytes)
        times = {n: [] for n in passed}
        for name in passed + passed[::-1]:
            use(name)
            times[name].append(cs.time_ms(
                torch, lambda q, k, v: fa.flash_attention_fwd(q, k, v, True), ins))
        sdpa = cs.time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), ins)
        for name in passed:
            print(f"[time {label}] {name}: {', '.join(f'{t:.4f}' for t in times[name])} ms "
                  f"(SDPA {sdpa:.4f} ms)", flush=True)
        del ins
    print(f"[card] {cs.nvidia_smi_line()}")
    return 0


def _flash32(torch, F, fa, fns, use, gen):
    f32, tol = torch.float32, cs.TOL["float32"]
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in fp32
    passed = []
    for name in fns:
        use(name)
        bad, err, share = 0, 0.0, 0.0
        for B, H, KV, S, T, D, causal in FLASH32_CASES:
            q, k, v = cs._prefill_inputs(torch, gen, B, H, KV, S, T, D, f32)
            e, n, sh = cs.beyond(fa.flash_attention_fwd(q, k, v, causal),
                                 fa.attention_plain(q, k, v, causal), tol, tol)
            bad, err, share = bad + n, max(err, e), max(share, sh)
        print(f"[check {name}] {'ok' if bad == 0 else f'FAIL ({bad} elements)'}; max_abs_err "
              f"{err:.3e}, at most {100 * share:.0f}% of the 2e-5 limit", flush=True)
        if bad == 0:
            passed.append(name)
    for label, (B, H, KV, S, T, D, causal) in FLASH32_TIMED.items():
        nbytes = 4 * (2 * B * H * S * D + 2 * B * KV * T * D)
        ins = cs.copies_beyond_l2(
            lambda: cs._prefill_inputs(torch, gen, B, H, KV, S, T, D, f32), nbytes)
        times = {n: [] for n in passed}
        for name in passed + passed[::-1] + passed:  # a, b, ..., b, a, a, b, ...
            use(name)
            times[name].append(cs.time_ms(
                torch, lambda q, k, v: fa.flash_attention_fwd(q, k, v, causal), ins, iters=200))
        sdpa = cs.time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), ins, iters=200)
        for name in passed:
            print(f"[time {label}] {name}: {', '.join(f'{t:.4f}' for t in times[name])} ms "
                  f"(SDPA fp32 {sdpa:.4f} ms)", flush=True)
        del ins


def _decode(torch, F, dec, fns, use, gen, splits):
    passed = []
    for name in fns:
        use(name)
        bad = 0
        for (B, H, KV, T, D), length in DECODE_CASES:
            q, k, v, ln = cs._decode_inputs(torch, gen, B, H, KV, T, D, torch.bfloat16, length)
            got = dec.flash_decode(q, k, v, ln)
            bad += cs.beyond(got, dec.decode_plain(q, k, v, ln), 2e-2, 2e-2)[1]
            bad += cs.beyond(got, cs.decode_f32(torch, q, k, v, ln),
                             cs.TIGHT_ATOL, cs.TIGHT_RTOL)[1]
        print(f"[check {name}] {'ok' if bad == 0 else f'FAIL ({bad} elements)'}", flush=True)
        if bad == 0:
            passed.append(name)

    own = dec.split_count
    for label, (B, H, KV, T, D) in DECODE_TIMED.items():
        length = [T - 1] * B
        nbytes = 2 * (2 * B * H * D + 2 * KV * D * sum(length)) + 4 * B
        ins = cs.copies_beyond_l2(
            lambda: cs._decode_inputs(torch, gen, B, H, KV, T, D, torch.bfloat16, length), nbytes)
        runs = [(n, c) for n in passed for c in (splits or [own(B, KV, T)])]
        times = {r: [] for r in runs}
        for name, c in runs + runs[::-1]:
            use(name)
            dec.split_count = lambda *a, c=c: c
            times[(name, c)].append(cs.device_ms(torch, dec.flash_decode, ins)[0])
        dec.split_count = own
        sdpa_in = [(q[:, :, None], k, v, (torch.arange(T, device="cuda")[None, :]
                                          < ln[:, None])[:, None, None]) for q, k, v, ln in ins]
        sdpa = cs.device_ms(torch, lambda q, k, v, mask: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), sdpa_in)[0]
        for (name, c), t in times.items():
            print(f"[time {label}] {name} C={c}: {', '.join(f'{x:.4f}' for x in t)} ms device "
                  f"(SDPA {sdpa:.4f} ms)", flush=True)
        del ins, sdpa_in


def _rwkv6(torch, r6, fns, use, gen):
    bf = torch.bfloat16
    failed = set()
    for name in fns:
        use(name)
        bad, share_y, share_s = 0, 0.0, 0.0
        for B, S, H, K, offset in RWKV_CASES:
            args = cs._rwkv_inputs(torch, gen, B, S, H, K, bf, s0=True, offset=offset)
            got = r6.rwkv6_scan(*args)
            want = r6.rwkv6_plain(*cs._upcast(args))  # every S here is a multiple of min(64, S)
            _, n, sh = cs.beyond(got[0], want[0], 2e-2, 2e-2)
            bad, share_y = bad + n, max(share_y, sh)
            _, n, sh = cs.beyond(got[1], want[1], 5e-5, 5e-5)
            bad, share_s = bad + n, max(share_s, sh)
        print(f"[check {name}] {'ok' if bad == 0 else f'FAIL ({bad} elements)'}; at most "
              f"{100 * share_y:.0f}% of the y limit, {100 * share_s:.0f}% of the state limit",
              flush=True)
        if bad:
            failed.add(name)
    runs = list(fns)
    B, S, H, K = RWKV_TIMED
    nbytes = 3 * 2 * B * S * H * K + 4 * B * S * H * K + 2 * B * S * H * K + 4 * B * H * K * K
    ins = cs.copies_beyond_l2(lambda: cs._rwkv_inputs(torch, gen, B, S, H, K, bf)[:5], nbytes)
    times = {n: [] for n in runs}
    for name in runs + runs[::-1]:
        use(name)
        times[name].append(cs.time_ms(torch, r6.rwkv6_scan, ins))
    for name, t in times.items():
        print(f"[time serve] {name}: {', '.join(f'{x:.4f}' for x in t)} ms"
              f"{' (fails the check)' if name in failed else ''}", flush=True)


def _mamba2(torch, m2, fns, use, gen):
    from repro_torch.kernels import ref

    bf = torch.bfloat16
    failed = set()
    for name in fns:
        use(name)
        bad, share_y, share_s = 0, 0.0, 0.0
        for B, S, H, P, G, N, offset in MAMBA_CASES:
            args = cs._mamba_inputs(torch, gen, B, S, H, P, G, N, bf, h0=True, offset=offset)
            got = m2.mamba2_scan(*args)
            up = cs._upcast(args)
            want = m2.mamba2_plain(*up) if S % 128 == 0 else ref.mamba2_scan_naive(*up)
            _, n, sh = cs.beyond(got[0], want[0], 2e-2, 2e-2)
            bad, share_y = bad + n, max(share_y, sh)
            _, n, sh = cs.beyond(got[1], want[1], 1e-4, 1e-4)
            bad, share_s = bad + n, max(share_s, sh)
        print(f"[check {name}] {'ok' if bad == 0 else f'FAIL ({bad} elements)'}; at most "
              f"{100 * share_y:.0f}% of the y limit, {100 * share_s:.0f}% of the state limit",
              flush=True)
        if bad:
            failed.add(name)
    runs = list(fns)
    B, S, H, P, G, N = MAMBA_TIMED
    nbytes = 2 * 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * G * N + 4 * B * H * P * N
    ins = cs.copies_beyond_l2(
        lambda: cs._mamba_inputs(torch, gen, B, S, H, P, G, N, bf)[:5], nbytes)
    times = {n: [] for n in runs}
    for name in runs + runs[::-1]:
        use(name)
        times[name].append(cs.time_ms(torch, m2.mamba2_scan, ins))
    for name, t in times.items():
        print(f"[time serve] {name}: {', '.join(f'{x:.4f}' for x in t)} ms"
              f"{' (fails the check)' if name in failed else ''}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
