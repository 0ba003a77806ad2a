"""Run one cell of the port's benchmark on this machine's card:

    python3 -m chipbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error.  Without a card
(or with fewer than the cell asks for), without the program beside it, or
with JAX or the JAX package loaded once the window has closed, it prints
no result and exits non-zero.

    python3 -m chipbench.run --workload <name> --seconds 0 --calibrate 1,2,3 \\
        [--control fp8|bf16] [--out chiprun_out/readings.jsonl]

takes the readings the limits are set from (PERF.md).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def caches_in_checkout() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels into ``build/kernels`` itself)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", metavar="SEEDS",
                    help="readings for the limits instead of a run: the numbers compared on "
                         "each of these comma-separated seeds, one JSON line a seed")
    ap.add_argument("--control", choices=("fp8", "bf16"), default="",
                    help="with --calibrate: also read the control, the reference in this "
                         "precision in the program's place (and, for training, the faults)")
    ap.add_argument("--out", help="with --calibrate: also append the lines to this file")
    args = ap.parse_args(argv)
    if (args.seed is None) == (args.calibrate is None):
        ap.error("give --seed for a run or --calibrate for readings")

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chipbench: the program (src/repro_torch) is not in {ROOT}", file=sys.stderr)
        return 2
    caches_in_checkout()
    from chipbench import spec
    try:
        cell = spec.workload(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"chipbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    torch.zeros((), device="cuda").item()  # the CUDA context, timed apart in set-up
    t_context = time.perf_counter()
    print(f"chipbench: card {card_line()}; shares are of the datasheet peaks "
          f"(989 TFLOP/s bf16, 3.35 TB/s)", file=sys.stderr)

    from chipbench.harness import Ctx

    def ctx_for(seed: int, t_start: float, **kw) -> Ctx:
        return Ctx(workload=args.workload, config=spec.config(cell["config"]),
                   traffic=spec.traffic(cell["traffic"]), seed=seed, seconds=args.seconds,
                   device=torch.device("cuda", 0), t_start=t_start, **kw)

    if args.calibrate is not None:
        return calibrate(args, ctx_for)
    ctx = ctx_for(args.seed, T_START, trace=bool(args.trace), limits=spec.limits(args.workload),
                  marks=[("torch and the CUDA context", t_context)])
    return run(ctx, cell["chips"])


def run(ctx, chips: int) -> int:
    """One run of the cell: the result line, or a non-zero exit."""
    import torch
    from chipbench import guard
    from chipbench.harness import run_cell
    outcome, result = run_cell(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    checks = result.pop("checks")
    if ctx.trace:
        obs = outcome.obs
        traced, fallback = obs.get("traced"), obs.get("fallback")
        result["profiler_retries"] = obs.get("profiler_retries", 0)
        if traced is not None:
            device.update(busy_s=traced.busy_s, window_s=traced.window_s)
            result["breakdown"] = {"device_ops": [[n, s] for n, s in traced.top_ops],
                                   "idle_gaps": [[n, s] for n, s in traced.idle_gaps]}
        elif fallback is not None:
            print(f"chipbench: the profiler saw no device event in the traced window, "
                  f"{result['profiler_retries']} retry; busy_s is the traced units' span on "
                  f"CUDA events (an upper bound), and the trace's metrics are left out",
                  file=sys.stderr)
            device.update(busy_s=fallback.span_s, window_s=fallback.window_s)
        else:
            print("chipbench: the traced window never closed", file=sys.stderr)
            return 5
    result["device"] = device
    found = guard.loaded()
    if found:
        print(f"chipbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    result["checks"] = checks
    last, parts = T_START, []
    for what, t in ctx.marks + [("warm-up", T_START + outcome.metrics["setup_s"])]:
        parts.append(f"{what} {t - last:.2f}s")
        last = t
    print(f"chipbench: set-up: {', '.join(parts)}", file=sys.stderr)
    print(f"chipbench: window: {outcome.obs.get('summary', '')}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def calibrate(args, ctx_for) -> int:
    """The numbers compared, and with ``--control`` the control's, on many
    seeds in one process; ``--seconds 0`` runs no window: the set-up steps
    (train), one batch (generate) or the checked batches (prefill), then
    the check."""
    import importlib
    import resource
    import torch
    from chipbench.harness import free_device_memory
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.calibrate.split(",")]:
        t = time.perf_counter()
        ctx = ctx_for(seed, t, trace=False, control=args.control)
        outcome = importlib.import_module(f"chipbench.drivers.{ctx.traffic['kind']}").run(ctx)
        line = json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                           "checks": {n: v for n, v, _ in outcome.checks},
                           "readings": outcome.control, "metrics": outcome.metrics,
                           "memory_peak_bytes": outcome.memory_peak_bytes,
                           "seconds": time.perf_counter() - t,
                           "host_peak_rss_gb":
                               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6},
                          default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del outcome
        free_device_memory(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
