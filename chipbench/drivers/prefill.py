"""Prefill traffic: a closed loop of batches through the program's prefill
step (``launch/steps.py`` ``make_prefill_step``), each followed by the
argmax first token, read back on the host as a user receives it.

The prompt lengths cycle through ``prompt_lens``, in an order the seed
shuffles within each cycle, so every run holds the same mix; the prompts
are seeded tokens.  Time to first token is the host clock from a batch's
send to its first tokens on the host; every request of a batch shares it.

The check takes the window's first ``checked_batches`` batches (whole
cycles, so every length is among them) and runs the plain reference over
each: the mean over their first tokens of the gap by which a first
token's logit lies below the reference's best, and the KV cache the
program wrote against the reference's keys and values, layer by layer.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from chipbench import weights as W
from chipbench.drivers.generate import cache_errors, gap_stats
from chipbench.harness import (Ctx, Outcome, free_device_memory, memory_peak, percentile,
                               program_on_path)
from chipbench.trace import Window, window_obs


def lengths(seed: int, lens: List[int], n: int) -> List[int]:
    """The first n prompt lengths: each cycle a seeded order of ``lens``."""
    rng = np.random.default_rng([seed, 13])
    out: List[int] = []
    while len(out) < n:
        out.extend(int(x) for x in rng.permutation(lens))
    return out[:n]


def prompt(ctx: Ctx, i: int, B: int, S: int):
    import torch
    gen = W.seed_generator(ctx.seed, ctx.device, stream=2000 + i)
    return torch.randint(0, ctx.sizes.vocab_size, (B, S), generator=gen, device=ctx.device)


def run(ctx: Ctx) -> Outcome:
    import torch
    program_on_path()
    from repro_torch.launch.steps import make_prefill_step

    tr, ref, dev = ctx.traffic, ctx.reference, ctx.device
    B, lens, V = tr["batch"], tr["prompt_lens"], ctx.sizes.vocab_size
    ctx.mark("the program's imports")
    model = ctx.model()
    params = W.make_params(model, ctx.seed, dev, ref.init_scale)
    ctx.mark("the model and its weights")
    step = make_prefill_step(model, tr["max_len"])
    n_cycle = len(lens)
    order = lengths(ctx.seed, lens, 1 << 16)
    # the checked batches: the window's first whole cycles, each length in
    # the seed's order, so the longest is among them
    checked = tr["checked_batches"]
    need = max(checked, n_cycle + 2 * tr["trace_batches"] + 1 if ctx.trace else 0)

    def one(i: int):
        x = prompt(ctx, i, B, order[i])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = step(params, {"tokens": x})
        first = logits[:, :V].argmax(-1)
        host = first.cpu()
        return time.perf_counter() - t, host, cache

    for S in sorted(set(lens)):  # warm each length's shapes
        step(params, {"tokens": prompt(ctx, -1 - S, B, S)})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    win = Window(torch, dev, tr["trace_batches"]) if ctx.trace else None
    if win is not None:  # pay the profiler's start-up in set-up
        win.warm()
    t0 = time.perf_counter()
    ttft, kept, i = [], {}, 0
    traced_lens: List[int] = []
    while True:
        if win is not None and i >= n_cycle:
            win.tick()
            if win.running:
                if win.count == 0:  # a window (re)starts at this batch
                    traced_lens = []
                traced_lens.append(order[i])
        dt, first, cache = one(i)
        ttft.append((time.perf_counter() - t0, dt))
        if i < checked:
            kept[i] = (first, cache)
        del cache
        i += 1
        if time.perf_counter() >= t0 + ctx.seconds and i >= need:
            break
    if win is not None:
        win.stop(last=True)
    setup_s = t0 - ctx.t_start
    sent = i
    peak = memory_peak(torch, dev)
    in_window = [dt for end, dt in ttft if end <= ctx.seconds] or [ttft[0][1]]
    metrics = {"ttft_p95_ms": percentile(np.repeat(in_window, B).tolist(), 95) * 1e3,
               "setup_s": setup_s}
    by_len = {S: np.median([dt for (_, dt), L in zip(ttft, order) if L == S]) * 1e3
              for S in sorted(set(lens))}
    summary = f"{sent} batches; median ms by length " + ", ".join(
        f"{S}: {ms:.1f}" for S, ms in by_len.items())
    obs = {"summary": summary, "batch": B, "traced_lens": traced_lens, **window_obs(win),
           "ttft_s": [(order[j], dt) for j, (_, dt) in enumerate(ttft)]}
    free_device_memory(torch)

    # --- the check ------------------------------------------------------------
    ref.setup()
    sizes = ctx.sizes
    mo = sizes.moe
    tree = ref.with_layers(params)
    keys = ("ckv", "kpe") if sizes.mla else ("k", "v")
    gaps, errs, control_gaps, control_errs = [], [], [], []
    for i, (first, cache) in sorted(kept.items()):
        S = order[i]
        x = prompt(ctx, i, B, S)
        groups = ref.contiguous_groups(B * S, mo["group_tokens"], mo["top_k"],
                                       mo["serve_capacity_factor"], mo["num_experts"], dev)
        outs = {}
        for precision in ("fp32", ctx.control) if ctx.control else ("fp32",):
            caps: List[dict] = []
            with torch.no_grad():
                h, _ = ref.forward(sizes, tree, x, groups, ref.Prec(precision), caps=caps)
                outs[precision] = (ref.logits(sizes, tree, h[:, -1], ref.Prec(precision)), caps)
            del h
        want, caps = outs["fp32"]
        best = want.max(-1).values
        first = first.to(dev)
        gaps.append(best - want.gather(-1, first[:, None])[:, 0])
        errs.append(max(cache_errors(cache, caps, keys, S).values()))
        if ctx.control:
            low, low_caps = outs[ctx.control]
            top = low.argmax(-1)
            control_gaps.append(best - want.gather(-1, top[:, None])[:, 0])
            control_errs.append(max(float((lc[k] - c[k]).norm() / c[k].norm())
                                    for lc, c in zip(low_caps, caps) for k in keys))
        del outs, want, caps, cache
        kept[i] = None
        free_device_memory(torch)
    # the widest gap does not separate the program from the control (a
    # routing flip near a tie moves a first token as far as float8 does):
    # the mean over every checked first token does (PERF.md)
    stats = gap_stats(torch.cat(gaps))
    checks = [("mean_gap", stats["mean_gap"], "mean_gap"),
              ("cache_rel_err", max(errs), "cache_rel_err")]
    extra = dict(stats, cache_rel_err=max(errs), checked_lens=[order[i] for i in sorted(kept)])
    if ctx.control:
        extra.update({"control_" + k: v for k, v in gap_stats(torch.cat(control_gaps)).items()})
        extra.update(control_cache_rel_err=max(control_errs))
    return Outcome(metrics=metrics, attempted=B * sent, failed=0, memory_peak_bytes=peak,
                   checks=checks, obs=obs, control=extra)
