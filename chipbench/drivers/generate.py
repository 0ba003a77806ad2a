"""Generation traffic: a closed loop of batches through the program's greedy
generate loop (``launch/steps.py`` ``make_generate_loop``): each batch is
``batch`` requests of ``prompt_len`` seeded tokens, ``gen`` decode steps,
the next batch sent when the last one is done.

The benchmark hands the loop a model whose ``prefill`` and
``decode_step`` are the program's, each followed by a CUDA event: the time
a token of every request of the batch was ready on the device.  A request's
first token is the prefill's argmax, which the loop feeds to its first
decode step; each decode step's input is the token before it.

End to end: tokens ready inside the window over the window; the 95th
percentile of the gaps between consecutive tokens of a request, over every
request and every gap that ends inside the window.

The check takes one finished batch, drawn from the seed, and runs the plain
reference once over each request's prompt and served tokens, with the
dispatch the program ran (the prompt's token groups at the serving
capacity, then each decode step's batch of tokens as one group).  Of the
gaps by which the served tokens' logits lie below the reference's best: the
mean, and how many lie beyond ``far_off_gap`` (the widest that sound runs
read); and the latent cache the program wrote against the reference's,
layer by layer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np

from chipbench import weights as W
from chipbench.harness import (Ctx, Outcome, Stamp, free_device_memory, memory_peak, percentile,
                               program_on_path)
from chipbench.trace import Window, window_obs


def prompts(ctx: Ctx, i: int, B: int, S: int):
    import torch
    gen = W.seed_generator(ctx.seed, ctx.device, stream=1000 + i)
    return torch.randint(0, ctx.sizes.vocab_size, (B, S), generator=gen, device=ctx.device)


def run(ctx: Ctx) -> Outcome:
    import torch
    program_on_path()
    from repro_torch.launch.steps import make_generate_loop

    tr, ref, dev = ctx.traffic, ctx.reference, ctx.device
    B, S, G = tr["batch"], tr["prompt_len"], tr["gen"]
    max_len = S + G
    ctx.mark("the program's imports")
    model = ctx.model()
    params = W.make_params(model, ctx.seed, dev, ref.init_scale)
    ctx.mark("the model and its weights")
    rec: Dict[str, object] = {}
    # two windows in the first batch: the device alone (recording the host's
    # operators doubles a step's host time), then with the host's operators
    # and their input shapes, for the MoE reader's expert products
    win = Window(torch, dev, tr["trace_steps"]) if ctx.trace else None
    shaped = Window(torch, dev, tr["trace_steps"], shapes=True) if ctx.trace else None
    if win is not None:  # pay the profiler's start-up in set-up
        win.warm()
        shaped.warm()

    def prefill(p, batch, n):
        out = model.prefill(p, batch, n)
        rec["stamps"].append(Stamp(torch, dev))
        rec["cache"] = out[1]
        return out

    def decode_step(p, cache, token, pos):
        step = len(rec["inputs"])
        if rec.get("traced"):
            if step >= G // 4:
                win.tick()
            if win.done and step >= G // 2:
                shaped.tick()
        rec["inputs"].append(token)
        out = model.decode_step(p, cache, token, pos)
        rec["stamps"].append(Stamp(torch, dev))
        return out

    served = dataclasses.replace(model, prefill=prefill, decode_step=decode_step)
    loop = make_generate_loop(served, G)

    def one(i: int, traced: bool = False) -> Dict:
        rec.update(stamps=[], inputs=[], traced=traced)
        out = loop(params, {"tokens": prompts(ctx, i, B, S)}, max_len)
        if traced:
            win.stop(last=True)
            shaped.stop(last=True)
        return {"out": out, "inputs": rec["inputs"], "stamps": rec["stamps"],
                "cache": rec["cache"]}

    rec.update(stamps=[], inputs=[], traced=False)
    make_generate_loop(served, tr["warmup_gen"])(params, {"tokens": prompts(ctx, -1, B, S)},
                                                 max_len)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    origin = Stamp(torch, dev)
    batches: List[Dict] = []
    while True:
        batches.append(one(len(batches), traced=win is not None and not batches))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if time.perf_counter() >= t0 + ctx.seconds:
            break
    setup_s = t0 - ctx.t_start
    end_ms = ctx.seconds * 1e3
    ready, gaps, all_gaps = 0, [], []
    for b in batches:
        ms = [s.ms_since(origin) for s in b["stamps"]]
        ready += B * sum(1 for t in ms if t <= end_ms)
        for a, c in zip(ms, ms[1:]):
            all_gaps.append((c - a) / 1e3)
            if c <= end_ms:
                gaps.extend([(c - a) / 1e3] * B)
        b["stamps"] = None
    peak = memory_peak(torch, dev)
    metrics = {"gen_tok_s": ready / ctx.seconds if ctx.seconds else 0.0,
               "itl_p95_ms": percentile(gaps, 95) * 1e3 if gaps else float("nan"),
               "setup_s": setup_s}
    q = np.percentile(all_gaps, [0, 10, 50, 90, 100]) * 1e3 if all_gaps else []
    summary = (f"{len(batches)} batches; token gap ms min/p10/median/p90/max "
               + "/".join(f"{x:.2f}" for x in q))
    obs = {"summary": summary, "itl_s": all_gaps, "batch": B, "cache_len": S + G / 2,
           "traced_steps": win.units if win is not None else 0, **window_obs(win),
           "traced_host": shaped.traced if shaped is not None else None,
           "host_steps": shaped.units if shaped is not None else 0}

    # --- the check ------------------------------------------------------------
    pick = int(np.random.default_rng([ctx.seed, 11]).integers(0, len(batches)))
    chosen = batches[pick]
    tokens = torch.stack(chosen["inputs"] + [chosen["out"][:, -1]], dim=1)  # (B, G + 1)
    program_cache = chosen["cache"]
    consistent = bool(torch.equal(chosen["out"][:, :-1], tokens[:, 1:G]))
    prompt = prompts(ctx, pick, B, S)
    attempted = B * len(batches)
    del batches, chosen
    free_device_memory(torch)
    checks, extra = check(ctx, params, prompt, tokens, program_cache)
    checks.append(("loop_tokens_inconsistent", 0.0 if consistent else 1.0,
                   "loop_tokens_inconsistent"))
    return Outcome(metrics=metrics, attempted=attempted, failed=0, memory_peak_bytes=peak,
                   checks=checks, obs=obs, control=extra)


def serve_groups(ref, mo, B: int, S: int, G: int, device):
    """The dispatch the program ran, as token groups of the (B, S + G)
    sequence: the prompt's contiguous groups of its flat (B, S) order at
    the serving capacity, then each decode step's B tokens as one group."""
    import torch
    L = S + G
    cf = mo["serve_capacity_factor"]
    [(pidx, pc)] = ref.contiguous_groups(B * S, mo["group_tokens"], mo["top_k"], cf,
                                         mo["num_experts"], device)
    to_seq = (pidx // S) * L + pidx % S
    steps = (torch.arange(B, device=device)[None, :] * L + S
             + torch.arange(G, device=device)[:, None])
    return [(to_seq, pc), (steps, ref.capacity(B, mo["top_k"], cf, mo["num_experts"]))]


def cache_errors(program_cache, caps, keys, L: int) -> Dict[str, float]:
    """Per key, the worst layer's relative error of the program's cache
    (positions below L) against the reference's."""
    out = {k: 0.0 for k in keys}
    layer = 0
    for run in program_cache:
        for i in range(run[keys[0]].shape[0]):
            for k in keys:
                got = run[k][i][:, :L].float()
                want = caps[layer][k]
                out[k] = max(out[k], float((got - want).norm() / want.norm()))
            layer += 1
    return out


def check(ctx: Ctx, params, prompt, tokens, program_cache):
    import torch
    ref = ctx.reference
    ref.setup()
    sizes, mo = ctx.sizes, ctx.sizes.moe
    B, S = prompt.shape
    G = tokens.shape[1] - 1
    seq = torch.cat([prompt, tokens[:, :G]], dim=1)
    groups = serve_groups(ref, mo, B, S, G, ctx.device)
    tree = ref.with_layers(params)
    keys = ("ckv", "kpe") if sizes.mla else ("k", "v")

    def run(precision):
        caps: List[dict] = []
        with torch.no_grad():
            h, _ = ref.forward(sizes, tree, seq, groups, ref.Prec(precision), caps=caps)
            lg = ref.logits(sizes, tree, h[:, S - 1:], ref.Prec(precision))
        return lg, caps

    want, caps = run("fp32")
    best = want.max(-1).values
    gaps = best - want.gather(-1, tokens[..., None])[..., 0]
    errs = cache_errors(program_cache, caps, keys, S + G)
    # the widest gap does not separate the program from the control (routing
    # flips near ties reach as far as float8 does at the tail): the mean
    # gap over every served token does (PERF.md)
    far = ctx.traffic["far_off_gap"]
    checks = [("mean_gap", float(gaps.float().mean()), "mean_gap"),
              ("tokens_far_off", float((gaps > far).sum()), "tokens_far_off"),
              ("cache_rel_err", max(errs.values()), "cache_rel_err")]
    extra = dict(gap_stats(gaps), **{f"cache_rel_err.{k}": v for k, v in errs.items()},
                 cache_rel_err_by_layer=layer_errors(program_cache, caps, keys[0], S + G))
    if ctx.control:
        low, low_caps = run(ctx.control)
        top = low.argmax(-1)
        low_gaps = best - want.gather(-1, top[..., None])[..., 0]
        extra.update({"control_" + k: v for k, v in gap_stats(low_gaps).items()})
        extra["control_tokens_far_off"] = float((low_gaps > far).sum())
        extra.update({f"control_cache_rel_err.{k}": max(
            float((lc[k] - c[k]).norm() / c[k].norm()) for lc, c in zip(low_caps, caps))
            for k in keys})
        extra["control_cache_rel_err_by_layer"] = [
            float((lc[keys[0]] - c[keys[0]]).norm() / c[keys[0]].norm())
            for lc, c in zip(low_caps, caps)]
    return checks, extra


def gap_stats(gaps) -> Dict[str, float]:
    """The widest gap, and for the record its mean, 99th percentile and the
    share of positions where the served token is not the reference's best."""
    import torch
    g = gaps.flatten().float()
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p99_gap": float(torch.quantile(g, 0.99)), "not_best": float((g > 0).float().mean())}


def layer_errors(program_cache, caps, key: str, L: int) -> List[float]:
    out, layer = [], 0
    for run in program_cache:
        for i in range(run[key].shape[0]):
            want = caps[layer][key]
            out.append(float((run[key][i][:, :L].float() - want).norm() / want.norm()))
            layer += 1
    return out
