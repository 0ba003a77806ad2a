"""Training traffic: the program's trainer (``runtime/trainer.py``
``Trainer.fit``) over its speculated loader (``TokenBatchLoader``) reading
seeded token records from shard files, AdamW, no checkpoint manager.

Set-up makes the weights and the shard files from the seed, builds one
trainer whose model hands it those weights, and lets ``fit`` run its first
``setup_steps`` steps; the window is the steps that follow, for
``--seconds`` seconds, ended at the first step boundary past the deadline by
the benchmark's wrapper around the loader (as ``launch/train.py --kill-at``
ends a run), so every step runs through the same ``fit`` call.

The check follows the first ``checked_steps`` steps with the plain
reference (``chipbench/reference``), from the same weights and the same
records in the data order the loader documents.  Compared: the first
gradient of each leaf (a layer's slice of a stacked leaf) as AdamW took it
in, read back from its first moment after one step, element by element
(the median leaf's difference); each leaf's change after the checked
steps, read from the fp32 master weights before the next step overwrites
them; and the rows the loader delivered, exactly.  Read beside them: each
step's loss and each leaf's first-gradient norm, whose gaps no control or
fault reaches far enough to bound (PERF.md).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import struct
import tempfile
import time
from typing import Dict, List

import numpy as np

from chipbench import weights as W
from chipbench.harness import Ctx, Outcome, free_device_memory, memory_peak, program_on_path
from chipbench.trace import Window, window_obs

RECORD_HEADER = struct.Struct("<4sII4x")  # the record shard format: magic, record size, count


class WindowClosed(Exception):
    pass


def write_shards(root: str, toks: np.ndarray, shards: int) -> List[str]:
    """Record shard files (``store/recordio.py``'s documented layout): a
    16-byte header, then the records of int32 tokens back to back."""
    per = len(toks) // shards
    paths = []
    for s in range(shards):
        path = os.path.join(root, f"shard_{s:05d}.rio")
        part = toks[s * per:(s + 1) * per]
        with open(path, "wb") as f:
            f.write(RECORD_HEADER.pack(b"RIO1", part.shape[1] * 4, len(part)))
            f.write(part.astype("<i4").tobytes())
        paths.append(path)
    return paths


def data_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The loader's documented record order of an epoch (a copy of the
    formula, so that the check does not read it from the program)."""
    return np.random.default_rng((seed, epoch)).permutation(n)


def layer_leaves(tree: Dict, ref) -> Dict[str, object]:
    """name -> tensor for every leaf, the stacked layer runs split into
    their layers' slices; the names are the reference's."""
    out = {}
    for l, lp in enumerate(ref.layers_of(tree["layers"]) if "layers" in tree
                           else tree["layer_list"]):
        for path, t in W.leaves(lp):
            out[".".join(["layer", str(l), *map(str, path)])] = t
    for key in ("embed", "final_norm", "lm_head"):
        for path, t in W.leaves(tree[key]):
            out[".".join([key, *map(str, path)])] = t
    return out


def _norms(named: Dict[str, object]) -> Dict[str, float]:
    import torch
    vals = torch.stack([t.float().norm() for t in named.values()]).tolist()
    return dict(zip(named, vals))


def run(ctx: Ctx) -> Outcome:
    import torch
    program_on_path()
    from repro_torch.core import Foreactor, OSDevice
    from repro_torch.data import DataConfig, ShardedTokenDataset, TokenBatchLoader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    tr, ref, dev = ctx.traffic, ctx.reference, ctx.device
    B, S = tr["batch"], tr["seq_len"]
    V = ctx.sizes.vocab_size
    n_rec = tr["shards"] * tr["records_per_shard"]
    setup_steps, checked = tr["setup_steps"], tr["checked_steps"]
    opt = dict(tr["optimizer"])
    b1 = opt["b1"]

    rng = np.random.default_rng([ctx.seed, 7])
    toks = rng.integers(0, V, size=(n_rec, S + 1), dtype=np.int32)
    data_seed = int(rng.integers(0, 2 ** 31))
    workdir = tempfile.mkdtemp(prefix="chipbench-train-")
    paths = write_shards(workdir, toks, tr["shards"])
    device = OSDevice()
    fa = Foreactor(device=device, backend=tr["foreactor"]["backend"],
                   depth=tr["foreactor"]["depth"])
    loader = TokenBatchLoader(ShardedTokenDataset(device, paths),
                              DataConfig(seq_len=S, batch_size=B, seed=data_seed), fa=fa)
    spe = loader.steps_per_epoch

    ctx.mark("the program's imports")
    model = ctx.model()
    params = W.make_params(model, ctx.seed, dev, ref.init_scale)
    ctx.mark("the model and its weights")
    first = W.clone_tree(params)  # the weights before step 1, for the change
    model = dataclasses.replace(model, init=lambda gen: params)
    opt_cfg = AdamWConfig(**opt)

    class BenchTrainer(Trainer):
        state = None

        def _init_or_restore(self):
            out = super()._init_or_restore()
            BenchTrainer.state = out[0]
            return out

    trainer = BenchTrainer(model, opt_cfg, loader, None, dev,
                           TrainerConfig(steps=1 << 40, ckpt_every=0, log_every=0, seed=0,
                                         restore=False))
    orig_load = loader.load
    obs = {"loader_wait_s": [], "boundaries": []}
    # two windows: the device alone, then with the host's ranges (the plain
    # backward's) for their device time
    win = Window(torch, dev, tr["trace_steps"]) if ctx.trace else None
    ranged = Window(torch, dev, tr["trace_steps"], host=True) if ctx.trace else None
    if win is not None:  # pay the profiler's start-up in set-up
        win.warm()
        ranged.warm()
    trace_at = setup_steps + 2
    marks: Dict[str, object] = {"delivered": {}}

    def load(e, s):
        g = e * spe + s
        now = time.perf_counter()
        state = BenchTrainer.state
        if g == 1:
            m = layer_leaves(state["opt"]["m"], ref)
            marks["grad"] = {k: v / (1 - b1) for k, v in _norms(m).items()}
            marks["grad_elems"] = {k: (v / (1 - b1)).to("cpu", torch.bfloat16) for k, v in m.items()}
        if g == checked:
            master, before = layer_leaves(state["opt"]["master"], ref), layer_leaves(first, ref)
            marks["change"] = {k: float((master[k] - before[k].float()).norm()) for k in master}
            first.clear()
        if g == setup_steps:
            marks["t0"], marks["g0"] = now, g
            marks["spec0"] = (fa.total_stats.pre_issued, fa.total_stats.served_async)
        if win is not None and g >= trace_at:
            if now >= marks["t0"] + ctx.seconds:
                win.stop(last=True)
                ranged.stop(last=True)
            else:
                win.tick()
                if win.done:
                    ranged.tick()
            now = time.perf_counter()
        if "t0" in marks:
            obs["boundaries"].append((g, now, win is not None and (win.running or ranged.running)))
            if now >= marks["t0"] + ctx.seconds:
                marks["t1"], marks["g1"] = now, g
                raise WindowClosed
        t = time.perf_counter()
        out = orig_load(e, s)
        if "t0" in marks:
            obs["loader_wait_s"].append(time.perf_counter() - t)
        if g < checked:
            marks["delivered"][g] = np.array(out["tokens"], copy=True)
        return out

    loader.load = load
    try:
        trainer.fit()
    except WindowClosed:
        pass
    finally:
        loader.close()
        fa.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)
    spec1 = (fa.total_stats.pre_issued, fa.total_stats.served_async)
    steps = marks["g1"] - marks["g0"]
    window_s = marks["t1"] - marks["t0"]
    events = trainer.events
    losses = [ev.loss for ev in events[:checked]]
    peak = memory_peak(torch, dev)
    setup_s = marks["t0"] - ctx.t_start
    metrics = {"train_tok_s": steps * B * S / window_s if steps else 0.0, "setup_s": setup_s}
    window_steps = [ev.seconds for ev in events[setup_steps:marks["g1"]]]
    if window_steps:
        q = np.percentile(window_steps, [0, 10, 50, 90, 100]) * 1e3
        obs["summary"] = (f"{steps} steps in {window_s:.3f} s; step ms min/p10/median/p90/max "
                          + "/".join(f"{x:.1f}" for x in q))
    obs.update(steps=steps, window_s=window_s,
               spec=(spec1[0] - marks["spec0"][0], spec1[1] - marks["spec0"][1]),
               traced_steps=win.units if win is not None else 0, batch=B, seq=S,
               traced_host=ranged.traced if ranged is not None else None, **window_obs(win))
    BenchTrainer.state = None
    del trainer, params, model
    free_device_memory(torch)

    # --- the check: the plain reference over the first steps -------------
    order = data_order(data_seed, 0, n_rec)
    rows = [toks[order[g * B:(g + 1) * B]] for g in range(checked)]
    mismatched = sum(int((marks["delivered"][g] != rows[g][:, :-1]).any(axis=1).sum())
                     for g in range(checked))
    got = reference_steps(ctx, rows, "fp32", keep=bool(ctx.control),
                          against=marks.pop("grad_elems"))
    checks, extra = compare(losses, marks["grad"], marks["change"], got)
    extra.update(got["elems"])
    checks.append(("grad_rel_diff_median", got["elems"]["grad_rel_diff_median"],
                   "grad_rel_diff_median"))
    checks.append(("rows_mismatched", float(mismatched), "rows_mismatched"))
    extra.update(losses=losses, ref_losses=got["losses"])
    if ctx.control:
        # the control: the reference in a lower precision in the program's
        # place; and the fault "half of the batch left out, the mean over
        # the rest", planted in the reference put in the program's place
        for tag, (r, precision) in {"control_": (rows, ctx.control),
                                    "fault_half_": ([x[: len(x) // 2] for x in rows], "fp32")
                                    }.items():
            low = reference_steps(ctx, r, precision, against=got["grad_t"], ref_norms=got)
            extra.update({tag + k: v for k, v in
                          compare(low["losses"], low["grad"], low["change"], got)[1].items()})
            extra.update({tag + k: v for k, v in low["elems"].items()})
    return Outcome(metrics=metrics, attempted=steps, failed=0, memory_peak_bytes=peak,
                   checks=checks, obs=obs, control=extra)

def reference_steps(ctx: Ctx, rows: List[np.ndarray], precision: str, keep: bool = False,
                    against=None, ref_norms=None) -> dict:
    """The reference's first steps from the seeded weights: losses, each
    leaf's clipped first gradient norm, each leaf's change norm.  With
    ``keep`` also its clipped first gradients (bf16, on the host);
    ``against``: another side's first gradients on the host, compared leaf
    by leaf (:func:`compare_elems`) with this run's, under the norms of
    ``ref_norms`` where this run is not the reference."""
    import torch
    from chipbench.reference.adamw import AdamW

    ref, dev, tr = ctx.reference, ctx.device, ctx.traffic
    ref.setup()
    model = ctx.model()
    bf16 = W.make_params(model, ctx.seed, dev, ref.init_scale)
    tree = {"embed": {"tok": bf16["embed"]["tok"].float()},
            "final_norm": {"scale": bf16["final_norm"]["scale"].float()},
            "lm_head": bf16["lm_head"].float(),
            "layer_list": [W.rebuild(lp, lambda _, t: t.float())
                           for lp in ref.layers_of(bf16["layers"])]}
    del bf16
    free_device_memory(torch)
    named = layer_leaves(tree, ref)
    start = {k: v.detach().clone() for k, v in named.items()}
    leaves = list(named.values())
    for t in leaves:
        t.requires_grad_(True)
    opt = AdamW(tr["optimizer"], leaves)
    sizes = ctx.sizes
    mo = sizes.moe
    pr = ref.Prec(precision)
    losses, grad = [], None
    for rec in rows:
        batch = torch.from_numpy(rec.astype(np.int64)).to(dev)
        tokens, labels = batch[:, :-1], batch[:, 1:]
        groups = ref.contiguous_groups(tokens.numel(), mo["group_tokens"], mo["top_k"],
                                       mo["capacity_factor"], mo["num_experts"], dev)
        loss = ref.loss(sizes, tree, tokens, labels, groups, pr)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        clipped = opt.update([g.detach() for g in grads])
        if grad is None:
            grad = dict(zip(named, torch.stack([g.norm() for g in clipped]).tolist()))
            grad_d = dict(zip(named, clipped))
        del grads, clipped, loss
    change = dict(zip(named, torch.stack([(named[k].detach() - start[k]).norm()
                                          for k in named]).tolist()))
    out = {"losses": losses, "grad": grad, "change": change}
    if against is not None:
        out["elems"] = compare_elems(against, grad_d, (ref_norms or out)["grad"])
    if keep:
        out["grad_t"] = {k: g.to("cpu", torch.bfloat16) for k, g in grad_d.items()}
    del grad_d
    del tree, named, start, leaves, opt
    free_device_memory(torch)
    return out


def compare(losses, grad, change, ref: dict):
    """The number compared, the worst leaf's change norm gap; beside it the
    worst step's loss gap and the worst leaf's first-gradient norm gap;
    each a share of the reference's (of the leaf, or of the median leaf where that is larger).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    g_med = float(np.median(list(ref["grad"].values())))
    c_med = float(np.median(list(ref["change"].values())))
    grad_gap, grad_leaf = max((abs(grad[k] - v) / max(v, g_med), k) for k, v in ref["grad"].items())
    moving = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
    change_gap, change_leaf = max((abs(change[k] - ref["change"][k]) / max(ref["change"][k], c_med), k)
                                  for k in moving)
    # the loss gap and the first gradient's norm gap have no upper reading
    # (PERF.md): read, not compared
    checks = [("change_norm_gap", change_gap, "change_norm_gap")]
    return checks, {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "grad_leaf": grad_leaf,
                    "change_norm_gap": change_gap, "change_leaf": change_leaf,
                    "excluded_leaves": len(ref["grad"]) - len(moving)}


def compare_elems(got, want, norms) -> dict:
    """Element by element: each leaf's relative difference between one
    side's clipped first gradient (``got``, on the host) and the other's
    (``want``, on the device): the norm of the difference over the
    reference's norm of the leaf (``norms``), or of the median leaf where
    that is larger; for the worst and the median leaf.  Float8 rounding
    moves a leaf's norm only in second order, but each of its elements by a
    few percent: the median leaf's difference separates it where the norm
    gaps do not (PERF.md)."""
    med = float(np.median(list(norms.values())))
    diffs = sorted(float((got[k].to(want[k].device).float() - want[k]).norm()) / max(norms[k], med)
                   for k in want)
    return {"grad_rel_diff_worst": diffs[-1], "grad_rel_diff_median": diffs[len(diffs) // 2]}
