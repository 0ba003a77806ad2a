"""One rank of tests/test_torch_distributed.py: the port over a gloo
``DeviceMesh``.

    python tests/_torch_mesh_worker.py RANK WORLD STORE JOB

``STORE`` is a file for the process group's ``FileStore`` (no ports);
``JOB`` a JSON file: the mesh shape, the output directory and the cases.
Every rank runs every case; rank 0 writes what the test reads, as ``.npz``
files and ``results.json`` in the output directory:

* ``grads``: per (arch, profile, variant) the loss and every gradient leaf
  (gathered), the params replicated and the batch split over the data axes;
  a variant is ``off``, a remat policy (``nothing``, ``dots``),
  ``thread`` (remat ``nothing`` with the backward on another thread, as
  autograd runs a CUDA backward on its device thread: the recompute must
  still see the mesh and the profile), ``capacity`` (the MoE's capacity
  dispatch in place of the smoke config's dropless one) or ``capacity3``
  (the same with 3 experts, which do not split over "model": under tp each
  rank combines its partial sum over the experts' split hidden dim);
* ``generate``: per (arch, profile) the greedy tokens of prefill + decode;
* ``steps``: per (arch, profile) the losses and every state leaf after
  three ``make_train_step`` steps;
* ``ckpt``: the initial tinyllama train state saved by the checkpoint
  manager from the ranks;
* ``fit``: ``Trainer.fit`` runs over the mesh, each resuming from its
  checkpoint directory when one is there, and the final state's leaves.
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "deepseek-v2-236b", "zamba2-1.2b",
         "rwkv6-7b")
B, S = 4, 64            # S: one RWKV6 chunk, half a Mamba2 chunk, one loss chunk
PROMPT, GEN = 16, 4
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
DATA = dict(seq_len=32, batch_size=4, seed=5)
FIT_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=12, grad_clip=1.0, eps=1e-3)


def config(arch, variant="off"):
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    if variant == "capacity":
        return replace(cfg, moe=replace(cfg.moe, dropless=False))
    if variant == "capacity3":  # 3 experts: no EP on 2 ranks, their hidden dim split
        return replace(cfg, moe=replace(cfg.moe, dropless=False, num_experts=3))
    if variant != "off":
        cfg = replace(cfg, remat=True, remat_policy="nothing" if variant == "thread" else variant)
    return cfg


def params_of(cfg):
    from repro_torch.models import build_model

    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def batch_of(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


def loss_and_grads(model, params, batch, thread=False):
    """The loss and every gradient leaf; with ``thread`` the backward runs
    on a new thread, which starts with none of the caller's contextvars."""
    from repro_torch.tree import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss(params, batch)

    def backward():
        return torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                   materialize_grads=True)

    if not thread:
        return loss, backward()
    # autograd hands its device threads the caller's C++ thread-local state
    # (grad mode, DTensor's implicit replication), not its contextvars
    from torch.distributed.tensor import DTensor
    implicit = DTensor._op_dispatcher._allow_implicit_replication

    def on_device_thread():
        DTensor._op_dispatcher._allow_implicit_replication = implicit
        return backward()

    with ThreadPoolExecutor(1) as pool:
        return loss, pool.submit(on_device_thread).result()


def fit_trainer(root, data, steps, ckpt_every, mesh):
    """``Trainer.fit`` of the smoke TinyLlama to ``steps``, checkpoints in
    ``root`` (resumed from when one is there); returns the final state."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import OSDevice
    from repro_torch.data import DataConfig, ShardedTokenDataset, TokenBatchLoader
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    dev = OSDevice()
    cfg = config("tinyllama-1.1b")
    ds = ShardedTokenDataset(dev, [f"{data}/shard_{i:05d}.rio" for i in range(2)])
    loader = TokenBatchLoader(ds, DataConfig(**DATA), prefetch=False)
    ckpt = CheckpointManager(dev, root, num_shards=2, chunk_bytes=1 << 14)
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=0)
    out = Trainer(build_model(cfg), AdamWConfig(**FIT_OPT), loader, ckpt, mesh, tcfg).fit()
    ckpt.close()
    return out


def main(rank, world, store, job_path):
    with open(job_path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import OSDevice
    from repro_torch.launch.mesh import gather, mesh_context, replicate, shard_batch
    from repro_torch.launch.steps import (make_generate_loop, make_train_state,
                                          make_train_step)
    from repro_torch.models.common import set_sharding_profile
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(job["shape"]),
                      mesh_dim_names=("data", "model"))
    out_dir = job["out"]
    results = {"seconds": {}}

    def save(name, arrays):
        if rank == 0:
            np.savez(f"{out_dir}/{name}.npz", **{str(i): a for i, a in enumerate(arrays)})

    def np_leaves(tree):
        return [t.detach().float().numpy() for t in tree_leaves(gather(tree))]

    for arch, profile, variant in job["grads"]:
        t0 = time.perf_counter()
        cfg = config(arch, variant)
        model, params = params_of(cfg)
        with mesh_context(mesh, profile), torch.enable_grad():
            loss, grads = loss_and_grads(model, replicate(params, mesh),
                                         shard_batch(batch_of(cfg), mesh), variant == "thread")
            save(f"grads_{arch}_{profile}_{variant}", [gather(loss).detach().numpy()] +
                 [gather(g).numpy() for g in grads])
        results["seconds"][f"grads {arch} {profile} {variant}"] = time.perf_counter() - t0

    for arch, profile in job["generate"]:
        t0 = time.perf_counter()
        cfg = config(arch)
        model, params = params_of(cfg)
        prompt = {"tokens": batch_of(cfg, 2)["tokens"][:, :PROMPT]}
        with mesh_context(mesh, profile):
            toks = make_generate_loop(model, GEN)(replicate(params, mesh),
                                                  shard_batch(prompt, mesh), PROMPT + GEN + 1)
            save(f"generate_{arch}_{profile}", [gather(toks).numpy()])
        results["seconds"][f"generate {arch} {profile}"] = time.perf_counter() - t0

    for arch, profile in job["steps"]:
        t0 = time.perf_counter()
        cfg = config(arch)
        model, _ = params_of(cfg)
        opt = AdamWConfig(**OPT)
        state = make_train_state(model, opt, torch.Generator().manual_seed(0))
        step = make_train_step(model, opt)
        losses = []
        with mesh_context(mesh, profile):
            state = replicate(state, mesh)
            for i in range(3):
                state, metrics = step(state, shard_batch(batch_of(cfg, 10 + i), mesh))
                losses.append(float(gather(metrics["loss"])))
            save(f"steps_{arch}_{profile}", [np.array(losses)] + np_leaves(state))
        results["seconds"][f"steps {arch} {profile}"] = time.perf_counter() - t0

    if job.get("ckpt"):
        model, _ = params_of(config("tinyllama-1.1b"))
        state = make_train_state(model, AdamWConfig(**FIT_OPT), torch.Generator().manual_seed(0))
        with mesh_context(mesh):
            mgr = CheckpointManager(OSDevice(), job["ckpt"], num_shards=2, chunk_bytes=1 << 14)
            mgr.save(1, replicate(state, mesh), extra={"epoch": 0, "step": 1})
            mgr.close()

    for run in job.get("fit", []):
        t0 = time.perf_counter()
        set_sharding_profile(run["profile"])
        out = fit_trainer(run["root"], job["data"], run["steps"], run["ckpt_every"], mesh)
        save(f"fit_{run['name']}", [np.array(out["losses"])] + np_leaves(out["state"]))
        results["seconds"][f"fit {run['name']}"] = time.perf_counter() - t0

    if rank == 0:
        with open(f"{out_dir}/results.json", "w") as f:
            json.dump(results, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
