"""The mesh path on the card: a one-rank NCCL group and its (1, 1) host
mesh against meshless, bit for bit (chip_smoke.py's ``mesh`` phase at a
smaller size).

Marked ``cuda``: skips without a GPU.  Imports no JAX, so it runs on a
machine with the card:
PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_mesh.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import gather, make_host_mesh, mesh_context, replicate, shard_batch
from repro_torch.launch.steps import make_generate_loop, make_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

B, PROMPT, GEN = 4, 128, 8
# full width, a few layers: each path's kernels at their serve head dims;
# zamba2's first 7 blocks hold its shared attention block
PATHS = (("tinyllama-1.1b", 2), ("zamba2-1.2b", 7), ("rwkv6-7b", 2))


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh("cuda")
    finally:
        dist.destroy_process_group()


def _config(arch, layers):
    cfg = get_config(arch)
    return replace(cfg, n_layers=layers, block_pattern=cfg.blocks[:layers])


def _equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", PATHS)
def test_cuda_served_over_the_mesh_bit_for_bit(mesh, arch, layers):
    cfg = _config(arch, layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT))
                              .astype(np.int32)).cuda()
    generate = make_generate_loop(model, GEN)
    ops.reset_launch_counts()
    want = generate(params, {"tokens": tokens}, PROMPT + GEN + 1)
    want_counts = ops.launch_counts()
    ops.reset_launch_counts()
    with mesh_context(mesh):
        got = gather(generate(replicate(params, mesh), shard_batch({"tokens": tokens}, mesh),
                              PROMPT + GEN + 1))
    assert torch.equal(got, want)
    assert ops.launch_counts() == want_counts and any(want_counts.values())


@pytest.mark.cuda
def test_cuda_train_step_over_the_mesh_bit_for_bit(mesh):
    cfg = _config("tinyllama-1.1b", 2)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(1)
    seqs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 257)).astype(np.int32)).cuda()
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    a = make_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0))
    b = replicate(make_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0)),
                  mesh)
    ops.reset_launch_counts()
    for _ in range(2):
        a, met_a = step(a, batch)
    want_counts = ops.launch_counts()
    ops.reset_launch_counts()
    with mesh_context(mesh):
        for _ in range(2):
            b, met_b = step(b, shard_batch(batch, mesh))
        met_b, b = gather(met_b), gather(b)
    assert ops.launch_counts() == want_counts and want_counts["flash_attention_fwd"] > 0
    for k in ("loss", "grad_norm"):
        assert _equal(met_a[k], met_b[k]), k
    assert all(_equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.cuda
def test_cuda_remat_recompute_sees_the_mesh_context(mesh):
    """Autograd runs the backward on its device thread: the recompute under
    ``remat`` still sees the forward's mesh and profile."""
    import threading

    from repro_torch.models.common import active_mesh, get_sharding_profile, remat

    seen = []

    def f(x):
        seen.append((active_mesh() is mesh, get_sharding_profile(), threading.get_ident()))
        return (x * 2).sin()

    x = torch.ones(8, device="cuda", requires_grad=True)
    with mesh_context(mesh, "fsdp"):
        remat(f, x, use_reentrant=False).sum().backward()
    torch.cuda.synchronize()
    assert len(seen) == 2 and all(s[:2] == (True, "fsdp") for s in seen)
