"""End-to-end driver through the PyTorch port, twin of
``examples/train_100m.py``: train a ~100M-param llama-family model for a
few hundred steps through the full stack (foreactor data pipeline, train
step, write-behind checkpointing, restore-on-restart).

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300] [--device cpu]

This is the runnable ~100M config; for a quick sanity run use --tiny.
Both configs are the reference driver's, field for field (fp32 parameters
and compute, remat off).  Runs on the card unless ``--device cpu`` is
given; with no card and no ``--device cpu`` it raises.  Under ``torchrun``
it trains over the host mesh, as ``repro_torch.launch.train`` does (rank 0
writes the dataset and the checkpoints, and alone prints):

    torchrun --nproc-per-node 2 examples/train_100m_torch.py --tiny --device cpu
"""

import argparse
import contextlib
import io

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import Foreactor, OSDevice
from repro_torch.data import (DataConfig, ShardedTokenDataset, TokenBatchLoader,
                              write_synthetic_dataset)
from repro_torch.launch.mesh import launch_mesh
from repro_torch.launch.serve import resolve_device
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--tiny", action="store_true")
ap.add_argument("--workdir", default="/tmp/repro_torch_100m")
ap.add_argument("--device", default="cuda", help="torch device to train on (default cuda)")
args = ap.parse_args()

if args.tiny:
    cfg = ModelConfig(name="llama-tiny", vocab_size=2048, d_model=128,
                      n_layers=4, n_heads=8, n_kv_heads=2, d_ff=352,
                      param_dtype="float32", compute_dtype="float32",
                      loss_chunk=64, remat=False)
    seq, batch = 128, 8
else:
    # ~100M params: 12 x (d=768, ff=2048) + 32k vocab
    cfg = ModelConfig(name="llama-100m", vocab_size=32000, d_model=768,
                      n_layers=12, n_heads=12, n_kv_heads=4, d_ff=2048,
                      param_dtype="float32", compute_dtype="float32",
                      loss_chunk=128, remat=False)
    seq, batch = 256, 8

dev, mesh = launch_mesh(resolve_device(args.device))
rank = 0 if mesh is None else torch.distributed.get_rank()
model = build_model(cfg)
device = OSDevice()
fa = Foreactor(device=device, backend="io_uring", depth=32)
dcfg = DataConfig(seq_len=seq, batch_size=batch, seed=0)
if rank == 0:  # one writer
    try:
        device.fstatat(f"{args.workdir}/data/shard_00000.rio")
    except FileNotFoundError:
        write_synthetic_dataset(device, f"{args.workdir}/data", dcfg, 4, 128,
                                cfg.vocab_size)
if mesh is not None:
    torch.distributed.barrier()
ds = ShardedTokenDataset(device,
                         [f"{args.workdir}/data/shard_{i:05d}.rio" for i in range(4)])
loader = TokenBatchLoader(ds, dcfg, fa=fa)
ckpt = CheckpointManager(device, f"{args.workdir}/ckpt", fa=fa, num_shards=4)
opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
trainer = Trainer(model, opt, loader, ckpt, dev if mesh is None else mesh,
                  TrainerConfig(steps=args.steps, ckpt_every=50, log_every=10))
try:
    with contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext():
        out = trainer.fit()
        n_params = sum(x.numel() for x in tree_leaves(out["state"]["params"]))
        print(f"params: {n_params/1e6:.1f}M  loss {out['losses'][0]:.3f} -> "
              f"{out['losses'][-1]:.3f} over {out['final_step']} steps")
    loader.close()
    ckpt.close()
    fa.shutdown()
finally:
    if mesh is not None:
        torch.distributed.destroy_process_group()
