"""End-to-end training entry point (PyTorch port), twin of the reference
package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 100 --batch 8 --seq 128 --data /tmp/repro_torch_data \\
        --ckpt /tmp/repro_torch_ckpt [--device cuda]

Wires every subsystem together: synthetic shard generation (once),
foreactor-speculated batch loading, the train step on one device,
write-behind foreactor-backed checkpointing with restore-on-start,
straggler accounting.  ``--kill-at N`` aborts at step N to exercise the
crash/restore path (rerun the same command to resume).  The batches hold
tokens only, so ``enc_dec`` and ``visual_stub`` configs (whisper-tiny,
qwen2-vl-7b) are refused, as the reference's driver refuses them.

Runs on the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` it raises.  The checkpoints are the reference package's
format: either package restores the other's.

Under ``torchrun`` it trains over the host mesh (one process a card, nccl;
or gloo ranks with ``--device cpu``) under the default "tp" sharding
profile, as the reference's launcher does: every rank loads the same
global batch and keeps its rows, rank 0 writes the checkpoints (resumable
on any number of ranks) and only rank 0 prints:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \
        --steps 8 --batch 4 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import io

import torch

from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
from repro_torch.configs import get_config
from repro_torch.core import Foreactor, OSDevice
from repro_torch.data import (DataConfig, ShardedTokenDataset, TokenBatchLoader,
                              write_synthetic_dataset)
from repro_torch.launch.mesh import launch_mesh
from repro_torch.launch.serve import resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data", default="/tmp/repro_torch_data")
    ap.add_argument("--ckpt", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--records-per-shard", type=int, default=256)
    ap.add_argument("--no-restore", action="store_true")
    ap.add_argument("--serial-ckpt", action="store_true",
                    help="disable write-behind checkpointing (save blocks "
                         "the training thread)")
    ap.add_argument("--kill-at", type=int, default=0,
                    help="simulate a node failure at this step")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="retention: newest N step-checkpoints to keep")
    ap.add_argument("--keep-spaced", type=int, default=0,
                    help="retention: newest M time-spaced anchor checkpoints")
    ap.add_argument("--spacing-s", type=float, default=3600.0,
                    help="retention: minimum seconds between anchors")
    ap.add_argument("--delta-every", type=int, default=0,
                    help="write K delta checkpoints between full saves "
                         "(0 = every save full)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    dev, mesh = launch_mesh(resolve_device(args.device))
    if mesh is None:
        _train(args, dev)
        return
    quiet = torch.distributed.get_rank() != 0
    try:
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            _train(args, mesh)
    finally:
        torch.distributed.destroy_process_group()


def _train(args, dev) -> None:
    """The run on ``dev``: a device, or the mesh of the ranks."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.enc_dec is not None or cfg.visual_stub:  # as the reference's driver refuses
        raise SystemExit("train driver covers LM archs: its batches hold tokens only, "
                         "no audio frames or visual embeddings")
    model = build_model(cfg)
    device = OSDevice()
    fa = Foreactor(device=device, backend="io_uring", depth=32)

    dcfg = DataConfig(seq_len=args.seq, batch_size=args.batch, seed=0)
    shard0 = f"{args.data}/shard_00000.rio"
    ranked = torch.distributed.is_initialized()
    if not ranked or torch.distributed.get_rank() == 0:  # one writer
        try:
            device.fstatat(shard0)
        except FileNotFoundError:
            print(f"[train] generating synthetic dataset under {args.data}")
            write_synthetic_dataset(device, args.data, dcfg, args.shards,
                                    args.records_per_shard, cfg.vocab_size)
    if ranked:
        torch.distributed.barrier()
    ds = ShardedTokenDataset(
        device, [f"{args.data}/shard_{i:05d}.rio" for i in range(args.shards)])
    loader = TokenBatchLoader(ds, dcfg, fa=fa)

    ckpt = CheckpointManager(device, args.ckpt, fa=fa, num_shards=4)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                      total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         log_every=10, restore=not args.no_restore,
                         write_behind=not args.serial_ckpt,
                         retention=CheckpointPolicy(
                             keep_last=args.keep_last,
                             keep_spaced=args.keep_spaced,
                             spacing_s=args.spacing_s),
                         delta_every=args.delta_every)
    trainer = Trainer(model, opt, loader, ckpt, dev, tcfg)

    if args.kill_at:
        orig = loader.load

        def killing_load(e, s):
            if e * loader.steps_per_epoch + s >= args.kill_at:
                raise RuntimeError(f"simulated node failure at step {args.kill_at}")
            return orig(e, s)

        loader.load = killing_load

    out = trainer.fit()
    mode = "serial" if args.serial_ckpt else "write-behind"
    print(f"[train] done: step {out['final_step']}  "
          f"final loss {out['losses'][-1]:.4f}  "
          f"mean step {1e3 * (out['mean_step_s'] or 0):.0f}ms  "
          f"stragglers {out['stragglers']}  "
          f"ckpt[{mode}] {out['ckpt_saves']} saves, "
          f"{out['ckpt_wait_s']:.2f}s stalled")
    print("[train] phases, median ms host / device: " + ", ".join(
        f"{name} {ms['host']:.1f}" + (f" / {ms['device']:.1f}" if "device" in ms else "")
        for name, ms in out["phase_ms"].items()))
    loader.close()
    ckpt.close()
    fa.shutdown()


if __name__ == "__main__":
    main()
