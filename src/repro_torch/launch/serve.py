"""Serving driver: prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen 16] [--device cuda]

``--arch`` takes every id of the reference: tinyllama-1.1b, zamba2-1.2b,
rwkv6-7b, gemma-2b, gemma-7b, command-r-35b, qwen2-vl-7b,
granite-moe-3b-a800m, deepseek-v2-236b (whose full 60 layers do not fit
one card), whisper-tiny.  A ``visual_stub`` config (qwen2-vl-7b) gets
seeded random patch embeddings (batch, 8, d_model) in place of a vision
frontend, spliced over the first 8 prompt slots; an ``enc_dec`` config
(whisper-tiny) gets seeded random fp32 frame embeddings (batch,
n_audio_ctx, d_model) in place of the audio conv stem.  On
the CPU the SSM archs follow the reference's chunked scans, which need the
prompt to be a multiple of the chunk (128 for Mamba2, 64 for RWKV6) or
shorter than it; the CUDA kernels take any prompt length.  Prints the warm
generate time and tok/s, the launch counts, then prefill ms and decode ms
per step.

Runs on the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` it raises.  Weights are random, from a seeded
``torch.Generator`` on the device.  The first generate call includes the
kernels' build; the second is the warm time.

Under ``torchrun`` it serves over the host mesh, as the reference's launcher
serves under ``mesh_context(make_host_mesh())``: one process a card (nccl),
or with ``--device cpu`` gloo ranks; every rank makes the same weights and
prompts, the weights replicated, the prompts' rows split over the ranks
(``--batch`` divisible by the world size), and only rank 0 prints:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import gather, launch_mesh, mesh_context, replicate, shard_batch
from repro_torch.launch.steps import make_generate_loop, make_prefill_step
from repro_torch.models import build_model


N_IMG = 8  # visual embeddings a prompt for visual_stub configs, as the reference's serve.py


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="tinyllama-1.1b, zamba2-1.2b, rwkv6-7b, gemma-2b, gemma-7b, "
                         "command-r-35b, qwen2-vl-7b, granite-moe-3b-a800m, deepseek-v2-236b "
                         "or whisper-tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev, mesh = launch_mesh(resolve_device(args.device))
    if mesh is None:
        _serve(args, dev, None)
        return
    try:
        with mesh_context(mesh):
            _serve(args, dev, mesh)
    finally:
        torch.distributed.destroy_process_group()


def _serve(args, dev: torch.device, mesh) -> None:
    say = print if mesh is None or torch.distributed.get_rank() == 0 else _quiet
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.visual_stub:
        batch["visual_embeds"] = torch.randn((args.batch, N_IMG, cfg.d_model), generator=gen,
                                             device=dev)
    if cfg.enc_dec is not None:
        batch["frames"] = torch.randn((args.batch, cfg.enc_dec.n_audio_ctx, cfg.d_model),
                                      generator=gen, device=dev)

    if mesh is not None:
        params, batch = replicate(params, mesh), shard_batch(batch, mesh)
    generate = make_generate_loop(model, args.gen)
    max_len = args.prompt_len + args.gen + 1
    t0 = time.perf_counter()
    toks = generate(params, batch, max_len)
    _sync(dev)
    t_first = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = gather(generate(params, batch, max_len))
    _sync(dev)
    t_warm = time.perf_counter() - t0
    tput = args.batch * args.gen / t_warm
    say(f"[serve] generated {tuple(toks.shape)} tokens; "
          f"first(incl build)={t_first:.2f}s warm={t_warm*1e3:.0f}ms "
          f"({tput:.0f} tok/s)")
    if cfg.visual_stub:
        say(f"[serve] visual embeddings {tuple(batch['visual_embeds'].shape)} over the "
              f"first {N_IMG} prompt slots")
    if cfg.enc_dec is not None:
        say(f"[serve] audio frame embeddings {tuple(batch['frames'].shape)} through the "
              f"encoder")
    say("[serve] sample:", toks[0, :12].tolist())
    say("[serve] kernel launches (warm run):", ops.launch_counts())
    prefill = make_prefill_step(model, max_len)
    t_prefill = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, batch)
        _sync(dev)
        t_prefill.append(time.perf_counter() - t0)
    pf = min(t_prefill)
    say(f"[serve] prefill {pf*1e3:.2f} ms (min of 3), "
          f"decode {(t_warm - pf)*1e3/args.gen:.3f} ms/step (warm generate less prefill)")


def _quiet(*args, **kwargs) -> None:
    pass


if __name__ == "__main__":
    main()
