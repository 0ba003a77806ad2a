#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. device  — name and power limit (nvidia-smi), torch and CUDA versions;
             requires compute capability 9.0; turns TF32 off.
2. build   — compiles ``src/repro_torch/csrc/*.cu`` with nvcc, one process
             per source, all at once.
3. kernels — the attention kernels against their plain torch versions on
             the card, at the serve shape of every main path that attends
             (taken from its config: TinyLlama's GQA, Zamba2's MHA, and
             gemma-7b's, gemma-2b's, qwen2-vl-7b's, command-r-35b's and
             granite-moe-3b-a800m's; deepseek-v2-236b's MLA prefill, MHA
             at D = 192 with V zero-padded from 128, whose padded output
             columns must stay zeros; whisper-tiny's encoder, full at S =
             T = 1500, its cross-attention, full at S = 383 against T =
             1500, its decoder, causal at 383, and its decode),
             ragged ones, the edges of the flash kernel's tiles (S = T =
             128 and 129, S = 1 against T = 1065, S = 127 against T = 300,
             KV = H at D = 128, D = 192 at S = T = 129 with padded V and
             at S = 130 against T = 257) and of the decode kernel's split of the
             cache (lengths 1, 2 and T, one below, at and one above a slice
             boundary, trailing CTAs empty, one CTA per pair, G = 1 to 32
             at D = 64 and 128, a small ragged cache at D = 256; at every
             dense path's serve shape random lengths and the split's
             edges), in bf16 and fp32; the bf16 kernels also against dense
             fp32 references on the same bf16 values, with a tight limit
             that planted faults must break (the decode faults at every
             decode serve shape, the flash faults at TinyLlama's and
             deepseek-v2's, and at whisper-tiny's full shapes a causal
             mask and the last key tile dropped); then timings of kernel,
             plain version
             and the PyTorch library call (SDPA, a yardstick the port never
             calls): CUDA events for the flash kernel, profiler device time
             per call (and host µs per call) for the decode kernel, at the
             serve shapes.  A serve shape without every reading fails.
4. scans   — the Mamba2 and RWKV6 scan kernels against their plain versions
             (the chunked references) and the token recurrences: serve
             shape, nonzero initial state, ragged S, G > 1, strongly
             decaying channels (w down to -20); the edges of each bf16
             kernel's chunk (Mamba2 S = 1, 63, 65, 1000; RWKV6 S = 1, 7, 9,
             33 and its sub-blocks), head sizes below the serve shape's
             (Mamba2 P = 16, 32, N = 16, 32, 128, G = H; RWKV6 K = V = 16,
             32), and views of one projection (rows 16-byte aligned and
             not); planted faults (state carry dropped, Mamba2's diagonal
             s = t dropped from W, RWKV6's decay one position late, bonus u
             omitted, pairs across sub-blocks dropped) that the limits must
             reject; readings of each bf16 state with its decayed operand
             (Mamba2's B~, RWKV6's k~) rounded to one bf16 part; CTAs an SM
             of both bf16 kernels; timings of kernel and plain version.
5. main    — ten paths, each full width in bf16 with random weights from
             a seed, serving batch 8 and 64 greedy tokens through
             ``make_generate_loop``: tinyllama-1.1b (prompt 1000),
             zamba2-1.2b and rwkv6-7b (prompt 1024, a multiple of the
             reference's scan chunks; rwkv6 at 16 of its 32 layers),
             gemma-7b, gemma-2b, qwen2-vl-7b (8
             seeded visual embeddings), command-r-35b (prompt 1000;
             36 of its 40 layers, the depth in ``PATHS``, printed),
             granite-moe-3b-a800m (prompt 1000; 16 of its 32 layers;
             40 experts top-8 on the capacity path) and deepseek-v2-236b (prompt 1000; 8 of its
             60 layers: the dense first layer and 7 MoE layers of 160
             experts top-6 with 2 shared; MLA: the flash kernel in
             prefill, latent-space decode without a kernel) and
             whisper-tiny (prompt 383; 4 encoder and 4 decoder layers at
             full depth over 1500 seeded frame embeddings a request: the
             flash kernel full in the encoder and the cross-attention,
             causal in the decoder; the decode kernel in the decoder's
             self-attention, the cross decode plain).  Each checks its parameter leaves, launch
             counts, token range, its peak memory (within 90% of the
             card), and the kernel path's logits (prefill and every decode
             step) and final cache against the plain path's, teacher
             forced (on the MoE path also the shares of (layer, token)
             pairs whose top-k experts and kept assignments differ, and of
             the assignments dropped); then the same check on paths with
             planted faults, which it must reject (on the MLA path a
             fault of its latent decode too; on whisper-tiny the encoder
             run causal, and, read only, the cross-attention without its
             last 28 frames); and profiles one
             prefill and a window of decode steps (on the MoE paths split
             into expert products, dispatch/combine and attention, on
             the MLA path the MLA blocks' share, on whisper-tiny the
             encoder, the decoder's cross-attention and the rest).
6. grads   — the three autograd Functions of ``kernels/ops.py`` (kernel
             forward, plain backward) against plain autograd in fp32 at
             small shapes, at the reference's custom-VJP limits (attention
             also as MLA calls it: D = 192, V padded from 128, scale
             192^-0.5; and full with S = 100 against T = 300, as a
             cross-attention calls it), and a backward that drops one
             input's gradient, which must fail.
7. train   — six paths in bf16 with random weights from a seed, through
             ``make_train_state``/``make_train_step``: tinyllama-1.1b and
             zamba2-1.2b full (batch 8, seq 1024), rwkv6-7b at full width
             with 4 of its 32 layers (batch 8), gemma-2b full (tied head;
             batch 6, the largest that fits), granite-moe-3b-a800m at full
             width with 16 of its 32 layers under the ``dots`` remat policy
             (batch 8), whisper-tiny full (batch 8 x 448 tokens, 1500
             frame embeddings a sequence; the int8 gradient codec over a
             step's gradients on the card, bit for bit against the CPU).
             Each takes 4 steps on one
             repeated batch (step ms, tok/s, peak memory within 85% of the
             card; the loss must be finite and fall, the MoE path prints
             its aux loss beside the xent; launches a step
             against the count the config gives), profiles one step (the device time of each plain
             backward), holds a ``dots`` step's loss and grads against
             remat off (bit for bit, or within twice the spread of two
             ``dots`` runs), then takes one step from that state on the kernel
             path, the plain path, the plain path in the kernels'
             arithmetic (the noise floor) and the kernel path with a
             planted backward fault: loss, grad norm and the new master
             per leaf must lie within twice the floor, the fault beyond
             (where a copy of the state fits beside a step: not gemma-2b).
8. trainer — the walkthrough at full width through
             ``repro_torch.runtime.Trainer`` (tinyllama-1.1b in bf16 at 11
             of its 22 layers for time, ``TRAINER_LAYERS``, batch
             8 x 1024, synthetic shards read through ``OSDevice`` and
             ``Foreactor(backend="io_uring", depth=32)``; free disk and
             MemAvailable printed first, the depth cut if three
             checkpoints do not fit): two continuous runs of 8 steps (the
             noise floor), a run with write-behind saves every 4 steps
             killed at step 6 (emergency save), a second trainer that
             restores and finishes at 8, whose state must equal the
             continuous run's (bit for bit if the two continuous runs
             agree so, else within twice their spread per leaf), a
             validated restore of the newest checkpoint; step ms with and
             without a save in flight, the training thread's stall, save
             and restore seconds, GB/s, loader ms, peak host RSS and card
             memory.  Then at the smoke size a resume from the write-behind
             checkpoint, which must hold, and the same with a planted
             snapshot of views, which must be rejected.
9. dryrun  — the dry-run (``repro_torch.launch.dryrun``) against the card:
             a one-rank NCCL group (``HashStore``, no address) and its (1, 1)
             ``DeviceMesh``, on which tinyllama-1.1b's bf16 params are laid
             out by ``param_specs`` (every local shard equal to its tensor
             bit for bit, their bytes the dry-run's resident bytes); the
             reckoned resident bytes of its train state (batch 8 x 1024)
             and of its params (prefill, batch 8 x 1000) against the bytes
             they take on the card, within the allocator's rounding of
             each leaf; the traced temporary peak (plain path) beside the
             real step's (kernel path); the counted dot FLOPs beside
             ``model_flops`` and the model-FLOP share of the datasheet peak
             at the median step time; then three production cells planned
             on 16x16 (HBM a device against the card's, the roofline's
             dominant term and bound).
10. mesh   — the multi-device slice on a one-rank NCCL group
             (``HashStore``) and its (1, 1) host mesh
             (``launch.mesh.mesh_context``): tinyllama-1.1b, zamba2-1.2b
             and rwkv6-7b (4 of its 32 layers) served at full width over the
             mesh against meshless (batch 8, prefill and 16 greedy tokens:
             the logits of every step bit for bit, the tokens, the launch
             counts equal), the decode step's overhead (median of 5,
             alternating); the trainer at full width over tinyllama's first
             4 layers, batch 8 x 1024: three steps meshless against two
             over the mesh, a save from the mesh, and a second trainer over
             the mesh that restores it and takes the third (losses and
             every state leaf bit for bit, launches equal); one train step's
             loss and grad norm bit for bit and its overhead (median of 5);
             every kernel launched on the mesh path; then tinyllama-1.1b
             train_4k planned on 16x16 with the collectives one device
             issues, counted over a fake 256-rank group (bytes by kind, the
             roofline's collective term).
11. iostore — the paper's case studies on this machine's own disk (under
             ``build/iostore``, removed at the end; ``OSDevice(direct=True)``,
             the io_uring backend at depth 32), each serially and through its
             foreaction graph: du over 10,000 files in 100 directories, and
             ``wrap(auto_graph=True)``, which must mine du and enable; cp of a
             1 GiB file in 128 KiB buffers (CRC32 equal); B+-tree bulk Load
             of 1,000,000 keys at degree 510 (both files equal) and a full
             Scan; an LSM store of 1,000,000 keys of 256 B in 16 overlapping
             L0 tables, 2,000 seeded Gets serially, through ``lsm_get`` and
             through ``multi_get`` (every answer the oracle's; p50, p99 and
             totals printed); then the I/O server's CLI in three runs, each
             of which must exit 0 with ``errors=0``.  Every time is printed
             beside the nvidia-smi line, the file system and its block
             device, the free disk and the direct-open counts.  Times are
             reported, not gated.
12. report — one ``kernels`` JSON line, the nvidia-smi line, and the result
             line ``{"ok": true, "device": {...}}`` last.  Every phase's
             seconds are printed (``[time]``).

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX or of the reference
package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# the port, from the checkout this script sits in (after any tree a caller put first)
sys.path.append(str(SRC))
try:
    from repro_torch.analysis.roofline import HW
except ModuleNotFoundError:  # not in a checkout of the repository: main() refuses to run
    HW = None

# the card's one record: the H100 SXM's datasheet peaks (NVIDIA), for the bound columns
H100 = HW() if HW else None
L2_BYTES = 50 * 2 ** 20

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # atol = rtol, as the reference's kernel tests
# bf16 flash and decode kernels against dense fp32 references on the same
# bf16 values: what is left is the kernel's own rounding of P (before P V)
# and of the output to bf16, each at most a relative 2^-8.  atol + rtol * |want|.
TIGHT_ATOL, TIGHT_RTOL = 5e-3, 1e-2

# main paths: full-width serving of each ported architecture, (arch, prompt,
# layers kept (None: all)).  command-r-35b keeps 36 of its 40 layers: with
# its bf16 weights (1.409 GB a layer), five copies of its KV cache (the
# served run's and the teacher-forced check's), the 8.4 GB fp32 copy of the
# tied head and prefill's activations it peaked at 71.74 GB of the card's
# 85.02 GB (NVIDIA H100 80GB HBM3, 700.00 W).  granite-moe-3b-a800m (6.75
# GB of bf16 weights at full depth) keeps 16 of its 32 layers for time: its
# host-bound decode made its path the longest of the served ones (73.2-88.8
# s), in a script that reached 1095.9 s of its 1200.  rwkv6-7b keeps 16 of its 32
# layers (full width) for time: with granite's paths the whole script took
# 945.6 s of the 1200 s it may take (NVIDIA H100 80GB HBM3, 700.00 W), and
# rwkv6's served path, host-bound at 3,769 device ops a decode step, was
# the longest of them (73.7 s).  deepseek-v2-236b keeps 8 of its 60 layers
# (full width): its dense first layer and 7 MoE layers.  A MoE layer is 7.94
# GB of bf16 weights (160 experts of 3 x 5120 x 1536, the MLA projections
# and the shared experts), the dense layer 0.68 GB, the embedding and the
# untied head 2.10 GB: 58.4 GB at 8 layers.  While the stack is filled, one
# layer's fp32 init copies add ~12 GB beside it; prefill adds the head's
# fp32 copy (2.1 GB), the expert buffers at the serve capacity 3.0 (125
# groups of 64 tokens, C = 7: 160 x 875 rows of 5120, 1.4 GB in and 1.4 GB
# out) and q, k, padded V and o at (8, 128, 1000, 192) (0.4 GB each).  At 8
# layers the init peaked at 69.2 GB and the phase at 74.35 GB (the plain
# and fp32 attention of the teacher-forced checks) of the card's 85.02 GB
# (NVIDIA H100 80GB HBM3, 700.00 W); a ninth layer's 7.94 GB would take it
# past SERVE_MEM_SHARE.  whisper-tiny serves at full depth (4 encoder and 4
# decoder layers, 1500 frame embeddings a request) with a prompt of 383: a
# prompt, 64 tokens and the slot after them fill its published text
# context of 448.  Every path's peak must stay within SERVE_MEM_SHARE of
# the card.
PATHS = (("tinyllama-1.1b", 1000, None), ("zamba2-1.2b", 1024, None), ("rwkv6-7b", 1024, 16),
         ("gemma-7b", 1000, None), ("gemma-2b", 1000, None), ("qwen2-vl-7b", 1000, None),
         ("command-r-35b", 1000, 36), ("granite-moe-3b-a800m", 1000, 16),
         ("deepseek-v2-236b", 1000, 8), ("whisper-tiny", 383, None))
SERVE_MEM_SHARE = 0.9
BATCH, GEN = 8, 64
PROMPT = PATHS[0][1]  # the attention kernels' main serve shapes are TinyLlama's
N_IMG = 8  # visual embeddings a prompt for visual_stub configs (qwen2-vl-7b)
# bf16 logits and cache, kernel path vs plain path, teacher forced:
# atol + rtol * |plain| (TinyLlama, on which the limit was set).  Every
# other path is held to twice its measured noise floor instead (phase_main),
# beside the elementwise kernel checks at its serve shapes (phase 3); this
# limit is still read there.  On gemma-7b it flagged 62 logits at 119% of
# it while the two paths' greedy tokens agreed on 512 of 512.  The two
# paths round in different places (fp32
# scores in the attention kernel where the plain path rounds them to bf16;
# fp32 C.B in the Mamba2 kernel where the plain path rounds it to bf16);
# 22-38 bf16 layers carry that difference to the logits, whose scale is ~1
# for these random weights.  The planted faults of phase 5 must break this
# limit.
LIMIT_ATOL, LIMIT_RTOL = 0.1, 0.05
FIXED_LIMIT_PATHS = ("tinyllama-1.1b",)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def time_ms(torch, fn, inputs, iters=20, warmup=3):
    """Mean ms per call over ``iters`` calls, cycling through ``inputs``
    (copies of the arguments that together exceed L2, so each call reads
    its operands from device memory as it would in the model)."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_beyond_l2(make, nbytes):
    return [make() for _ in range(max(1, math.ceil(3 * L2_BYTES / nbytes)))]


def beyond(got, want, atol, rtol):
    """(max abs error, elements beyond atol + rtol * |want|, largest share of
    that limit any element uses); NaN counts as beyond."""
    want = want.float()
    diff = (got.float() - want).abs()
    lim = atol + rtol * want.abs()
    return (diff.max().item(), (~(diff <= lim)).sum().item(),
            (diff / lim).nan_to_num(math.inf).max().item())


def assert_close(name, got, want, atol, rtol=None):
    rtol = atol if rtol is None else rtol
    err, bad, share = beyond(got, want, atol, rtol)
    log(f"[kernels] {name}: max_abs_err={err:.3e} atol={atol:g} rtol={rtol:g} "
        f"(uses {100 * share:.0f}% of the limit) "
        f"{'ok' if bad == 0 else f'FAIL ({bad} elements)'}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its reference "
                             f"(max_abs_err {err:.3e}, atol {atol:g}, rtol {rtol:g})")
    return err


def attention_f32(torch, q, k, v, causal, shift=0, drop_from=None):
    """Dense fp32 attention with an explicit mask, none of the port's code:
    row i sees key j iff j <= i + T - S + shift (when causal) and
    j < drop_from; a row that sees no key is zeros.  ``shift`` and
    ``drop_from`` plant faults for the controls."""
    q, k, v = q.float(), k.float(), v.float()
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    S, T = q.shape[2], k.shape[2]
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    if causal:
        vis = j <= i + T - S + shift
    else:
        vis = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if drop_from is not None:
        vis = vis & (j < drop_from)
    p = torch.softmax((q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5)
                      .masked_fill(~vis, -math.inf), dim=-1)
    return torch.where(vis.any(-1, keepdim=True), p, 0.0) @ v


def decode_f32(torch, q, k, v, length, keep=None, slices=None):
    """Dense fp32 decode attention with an explicit mask, none of the port's
    code: the heads of batch b see key j iff j < length[b] (and keep[b, j]);
    a row that sees no key is zeros.  ``keep`` and ``slices`` plant faults
    for the controls: with ``slices`` (B, T) slice numbers, every slice's
    terms are taken against its own max and summed without the correction
    to a common one."""
    q, k, v = q.float(), k.float(), v.float()
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    vis = torch.arange(k.shape[2], device=q.device)[None, :] < length[:, None].long()
    if keep is not None:
        vis = vis & keep
    s = torch.einsum("bhd,bhtd->bht", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~vis[:, None], -math.inf)
    m = s.amax(-1, keepdim=True).expand_as(s)
    if slices is not None:
        m = torch.full_like(s, -math.inf)
        for r in slices.unique().tolist():
            sel = (slices == r)[:, None]
            m = torch.where(sel, s.masked_fill(~sel, -math.inf).amax(-1, keepdim=True), m)
    e = torch.exp(s - torch.where(m == -math.inf, 0.0, m))  # masked keys: exp(-inf) = 0
    return torch.einsum("bht,bhtd->bhd", e, v) / e.sum(-1, keepdim=True).clamp_min(1e-30)


def device_ms(torch, fn, inputs, iters=30, warmup=3):
    """(device ms per call, host µs per call).  Device time is every kernel
    and copy that ``iters`` calls launched, summed from torch.profiler's
    device-side events (the card's own kernel times, so the host's issue
    rate does not count), over the calls.  Host time is the issue time of
    the same calls without the profiler and without waiting for the card.
    ``inputs`` cycle as in time_ms."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU)
    if busy_us <= 0:
        raise RuntimeError("device_ms: the profiler saw no device time")
    return busy_us / iters / 1e3, host_us


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / H100.hbm_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    smi = nvidia_smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0) (Hopper), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(nvcc wall {build.build_seconds:.1f} s): {', '.join(sorted(libs))}")
    for name, out in sorted(build.ptxas_log.items()):
        for line in out.splitlines():
            if "entry function" in line:  # the mangled kernel name, less its namespace
                log(f"[build] {name}: " + re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", line.split("'")[1])
                    .split("Ev", 1)[0])
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return libs


def _prefill_inputs(torch, gen, B, H, KV, S, T, D, dtype, dv=None):
    """(B,S,H,D) activations seen as (B,H,S,D), as the model hands them over;
    with ``dv``, V's columns from dv on are zeros (MLA's V, padded to D)."""
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype)
    if dv is not None:
        v[..., dv:] = 0
    return q, k, v.transpose(1, 2)


def _decode_inputs(torch, gen, B, H, KV, T, D, dtype, length):
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    # the cache is stored (B,T,KV,D) and read as (B,KV,T,D)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    return q, k, v, torch.as_tensor(length, dtype=torch.int32, device="cuda")


def _serve_shapes():
    """The attention kernels' shapes on every main path that attends, from
    its config: decode (B, H, KV, T, D) at the last step's cache (None for
    MLA, whose decode attends in the latent space, plain torch), prefill
    {label: (B, H, KV, S, T, D, causal)} (the arch; the encoder-decoder's
    three: the encoder's and the cross-attention's full, the decoder's
    causal), and the width of V before its zero padding (MLA: v_head; else
    None)."""
    from repro_torch.configs import get_config

    out = {}
    for arch, prompt, _ in PATHS:
        cfg = get_config(arch)
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dec = (BATCH, H, KV, prompt + GEN + 1, D)
        if cfg.enc_dec is not None:
            T = cfg.enc_dec.n_audio_ctx
            out[arch] = (dec, {f"{arch} encoder": (BATCH, H, KV, T, T, D, False),
                               f"{arch} cross-attention": (BATCH, H, KV, prompt, T, D, False),
                               f"{arch} decoder": (BATCH, H, KV, prompt, prompt, D, True)},
                         None)
        elif {"attn", "shared_attn"} & set(cfg.blocks):
            out[arch] = (dec, {arch: (BATCH, H, KV, prompt, prompt, D, True)}, None)
        elif "mla" in cfg.blocks:  # MHA at qk_nope + qk_rope, V padded to it
            m, H = cfg.mla, cfg.n_heads
            out[arch] = (None, {arch: (BATCH, H, H, prompt, prompt, m.qk_nope + m.qk_rope,
                                       True)}, m.v_head)
    return out


def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    errs = {}
    serve = _serve_shapes()
    main_dec, main_prefill, _ = serve.pop("tinyllama-1.1b")
    mha_dec, mha_prefill, _ = serve.pop("zamba2-1.2b")  # Zamba2's shared block: MHA
    (main_fa,), (mha_fa,) = main_prefill.values(), mha_prefill.values()
    # the paths that follow: each is checked at its serve shapes
    dec_serve = {arch: shapes[0] for arch, shapes in serve.items() if shapes[0] is not None}
    fa_serve = {label: case for shapes in serve.values() for label, case in shapes[1].items()}
    # MLA's prefill (D = 192, V zero-padded from 128; the default scale
    # D^-0.5 is MLA's (qk_nope + qk_rope)^-0.5), and at the tile edges:
    # case -> V's width before the padding
    mla_edge = (2, 8, 8, 129, 129, 192, True)
    fa_dv = {case: shapes[2] for shapes in serve.values() if shapes[2] is not None
             for case in shapes[1].values()}
    fa_dv[mla_edge] = 128

    # --- flash attention: (B, H, KV, S, T, D, causal)
    fa_cases = [main_fa, mha_fa,
                (2, 8, 2, 130, 257, 64, True),     # S != T, both ragged
                (1, 4, 2, 130, 130, 128, True),
                (2, 4, 1, 257, 257, 256, True),
                (1, 2, 1, 257, 130, 64, False),    # non-causal, S > T
                # edges of the kernel's 128-row query tile and 64-key K/V tile
                (2, 8, 2, 128, 128, 64, True),
                (2, 8, 2, 129, 129, 64, True),
                (2, 32, 4, 1, 1065, 64, True),     # the last query of a long prompt
                (2, 8, 2, 127, 300, 64, True),
                (2, 8, 8, 200, 200, 128, True),    # KV = H at D = 128
                (1, 4, 4, 130, 257, 192, True),    # D = 192, S != T, both ragged
                mla_edge,
                *fa_serve.values()]
    mla_bf16 = {}  # bf16 inputs and output at each MLA serve shape: its controls
    full_bf16 = {}  # the same at each non-causal serve shape (the encoder-decoder's)
    for case in fa_cases:
        B, H, KV, S, T, D, causal = case
        dv = fa_dv.get(case)
        for dname, dt in dtypes.items():
            q, k, v = _prefill_inputs(torch, gen, B, H, KV, S, T, D, dt, dv)
            got = fa.flash_attention_fwd(q, k, v, causal)
            want = fa.attention_plain(q, k, v, causal)
            torch.cuda.synchronize()
            label = f"flash_attention_fwd {dname} B={B} H={H} KV={KV} S={S} T={T} D={D} " \
                    f"causal={causal}" + (f" V zero-padded from {dv}" if dv else "")
            if dv is not None and got[..., dv:].abs().max().item() != 0.0:
                raise AssertionError(f"{label}: the padded columns of the output are not zero")
            errs[("fa", case, dname)] = assert_close(label, got, want, TOL[dname])
            if dt == torch.bfloat16:
                errs[("fa32", case)] = assert_close(
                    label + " vs fp32 reference", got, attention_f32(torch, q, k, v, causal),
                    TIGHT_ATOL, TIGHT_RTOL)
            if case == main_fa and dt == torch.bfloat16:
                main_bf16 = (q, k, v, got)
            if case in fa_serve.values() and dv is not None and dt == torch.bfloat16:
                mla_bf16[case] = (q, k, v, got)
            if case in fa_serve.values() and not causal and dt == torch.bfloat16:
                full_bf16[case] = (q, k, v, got)
            del q, k, v, got, want
    # rows that see no key (causal, S > T) are zeros, as on the TPU
    for dname, dt in dtypes.items():
        q, k, v = _prefill_inputs(torch, gen, 1, 4, 2, 100, 60, 64, dt)
        got = fa.flash_attention_fwd(q, k, v, True)
        torch.cuda.synchronize()
        if got[:, :, :40].abs().max().item() != 0.0:
            raise AssertionError("flash_attention_fwd: rows with no visible key are not zero")
        label = f"flash_attention_fwd {dname} S=100 T=60 (40 rows see no key)"
        assert_close(label, got, fa.attention_plain(q, k, v, True), TOL[dname])
        if dt == torch.bfloat16:
            assert_close(label + " vs fp32 reference", got,
                         attention_f32(torch, q, k, v, True), TIGHT_ATOL, TIGHT_RTOL)
    fa_controls = _kernel_controls(torch, *main_bf16)
    shape_controls = {case: _kernel_controls(torch, *inputs) for case, inputs in mla_bf16.items()}
    shape_controls.update({case: _kernel_controls(torch, *inputs, causal=False)
                           for case, inputs in full_bf16.items()})
    del mla_bf16, full_bf16

    # --- flash decode: (B, H, KV, T, D)
    T_main = main_dec[3]
    lengths = torch.randint(1, T_main + 1, (BATCH,), generator=gen, device="cuda").tolist()
    lengths[0], lengths[1] = 1, T_main
    # the split's edges at the serve shape: C = 8 CTAs a pair; at E = TILE * C
    # keys every warp has one whole chunk, one key more doubles the slices
    # and leaves the trailing CTAs empty (as 100 leaves six of them)
    E = dec.TILE * dec.split_count(BATCH, main_dec[2], T_main)
    dec_cases = [(main_dec, lengths),
                 (mha_dec, [mha_dec[3] - 1] * BATCH),
                 ((3, 8, 2, 300, 128), [1, 300, 157]),
                 ((2, 8, 8, 77, 64), [77, 13]),
                 (main_dec, [1, 2, E - 1, E, E + 1, 100, 2 * E + 1, T_main]),
                 ((2, 8, 2, 60, 64), [60, 17]),       # one tile of cache: C = 1
                 ((2, 8, 8, 300, 128), [300, 129]),   # G = 1 at D = 128
                 ((2, 16, 2, 300, 128), [300, 129]),  # G = 8 at D = 128
                 ((2, 16, 1, 150, 128), [150, 65]),   # G = 16 at D = 128: G * D = 2048
                 ((2, 32, 1, 200, 64), [200, 33])]    # G = 32 at D = 64: two M tiles
    # every dense path's serve shape (D = 256 for Gemma, whose Q is staged in
    # shared memory; G = 7 for qwen2-vl) with random lengths and at the
    # split's edges; at D = 256 also a ragged small cache and C = 1
    for case in dec_serve.values():
        T = case[3]
        E = dec.TILE * dec.split_count(BATCH, case[2], T)
        rand = torch.randint(1, T + 1, (BATCH,), generator=gen, device="cuda").tolist()
        rand[0], rand[1] = 1, T
        dec_cases += [(case, rand), (case, [1, 2, E - 1, E, E + 1, 100, min(2 * E + 1, T), T])]
    dec_cases += [((3, 8, 1, 77, 256), [77, 1, 16]),
                  ((2, 8, 8, 60, 256), [60, 17])]    # one tile of cache: C = 1
    dec_main = None  # the first bf16 serve-shape case: the controls' inputs
    dec_serve_main = {}  # the same for each dense path
    for case, length in dec_cases:
        B, H, KV, T, D = case
        for dname, dt in dtypes.items():
            q, k, v, ln = _decode_inputs(torch, gen, B, H, KV, T, D, dt, length)
            got = dec.flash_decode(q, k, v, ln)
            want = dec.decode_plain(q, k, v, ln)
            torch.cuda.synchronize()
            label = f"flash_decode {dname} B={B} H={H} KV={KV} T={T} D={D} " \
                    f"C={dec.split_count(B, KV, T)} length={','.join(map(str, length))}"
            err = assert_close(label, got, want, TOL[dname])
            errs.setdefault(("dec", case, dname), err)
            if dt == torch.bfloat16:
                errs.setdefault(("dec32", case), assert_close(
                    label + " vs fp32 reference", got, decode_f32(torch, q, k, v, ln),
                    TIGHT_ATOL, TIGHT_RTOL))
            if case == main_dec and dt == torch.bfloat16 and dec_main is None:
                dec_main = (q, k, v, ln, got)
            for arch, shape in dec_serve.items():
                if case == shape and dt == torch.bfloat16:
                    dec_serve_main.setdefault(arch, (q, k, v, ln, got))
    for dname, dt in dtypes.items():
        q, k, v, ln = _decode_inputs(torch, gen, 2, 8, 2, 64, 64, dt, [0, 5])
        got = dec.flash_decode(q, k, v, ln)
        torch.cuda.synchronize()
        if got[0].abs().max().item() != 0.0:
            raise AssertionError("flash_decode: length 0 does not give zeros")
        log(f"[kernels] flash_decode {dname} length=0 gives zeros: ok")
    dec_controls = _decode_controls(torch, dec, *dec_main)
    dec_serve_controls = {arch: _decode_controls(torch, dec, *dec_serve_main[arch])
                          for arch in dec_serve}
    del dec_serve_main

    # --- timings at the serve shapes, bf16
    bf = torch.bfloat16

    def flash_timing(case):
        """CUDA-event ms (kernel, plain, SDPA) and the bound at a prefill shape."""
        B, H, KV, S, T, D, causal = case
        dv = fa_dv.get(case)
        nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * T * D)
        fa_in = copies_beyond_l2(lambda: _prefill_inputs(torch, gen, B, H, KV, S, T, D, bf, dv),
                                 nbytes)
        # the (query, key) pairs computed: query i sees keys <= i + T - S when causal
        pairs = sum(max(0, min(T, i + T - S + 1)) for i in range(S)) if causal else S * T
        t_bound, by = bound(4 * B * H * D * pairs, nbytes, H100.peak_flops)
        row = {
            "shape": f"B={B} H={H} KV={KV} S={S} T={T} D={D} {'causal' if causal else 'full'} "
                     f"bf16" + (f", V zero-padded from {dv}" if dv else ""),
            "max_abs_err": errs[("fa", case, "bfloat16")],
            "max_abs_err_fp32": errs[("fa", case, "float32")],
            "max_abs_err_vs_fp32_reference": errs[("fa32", case)],
            "ms": time_ms(torch, lambda q, k, v: fa.flash_attention_fwd(q, k, v, causal), fa_in),
            "plain_ms": time_ms(torch, lambda q, k, v: fa.attention_plain(q, k, v, causal), fa_in,
                                iters=5, warmup=1),
            "library_ms": time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), fa_in),
            "bound_ms": t_bound, "bound_by": by}
        del fa_in
        log(f"[kernels] flash_attention_fwd {row['shape']}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {t_bound:.4f} ms ({by}, datasheet peaks)")
        return row

    fa_row = dict(flash_timing(main_fa), **{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "tol": TOL["bfloat16"], "tol_fp32": TOL["float32"],
        "tol_vs_fp32_reference": {"atol": TIGHT_ATOL, "rtol": TIGHT_RTOL},
        "controls": fa_controls,
        "shapes": {label: dict(flash_timing(case), **({"controls": shape_controls[case]}
                                                      if case in shape_controls else {}))
                   for label, case in {"zamba2-1.2b": mha_fa, **fa_serve}.items()}})

    def decode_timing(case):
        """Device ms (kernel, plain, SDPA) and host µs per call at a serve
        shape, every length T - 1 (the last decode step of the path)."""
        B, H, KV, T, D = case
        length = [T - 1] * B
        nbytes = 2 * (2 * B * H * D + 2 * KV * D * sum(length)) + 4 * B
        dec_in = copies_beyond_l2(
            lambda: _decode_inputs(torch, gen, B, H, KV, T, D, bf, length), nbytes)
        # SDPA's mask is built outside the timed call
        sdpa_in = [(q[:, :, None], k, v, (torch.arange(T, device="cuda")[None, :]
                                          < ln[:, None])[:, None, None])
                   for q, k, v, ln in dec_in]
        t_bound, by = bound(4 * H * D * sum(length), nbytes, H100.peak_flops)
        ms, host_us = device_ms(torch, dec.flash_decode, dec_in)
        lib_ms, lib_host_us = device_ms(torch, lambda q, k, v, mask: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), sdpa_in)
        row = {"shape": f"B={B} H={H} KV={KV} T={T} D={D} length={T - 1} bf16",
               "splits": dec.split_count(B, KV, T), "ms": ms, "host_us_per_call": host_us,
               "plain_ms": device_ms(torch, dec.decode_plain, dec_in, iters=10)[0],
               "library_ms": lib_ms, "library_host_us_per_call": lib_host_us,
               "bound_ms": t_bound, "bound_by": by,
               "events_ms": time_ms(torch, dec.flash_decode, dec_in)}
        del dec_in, sdpa_in
        log(f"[kernels] flash_decode {row['shape']} (C={row['splits']}): kernel {ms:.4f} ms "
            f"device ({100 * t_bound / ms:.0f}% of the bound), host {host_us:.1f} us a call, "
            f"CUDA events over back-to-back calls {row['events_ms']:.4f} ms; plain "
            f"{row['plain_ms']:.4f} ms, SDPA {lib_ms:.4f} ms device ({lib_host_us:.1f} us host); "
            f"bound {t_bound:.4f} ms ({by}, datasheet peaks)")
        return row

    gqa, mha = decode_timing(main_dec), decode_timing(mha_dec)
    shapes = {arch: dict(decode_timing(case), controls=dec_serve_controls[arch],
                         max_abs_err=errs[("dec", case, "bfloat16")],
                         max_abs_err_fp32=errs[("dec", case, "float32")],
                         max_abs_err_vs_fp32_reference=errs[("dec32", case)])
              for arch, case in dec_serve.items()}
    dec_row = dict(gqa, **{
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:67",
        "max_abs_err": errs[("dec", main_dec, "bfloat16")],
        "max_abs_err_fp32": errs[("dec", main_dec, "float32")],
        "tol": TOL["bfloat16"], "tol_fp32": TOL["float32"],
        "max_abs_err_vs_fp32_reference": errs[("dec32", main_dec)],
        "tol_vs_fp32_reference": {"atol": TIGHT_ATOL, "rtol": TIGHT_RTOL},
        "controls": dec_controls, "mha": mha, "shapes": shapes})
    fa_row["kernel_ms"] = fa_row["ms"]
    dec_row["kernel_ms"] = dec_row["ms"]
    for row in (fa_row, dec_row):  # every serve shape was held against its references
        for arch, shape in row["shapes"].items():
            missing = [k for k, v in shape.items() if v is None and k != "library_ms"]
            if missing:
                raise AssertionError(f"{row['name']} at {arch}'s serve shape: no reading of "
                                     f"{missing}")
    return [fa_row, dec_row]


def _kernel_controls(torch, q, k, v, got, causal=True):
    """Hold the sound bf16 kernel output against fp32 references of kernels
    with planted faults: the tight limit must reject every one of them.
    Also reads how many elements the plain-path limit (2e-2) would flag.
    A causal case's faults move its mask by one key; a full one's are a
    causal mask; both drop the keys of the last 64-key tile."""
    S, T = q.shape[2], k.shape[2]
    tail = T - T % 64 if T % 64 else T - 64  # first key of the last (partial) tile
    faults = ((("causal offset +1 (one future key)", {"shift": 1}),
               ("causal offset -1 (diagonal key missing)", {"shift": -1})) if causal else
              (("a causal mask (offset T - S)", {"causal": True}),))
    readings = []
    for fault, kw in (*faults, (f"keys {tail}..{T - 1} dropped (last tile)",
                                {"drop_from": tail})):
        want = attention_f32(torch, q, k, v, kw.pop("causal", causal), **kw)
        err, n_tight, _ = beyond(got, want, TIGHT_ATOL, TIGHT_RTOL)
        _, n_late, _ = beyond(got[:, :, S // 2:], want[:, :, S // 2:], TIGHT_ATOL, TIGHT_RTOL)
        _, n_loose, _ = beyond(got, want, TOL["bfloat16"], TOL["bfloat16"])
        log(f"[kernels] control, flash_attention_fwd bf16 vs a kernel with {fault}: "
            f"max_abs_err={err:.3e}; beyond the tight limit {n_tight} elements "
            f"({n_late} in rows >= {S // 2}), beyond 2e-2 {n_loose}")
        if n_tight == 0:
            raise AssertionError(f"control {fault}: the tight limit does not reject it")
        readings.append({"fault": fault, "max_abs_err": err, "beyond_tight": n_tight,
                         "beyond_tight_late_rows": n_late, "beyond_2e-2": n_loose})
    return readings


def _decode_controls(torch, dec, q, k, v, ln, got):
    """Hold the sound bf16 decode output against fp32 references of kernels
    with planted faults in the split: the tight limit must reject each."""
    B, KV, T = k.shape[0], k.shape[1], k.shape[2]
    C = dec.split_count(B, KV, T)
    n = ln.long().clamp(0, T)
    # keys per CTA slice, as the kernel partitions [0, n) (decode_attention.cu)
    per = (-(-n // dec.CHUNK) + C * dec.WARPS - 1) // (C * dec.WARPS)
    slice_of = torch.arange(T, device=k.device)[None, :] // (per * dec.TILE).clamp_min(1)[:, None]
    readings = []
    for fault, kw in ((f"slice 1 of the {C} CTAs' slices dropped", {"keep": slice_of != 1}),
                      ("CTA partials summed without the max correction", {"slices": slice_of}),
                      ("the newest key dropped", {"length": ln - 1})):
        want = decode_f32(torch, q, k, v, kw.pop("length", ln), **kw)
        err, n_tight, _ = beyond(got, want, TIGHT_ATOL, TIGHT_RTOL)
        _, n_loose, _ = beyond(got, want, TOL["bfloat16"], TOL["bfloat16"])
        log(f"[kernels] control, flash_decode bf16 vs a kernel with {fault}: "
            f"max_abs_err={err:.3e}; beyond the tight limit {n_tight} elements, "
            f"beyond 2e-2 {n_loose}")
        if n_tight == 0:
            raise AssertionError(f"control {fault}: the tight limit does not reject it")
        readings.append({"fault": fault, "max_abs_err": err, "beyond_tight": n_tight,
                         "beyond_2e-2": n_loose})
    return readings


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------
# the reference's own kernel-test limits (tests/test_kernels.py), atol = rtol
SCAN_TOL = {"mamba2": 1e-4, "rwkv6": 5e-5, "rwkv6_naive": 2e-3, "bfloat16": 2e-2}
SCAN_SERVE = {"mamba2": (BATCH, 1024, 64, 64, 1, 64),   # B, S, H, P, G, N (zamba2-1.2b)
              "rwkv6": (BATCH, 1024, 64, 64)}          # B, S, H, K = V (rwkv6-7b)


def _mamba_inputs(torch, gen, B, S, H, P, G, N, dtype, h0=False, offset=None):
    """The distributions of the reference's kernel tests.  With ``offset``,
    x, B and C are views of one (B, S, H P + 2 G N + offset) projection
    that start ``offset`` elements into it, as the model's split of its
    conv output hands them over: 8 keeps their rows 16-byte aligned, 1 does
    not (the bf16 kernel then stages by plain loads)."""
    if offset is not None:
        proj = torch.randn((B, S, H * P + 2 * G * N + offset), generator=gen,
                           device="cuda").to(dtype)
        x = proj[..., offset:offset + H * P].unflatten(-1, (H, P))
        Bm, Cm = (proj[..., offset + H * P + i * G * N:offset + H * P + (i + 1) * G * N]
                  .unflatten(-1, (G, N)) for i in range(2))
    else:
        x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
    dt = torch.rand((B, S, H), generator=gen, device="cuda") * 0.19 + 0.01
    A = -(torch.rand((H,), generator=gen, device="cuda") * 1.5 + 0.5)
    if offset is None:
        Bm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
        Cm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
    h = torch.randn((B, H, P, N), generator=gen, device="cuda") if h0 else None
    return x, dt, A, Bm, Cm, h


def _rwkv_inputs(torch, gen, B, S, H, K, dtype, s0=False, w_max=3.0, grid=True,
                 offset=None):
    """The distributions of the reference's kernel tests.  With ``grid``, w
    lies on a 2^-6 grid: every prefix sum of w is then exact in fp32 in any
    order, so the kernel and the chunked plain version form the same decay
    exponents.  Off the grid, fp32 prefix sums near -190 round by ~1e-5, and
    exp(cwx_t - cw_s) of two summation orders differs by more than the
    reference's 5e-5 (it holds only between implementations that share one
    cumsum, as the reference's own test does).  With ``offset``, r, k and v
    are views of one (B, S, 3 H K + offset) projection that start ``offset``
    elements into it, as a fused projection hands them over: 8 keeps their
    rows 16-byte aligned, 1 does not (the bf16 kernel then stages by plain
    loads)."""
    if offset is not None:
        proj = torch.randn((B, S, 3 * H * K + offset), generator=gen, device="cuda").to(dtype)
        r, k, v = (proj[..., offset + i * H * K:offset + (i + 1) * H * K].unflatten(-1, (H, K))
                   for i in range(3))
    else:
        r, k, v = (torch.randn((B, S, H, K), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
    w = -(torch.rand((B, S, H, K), generator=gen, device="cuda") * (w_max - 0.01) + 0.01)
    if grid:
        w = -torch.clamp(torch.round(-w * 64), min=1) / 64
    u = torch.randn((H, K), generator=gen, device="cuda")
    s = torch.randn((B, H, K, K), generator=gen, device="cuda") if s0 else None
    return r, k, v, w, u, s


def _upcast(args):
    """The same values in fp32: the plain versions then do the kernels'
    fp32 arithmetic on the bf16 inputs (the reference's own forms round
    C.B and k.v to the inputs' dtype, which the kernels do not)."""
    return tuple(None if t is None else t.float() for t in args)


def _scan_close(name, got, want, tol_y, tol_s, fails):
    """y and final state against a reference; failures are collected so that
    every reading of the phase is logged before it raises.  With ``fails``
    None the reading is logged only."""
    out = []
    for part, g, w, tol in (("y", got[0], want[0], tol_y), ("state", got[1], want[1], tol_s)):
        err, bad, share = beyond(g, w, tol, tol)
        log(f"[scans] {name} {part}: max_abs_err={err:.3e} atol=rtol={tol:g} "
            f"(uses {100 * share:.0f}% of the limit) "
            f"{'read only' if fails is None else 'ok' if bad == 0 else f'FAIL ({bad} elements)'}")
        if bad and fails is not None:
            fails.append(f"{name} {part}: {bad} elements beyond {tol:g} (max_abs_err {err:.3e})")
        out.append(err)
    return out


def _fold(t, L):
    """(B, S, ...) -> (B * S / L, L, ...): every chunk of L a sequence of its own."""
    return t.reshape(t.shape[0] * (t.shape[1] // L), L, *t.shape[2:])


def _wkv_decay_late(torch, r, k, v, w, u, s0=None):
    """Planted fault: the token recurrence with the decay applied one
    position late, y_t = r_t (diag(exp w_t) S_{t-1} + diag(u) k_t v_t^T)."""
    B, S, H, K = r.shape
    s = torch.zeros((B, H, K, v.shape[-1]), device=r.device) if s0 is None else s0.float()
    ys = []
    for t in range(S):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        e = torch.exp(w[:, t].float())[..., None]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               e * s + u[None, :, :, None] * kv))
        s = e * s + kv
    return torch.stack(ys, 1).to(v.dtype)


def _wkv_chunked(torch, r, k, v, w, u, chunk, s0=None, sub=None, kd_bf16=False):
    """The chunked WKV6 in fp32, none of the port's code, for a planted fault
    and a reading: with ``sub``, the pairs (t, s) of a chunk that lie in
    different sub-blocks of ``sub`` positions are dropped; with
    ``kd_bf16``, k exp(cw_L - cw) is rounded to bf16 before the state
    update.  S must be a multiple of ``chunk``."""
    B, S, H, K = r.shape
    n = S // chunk
    rc, kc, vc, wc = (x.float().reshape(B, n, chunk, H, x.shape[-1]) for x in (r, k, v, w))
    i = torch.arange(chunk, device=r.device)
    keep = i[:, None] > i[None, :]
    if sub is not None:
        keep = keep & (i[:, None] // sub == i[None, :] // sub)
    mask = keep[None, :, :, None, None]
    s = torch.zeros((B, H, K, v.shape[-1]), device=r.device) if s0 is None else s0.float()
    ys = []
    for c in range(n):
        rb, kb, vb, wb = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        cw = torch.cumsum(wb, 1)
        cwx = cw - wb
        y = torch.einsum("blhk,bhkv->blhv", rb * torch.exp(cwx), s)
        expo = torch.where(mask, cwx[:, :, None] - cw[:, None], -math.inf)
        qk = torch.einsum("blhk,bmhk,blmhk->blmh", rb, kb, torch.exp(expo))
        y = y + torch.einsum("blmh,bmhv->blhv", qk, vb)
        y = y + torch.einsum("blhk,hk,blhk->blh", rb, u.float(), kb)[..., None] * vb
        kd = kb * torch.exp(cw[:, -1:] - cw)
        if kd_bf16:
            kd = kd.to(torch.bfloat16).float()
        s = torch.exp(cw[:, -1])[..., None] * s + torch.einsum("blhk,blhv->bhkv", kd, vb)
        ys.append(y)
    return torch.stack(ys, 1).reshape(B, S, H, v.shape[-1]), s


def _ssd_chunked(torch, x, dt, A, Bm, Cm, h0=None, chunk=64, strict=False, bt_bf16=False):
    """The chunked SSD scan in fp32, none of the port's code, for a planted
    fault and a reading: with ``strict``, the diagonal s = t of the chunk's
    W is dropped; with ``bt_bf16``, B~ = exp(cs_L - cs_s) dt_s B_s is
    rounded to bf16 (one part) before the state update.  S must be a
    multiple of ``chunk``."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    n, rep = S // chunk, H // G
    xc = x.float().reshape(B, n, chunk, H, P)
    dc = dt.float().reshape(B, n, chunk, H)
    bc, cc = (t.float().repeat_interleave(rep, 2).reshape(B, n, chunk, H, N) for t in (Bm, Cm))
    i = torch.arange(chunk, device=x.device)
    keep = (i[:, None] > i[None, :]) if strict else (i[:, None] >= i[None, :])
    h = torch.zeros((B, H, P, N), device=x.device) if h0 is None else h0.float()
    ys = []
    for c in range(n):
        xb, db, bb, cb = xc[:, c], dc[:, c], bc[:, c], cc[:, c]
        cs = torch.cumsum(db * A.float(), 1)  # (B, L, H)
        tot = cs[:, -1]
        expo = torch.where(keep[None, :, :, None], cs[:, :, None] - cs[:, None], -math.inf)
        w = torch.exp(expo) * torch.einsum("bthn,bshn->btsh", cb, bb) * db[:, None]
        y = torch.einsum("btsh,bshp->bthp", w, xb) \
            + torch.einsum("bthn,bhpn->bthp", cb, h) * torch.exp(cs)[..., None]
        bt = (torch.exp(tot[:, None] - cs) * db)[..., None] * bb
        if bt_bf16:
            bt = bt.to(torch.bfloat16).float()
        h = torch.exp(tot)[..., None, None] * h + torch.einsum("bshp,bshn->bhpn", xb, bt)
        ys.append(y)
    return torch.stack(ys, 1).reshape(B, S, H, P), h


def _ctas_per_sm(lib, symbol, *dims):
    """CTAs of a bf16 scan kernel that one SM holds at these head sizes:
    the CUDA occupancy calculator, through the library's own entry point."""
    import ctypes
    from repro_torch.kernels import build
    n = build.function(lib, symbol, [ctypes.c_int] * len(dims))(*dims)
    if n < 0:
        raise RuntimeError(f"{symbol}: CUDA error {-n}")
    return n


def _scan_controls(name, outs, faulty, fails):
    """The sound kernel outputs (fp32 and bf16, same seed) against references
    with a planted fault: each limit must reject it."""
    reading = {"fault": name}
    for dname, got in outs.items():
        tol = SCAN_TOL["mamba2" if "mamba2" in name else "rwkv6"] \
            if dname == "float32" else SCAN_TOL["bfloat16"]
        err, bad, _ = beyond(got, faulty[dname], tol, tol)
        log(f"[scans] control, {name}, {dname}: max_abs_err={err:.3e}; beyond "
            f"atol=rtol={tol:g}: {bad} elements")
        if bad == 0:
            fails.append(f"control {name} ({dname}): the limit does not reject it")
        reading[f"beyond_{dname}"] = bad
        reading[f"max_abs_err_{dname}"] = err
    return reading


def _mamba2_checks(torch, fails, errs):
    """phase_scans' mamba2 part: every case against its reference, the
    planted faults, and a reading of the state with B~ in one bf16 part.
    bf16 outputs are held against the plain versions on the same bf16
    values in fp32 (the kernel's arithmetic); the reading against the bf16
    plain version (the reference's rounding of C.B) is logged only.
    Returns (controls, reading)."""
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    M, BF = SCAN_TOL["mamba2"], SCAN_TOL["bfloat16"]
    L = m2.CHUNK
    main_m = SCAN_SERVE["mamba2"]
    serve_out, serve_in = {}, {}
    for seed, (shape, h0, offset, label) in enumerate((
            (main_m, False, None, "serve shape"),
            ((2, 1024, 64, 64, 1, 64), True, None, "nonzero h0"),
            ((2, 512, 8, 64, 2, 64), True, None, "G=2"),
            ((2, 1000, 8, 64, 1, 64), True, None, "ragged S=1000"),
            # appended, so that the seeds of the cases above stay as they
            # were.  The bf16 kernel's edges: its chunk, P and N below 64
            # (zero-padded tiles), N = 128 (two panels), one group a head,
            # views of one projection (rows 16-byte aligned, staged by
            # cp.async, and not, staged by plain loads)
            ((2, 1, 4, 64, 1, 64), True, None, "S=1"),
            ((2, L - 1, 4, 64, 1, 64), True, None, "S=L-1"),
            ((2, L + 1, 4, 64, 1, 64), True, None, "S=L+1"),
            ((2, 256, 4, 16, 1, 64), True, None, "P=16"),
            ((2, 256, 4, 32, 1, 64), True, None, "P=32"),
            ((2, 256, 4, 64, 1, 16), True, None, "N=16"),
            ((2, 256, 4, 64, 1, 32), True, None, "N=32"),
            ((2, 256, 4, 64, 1, 128), True, None, "N=128"),
            ((2, 256, 4, 64, 4, 64), True, None, "G=H"),
            ((2, 256, 4, 64, 1, 64), True, 8, "views of one projection"),
            ((2, 256, 4, 64, 1, 64), True, 1,
             "views of one projection, rows not 16-byte aligned"),
            ((2, L + 1, 4, 16, 4, 16), True, 1,
             "views of one projection, rows not 16-byte aligned, S=L+1, P=N=16, G=H"))):
        B, S, H, P, G, N = shape
        for dname, dt in dtypes.items():
            # one seed per case: the bf16 inputs are the fp32 ones, rounded
            case_gen = torch.Generator(device="cuda").manual_seed(10 + seed)
            args = _mamba_inputs(torch, case_gen, *shape, dt, h0, offset)
            got = m2.mamba2_scan(*args)
            torch.cuda.synchronize()
            tag = f"mamba2_scan {dname} B={B} S={S} H={H} P={P} G={G} N={N} ({label})"
            if not (torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()):
                fails.append(f"{tag}: inf or NaN in the output")
            ty = M if dname == "float32" else BF
            if S % 128 == 0:
                errs[("m2", label, dname)] = _scan_close(
                    tag + " vs plain", got, m2.mamba2_plain(*_upcast(args)), ty, M, fails)
                if dname == "bfloat16":
                    _scan_close(tag + " vs bf16 plain", got, m2.mamba2_plain(*args), BF, M, None)
            if dname == "float32" or S % 128:
                _scan_close(tag + " vs naive", got, ref.mamba2_scan_naive(*_upcast(args)),
                            ty, M, fails)
            if shape == main_m:
                serve_out[dname], serve_in[dname] = got[0], _upcast(args)
    controls = [
        _scan_controls(f"mamba2_scan: state carry dropped between chunks of {L}", serve_out,
                       {d: m2.mamba2_plain(_fold(a[0], L), _fold(a[1], L), a[2], _fold(a[3], L),
                                           _fold(a[4], L))[0].reshape(a[0].shape)
                        for d, a in serve_in.items()}, fails),
        _scan_controls("mamba2_scan: the diagonal s = t dropped from W", serve_out,
                       {d: _ssd_chunked(torch, *a[:5], chunk=L, strict=True)[0]
                        for d, a in serve_in.items()}, fails)]
    # a reading, not a control: how far the state limit stands from a state
    # update whose B~ = exp(cs_L - cs) dt B is rounded to bf16 (one part)
    a = serve_in["bfloat16"]
    short, want = _ssd_chunked(torch, *a[:5], chunk=L, bt_bf16=True)[1], m2.mamba2_plain(*a[:5])[1]
    err, bad, share = beyond(short, want, M, M)
    log(f"[scans] reading, mamba2 state with B~ = exp(cs_L - cs) dt B rounded to bf16 vs "
        f"plain: max_abs_err={err:.3e}, {bad} elements beyond atol=rtol={M:g} "
        f"({100 * share:.0f}% of the limit at most)")
    return controls, {"max_abs_err": err, "beyond": bad, "limit_share": share}


def phase_scans(torch):
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as r6

    gen = torch.Generator(device="cuda").manual_seed(2)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    fails, errs = [], {}
    BF = SCAN_TOL["bfloat16"]
    M = SCAN_TOL["mamba2"]
    m2_controls, bt_reading = _mamba2_checks(torch, fails, errs)

    # --- rwkv6, the same way; w on the 2^-6 grid (see _rwkv_inputs), and
    # one case off it, held against the token recurrence only.  The plain
    # version takes S in chunks of min(64, S): every S below 64 is one chunk.
    # The bf16 kernel's edges: S = 1, one below and above its sub-block and
    # one above its chunk, K = V = 16 and 32, views of one projection (rows
    # 16-byte aligned, staged by cp.async, and not, staged by plain loads),
    # and w down to -20 (the model's w = -exp(w0 + dw) reaches it)
    L = r6.CHUNK
    R, RN = SCAN_TOL["rwkv6"], SCAN_TOL["rwkv6_naive"]
    main_r = SCAN_SERVE["rwkv6"]
    serve_out, serve_in = {}, {}
    for seed, (shape, s0, w_max, grid, offset, label) in enumerate((
            (main_r, False, 3.0, True, None, "serve shape"),
            (main_r, False, 3.0, False, None, "serve shape, w off the grid"),
            ((2, 1024, 64, 64), True, 3.0, True, None, "nonzero s0"),
            ((2, 1000, 4, 64), True, 3.0, True, None, "ragged S=1000"),
            ((2, 256, 4, 64), True, 8.0, True, None, "w down to -8"),
            ((2, 1, 4, 64), True, 3.0, True, None, "S=1"),
            ((2, r6.SUB - 1, 4, 64), True, 3.0, True, None, "S=sub-1"),
            ((2, r6.SUB + 1, 4, 64), True, 3.0, True, None, "S=sub+1"),
            ((2, L + 1, 4, 64), True, 3.0, True, None, "S=L+1"),
            ((2, 256, 4, 16), True, 3.0, True, None, "K=V=16"),
            ((2, 256, 4, 32), True, 3.0, True, None, "K=V=32"),
            ((2, 256, 4, 64), True, 3.0, True, 8, "views of one projection"),
            ((2, 256, 4, 64), True, 20.0, True, None, "w down to -20"),
            # appended, so that the seeds of the cases above stay as they were
            ((2, 256, 4, 64), True, 3.0, True, 1,
             "views of one projection, rows not 16-byte aligned"),
            ((2, L + 1, 4, 16), True, 3.0, True, 1,
             "views of one projection, rows not 16-byte aligned, S=L+1, K=V=16"))):
        B, S, H, K = shape
        for dname, dt in dtypes.items():
            case_gen = torch.Generator(device="cuda").manual_seed(20 + seed)
            args = _rwkv_inputs(torch, case_gen, *shape, dt, s0, w_max, grid, offset)
            got = r6.rwkv6_scan(*args)
            torch.cuda.synchronize()
            tag = f"rwkv6_scan {dname} B={B} S={S} H={H} K=V={K} ({label})"
            if not (torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()):
                fails.append(f"{tag}: inf or NaN in the output")
            plain = S % min(64, S) == 0 and grid
            if plain:
                errs[("r6", label, dname)] = _scan_close(
                    tag + " vs plain", got, r6.rwkv6_plain(*_upcast(args)),
                    R if dname == "float32" else BF, R, fails)
                if dname == "bfloat16":
                    _scan_close(tag + " vs bf16 plain", got, r6.rwkv6_plain(*args), BF, R, None)
            if dname == "float32" or not plain or shape != main_r:
                _scan_close(tag + " vs naive", got, ref.rwkv6_scan_naive(*_upcast(args)),
                            RN if dname == "float32" else BF, RN, fails)
            if label == "serve shape":
                serve_out[dname], serve_in[dname] = got[0], _upcast(args)
    r6_controls = [
        _scan_controls(f"rwkv6_scan: state carry dropped between chunks of {L}",
                       serve_out, {d: r6.rwkv6_plain(*(_fold(t, L) for t in a[:4]), a[4])[0]
                                   .reshape(a[2].shape) for d, a in serve_in.items()}, fails),
        _scan_controls("rwkv6_scan: decay applied one position late (inclusive)", serve_out,
                       {d: _wkv_decay_late(torch, *a[:5]) for d, a in serve_in.items()}, fails),
        _scan_controls("rwkv6_scan: bonus u omitted", serve_out,
                       {d: r6.rwkv6_plain(*a[:4], torch.zeros_like(a[4]))[0]
                        for d, a in serve_in.items()}, fails),
        _scan_controls(f"rwkv6_scan: pairs across sub-blocks of {r6.SUB} dropped", serve_out,
                       {d: _wkv_chunked(torch, *a[:5], L, sub=r6.SUB)[0]
                        for d, a in serve_in.items()}, fails)]
    # a reading, not a control: how far the state limit stands from a state
    # update whose k exp(cw_L - cw) is rounded to bf16 (one bf16 part)
    a = serve_in["bfloat16"]
    short, want = _wkv_chunked(torch, *a[:5], L, kd_bf16=True)[1], r6.rwkv6_plain(*a[:5])[1]
    err, bad, share = beyond(short, want, R, R)
    log(f"[scans] reading, rwkv6 state with k exp(cw_L - cw) rounded to bf16 vs plain: "
        f"max_abs_err={err:.3e}, {bad} elements beyond atol=rtol={R:g} "
        f"({100 * share:.0f}% of the limit at most)")
    kd_reading = {"max_abs_err": err, "beyond": bad, "limit_share": share}
    del serve_out, serve_in, a, short, want
    if fails:
        raise AssertionError("scan kernels disagree with their references, or a limit "
                             "misses a planted fault:\n  " + "\n  ".join(fails))

    # --- timings and bounds at the serve shapes, bf16
    bf = torch.bfloat16
    main_m = SCAN_SERVE["mamba2"]
    B, S, H, P, G, N = main_m
    nbytes = 2 * B * S * H * P + 4 * B * S * H + 4 * H + 2 * 2 * B * S * G * N \
        + 2 * B * S * H * P + 4 * B * H * P * N
    L, nc = m2.CHUNK, -(-S // m2.CHUNK)
    flops = B * nc * (G * 2 * L * L * N + H * (2 * L * L * P + 4 * L * P * N))
    m_in = copies_beyond_l2(lambda: _mamba_inputs(torch, gen, *main_m, bf)[:5], nbytes)
    m_bound, m_by = bound(flops, nbytes, H100.peak_flops)
    m_row = {
        "name": "mamba2_scan", "route": "cuda", "source": "src/repro_torch/csrc/mamba2_scan.cu",
        "replaces": "src/repro/kernels/mamba2_scan.py:100",
        "shape": f"B={B} S={S} H={H} P={P} G={G} N={N} bf16 x/B/C, fp32 dt/A/state",
        "max_abs_err": errs[("m2", "serve shape", "bfloat16")][0],
        "max_abs_err_state": errs[("m2", "serve shape", "bfloat16")][1],
        "max_abs_err_fp32": errs[("m2", "serve shape", "float32")][0],
        "tol": BF, "tol_fp32": M, "controls": m2_controls,
        "reading_state_bt_bf16": bt_reading,
        "ctas_per_sm": _ctas_per_sm("mamba2_scan", "mamba2_ctas_per_sm", P, N),
        "ctas_per_sm_n128": _ctas_per_sm("mamba2_scan", "mamba2_ctas_per_sm", P, 128),
        "ms": time_ms(torch, m2.mamba2_scan, m_in),
        "plain_ms": time_ms(torch, m2.mamba2_plain, m_in, iters=3, warmup=1),
        "library_ms": None, "library_note": "no single PyTorch call computes the scan",
        "bound_ms": m_bound, "bound_by": m_by,
    }
    del m_in
    B, S, H, K = main_r
    nbytes = 3 * 2 * B * S * H * K + 4 * B * S * H * K + 4 * H * K + 2 * B * S * H * K \
        + 4 * B * H * K * K
    L, nc = r6.CHUNK, -(-S // r6.CHUNK)
    pairs = L * (L - 1) // 2
    flops = B * H * nc * (4 * pairs * K + 3 * L * K + 4 * L * K * K + 2 * pairs * K + 2 * L * K)
    r_in = copies_beyond_l2(lambda: _rwkv_inputs(torch, gen, *main_r, bf)[:5], nbytes)
    r_bound, r_by = bound(flops, nbytes, H100.peak_flops)
    r_row = {
        "name": "rwkv6_scan", "route": "cuda", "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:95",
        "shape": f"B={B} S={S} H={H} K=V={K} bf16 r/k/v, fp32 w/u/state",
        "max_abs_err": errs[("r6", "serve shape", "bfloat16")][0],
        "max_abs_err_state": errs[("r6", "serve shape", "bfloat16")][1],
        "max_abs_err_fp32": errs[("r6", "serve shape", "float32")][0],
        "tol": BF, "tol_fp32": R, "controls": r6_controls,
        "reading_state_kd_bf16": kd_reading,
        "ctas_per_sm": _ctas_per_sm("rwkv6_scan", "rwkv6_ctas_per_sm", K),
        "ms": time_ms(torch, r6.rwkv6_scan, r_in),
        "plain_ms": time_ms(torch, r6.rwkv6_plain, r_in, iters=3, warmup=1),
        "library_ms": None, "library_note": "no single PyTorch call computes the scan",
        "bound_ms": r_bound, "bound_by": r_by,
    }
    del r_in
    log(f"[scans] mamba2_scan bf16 kernel: {m_row['ctas_per_sm']} CTAs an SM at P = N = 64, "
        f"{m_row['ctas_per_sm_n128']} at N = 128")
    log(f"[scans] rwkv6_scan bf16 kernel: {r_row['ctas_per_sm']} CTAs an SM at K = V = {K}")
    for row in (m_row, r_row):
        row["kernel_ms"] = row["ms"]
        log(f"[scans] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library: none, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, datasheet peaks)")
    return [m_row, r_row]


# parameter leaves checked per path: (path in the tree, shape, dtype name);
# shape None: the leaf must be absent
def _expected_leaves(cfg):
    L, D, H, KV, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.enc_dec is not None:  # lists of layers; the tied head; the plain MLP keeps wg
        out = [(("lm_head",), None, "bfloat16"), (("layers",), None, "bfloat16"),
               (("embed", "tok"), (cfg.padded_vocab, D), "bfloat16"),
               (("pos_dec",), (32776, D), "bfloat16"),
               (("enc_norm", "bias"), (D,), "bfloat16"), (("dec_norm", "scale"), (D,), "bfloat16")]
        for i in range(cfg.enc_dec.n_enc_layers):
            out += [(("enc_layers", i, "attn", "wq"), (D, H, hd), "bfloat16"),
                    (("enc_layers", i, "attn", "bk"), (KV, hd), "bfloat16"),
                    (("enc_layers", i, "ln1", "bias"), (D,), "bfloat16"),
                    (("enc_layers", i, "mlp", "wg"), (D, cfg.d_ff), "bfloat16"),
                    (("enc_layers", i, "xattn"), None, "bfloat16")]
        for i in range(L):
            out += [(("dec_layers", i, "attn", "wk"), (D, KV, hd), "bfloat16"),
                    (("dec_layers", i, "lnx", "scale"), (D,), "bfloat16"),
                    (("dec_layers", i, "xattn", "wv"), (D, KV, hd), "bfloat16"),
                    (("dec_layers", i, "xattn", "bq"), (H, hd), "bfloat16"),
                    (("dec_layers", i, "xattn", "wo"), (H, hd, D), "bfloat16"),
                    (("dec_layers", i, "mlp", "wo"), (cfg.d_ff, D), "bfloat16")]
        return out
    head = [(("lm_head",), None if cfg.tie_embeddings else (cfg.padded_vocab, D), "bfloat16"),
            (("embed", "tok"), (cfg.padded_vocab, D), "bfloat16")]
    if cfg.mamba is not None:
        mc = cfg.mamba
        Din, Hm = mc.d_inner(D), mc.n_heads(D)
        run = next(i for i, b in enumerate(cfg.blocks) if b != "mamba2")  # first run of mamba2
        proj = 2 * Din + 2 * mc.ngroups * mc.d_state + Hm
        return head + [
            (("layers", 0, "mixer", "in_proj"), (run, D, proj), "bfloat16"),
            (("layers", 0, "mixer", "A_log"), (run, Hm), "float32"),
            (("layers", 0, "mixer", "out_proj"), (run, Din, D), "bfloat16"),
            (("shared_block", "attn", "wq"), (D, H, hd), "bfloat16"),
            (("shared_block", "attn", "wk"), (D, KV, hd), "bfloat16"),
            (("shared_block", "ffn", "wi"), (D, cfg.d_ff), "bfloat16")]
    if cfg.rwkv is not None:
        rh = D // cfg.rwkv.head_dim
        return head + [
            (("layers", 0, "tm", "wr"), (L, D, D), "bfloat16"),
            (("layers", 0, "tm", "u"), (L, rh, cfg.rwkv.head_dim), "float32"),
            (("layers", 0, "tm", "w0"), (L, D), "float32"),
            (("layers", 0, "tm", "cm_k"), (L, D, cfg.d_ff), "bfloat16"),
            (("ln0", "scale"), (D,), "bfloat16")]
    if cfg.mla is not None:  # a leading dense group of one layer, then the MoE layers
        ml, m, n = cfg.mla, cfg.moe, L - cfg.moe.first_dense_layers
        qk = ml.qk_nope + ml.qk_rope
        return head + [
            (("layers", 0, "attn", "q_down"), (1, D, ml.q_lora), "bfloat16"),
            (("layers", 0, "attn", "q_norm", "scale"), (1, ml.q_lora), "bfloat16"),
            (("layers", 0, "attn", "q_up"), (1, ml.q_lora, H, qk), "bfloat16"),
            (("layers", 0, "attn", "wq"), None, "bfloat16"),
            (("layers", 0, "ffn", "wi"), (1, D, m.dense_d_ff), "bfloat16"),
            (("layers", 1, "attn", "kv_down"), (n, D, ml.kv_lora + ml.qk_rope), "bfloat16"),
            (("layers", 1, "attn", "kv_norm", "scale"), (n, ml.kv_lora), "bfloat16"),
            (("layers", 1, "attn", "k_up"), (n, ml.kv_lora, H, ml.qk_nope), "bfloat16"),
            (("layers", 1, "attn", "v_up"), (n, ml.kv_lora, H, ml.v_head), "bfloat16"),
            (("layers", 1, "attn", "wo"), (n, H, ml.v_head, D), "bfloat16"),
            (("layers", 1, "ffn", "router"), (n, D, m.num_experts), "float32"),
            (("layers", 1, "ffn", "wi"), (n, m.num_experts, D, m.d_expert), "bfloat16"),
            (("layers", 1, "ffn", "wo"), (n, m.num_experts, m.d_expert, D), "bfloat16"),
            (("layers", 1, "ffn", "shared", "wi"), (n, D, m.d_expert * m.num_shared),
             "bfloat16")]
    m = cfg.moe  # MoE: the router fp32 beside the bf16 experts
    ffn = [(("layers", 0, "ffn", "wi"), (L, D, cfg.d_ff), "bfloat16")] if m is None else [
        (("layers", 0, "ffn", "router"), (L, D, m.num_experts), "float32"),
        (("layers", 0, "ffn", "wi"), (L, m.num_experts, D, m.d_expert), "bfloat16"),
        (("layers", 0, "ffn", "wo"), (L, m.num_experts, m.d_expert, D), "bfloat16")]
    dense = ffn + [
        (("layers", 0, "attn", "wq"), (L, D, H, hd), "bfloat16"),
        (("layers", 0, "attn", "wk"), (L, D, KV, hd), "bfloat16"),
        (("layers", 0, "attn", "wo"), (L, H, hd, D), "bfloat16"),
        (("layers", 0, "ln1", "scale"), (L, D), "bfloat16"),
        (("layers", 0, "ln1", "bias"), (L, D) if cfg.norm == "layernorm" else None, "bfloat16"),
        (("layers", 0, "ln2", "scale"), None if cfg.parallel_block else (L, D), "bfloat16")]
    for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
        dense.append((("layers", 0, "attn", name), (L, heads, hd) if cfg.qkv_bias else None,
                      "bfloat16"))
    return head + dense


def _expected_launches(cfg):
    """Launches in one served run: a prefill, then GEN decode steps.  An
    ``mla`` block runs the flash kernel in prefill and decodes in the
    latent space, with no kernel.  The encoder-decoder runs it in each
    encoder layer and twice in each decoder layer (self and cross), and
    the decode kernel in each decoder layer a step (its cross decode is
    plain)."""
    zero = {"flash_attention_fwd": 0, "flash_decode": 0, "mamba2_scan": 0, "rwkv6_scan": 0}
    if cfg.enc_dec is not None:
        return dict(zero, flash_attention_fwd=cfg.enc_dec.n_enc_layers + 2 * cfg.n_layers,
                    flash_decode=cfg.n_layers * GEN)
    n = {kind: sum(b == kind for b in cfg.blocks)
         for kind in ("attn", "shared_attn", "mla", "mamba2", "rwkv6")}
    n_attn = n["attn"] + n["shared_attn"]
    return {"flash_attention_fwd": n_attn + n["mla"], "flash_decode": n_attn * GEN,
            "mamba2_scan": n["mamba2"], "rwkv6_scan": n["rwkv6"]}


def phase_main(torch, smi, arch, prompt, layers):
    """Serve one architecture at full width (``layers`` None: at full
    depth, else its first ``layers`` layers); returns its readings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (make_decode_step, make_generate_loop,
                                          make_prefill_step)
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    tag = f"[main {arch}]"
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        log(f"{tag} depth cut to {layers} of {cfg.n_layers} layers (full width)")
        cfg = replace(cfg, n_layers=layers, block_pattern=cfg.blocks[:layers])
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for path, shape, dname in _expected_leaves(cfg):
        leaf = params
        for key in path:
            leaf = leaf.get(key) if isinstance(leaf, dict) else leaf[key]
            if leaf is None:
                break
        if shape is None:
            if leaf is not None:
                raise AssertionError(f"{arch}: parameter {path} should not exist")
        elif leaf is None or tuple(leaf.shape) != shape or leaf.dtype != dtypes[dname]:
            raise AssertionError(f"{arch}: parameter {path} is "
                                 f"{None if leaf is None else (tuple(leaf.shape), leaf.dtype)}, "
                                 f"expected {shape} {dname}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    floor_ms = n_bytes / H100.hbm_bw * 1e3
    log(f"{tag} {n_params / 1e9:.3f} B parameters ({n_bytes / 1e9:.2f} GB) initialised on "
        f"the card in {t_init:.1f} s (peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
        f"allocated); reading them once takes {floor_ms:.3f} ms at the datasheet rate (the "
        f"decode-step floor)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, prompt), generator=gen,
                                     device="cuda")}
    if cfg.visual_stub:  # as launch/serve.py: seeded patch embeddings over the first slots
        batch["visual_embeds"] = torch.randn((BATCH, N_IMG, cfg.d_model), generator=gen,
                                             device="cuda")
    if cfg.enc_dec is not None:  # as launch/serve.py: seeded frame embeddings
        batch["frames"] = torch.randn((BATCH, cfg.enc_dec.n_audio_ctx, cfg.d_model),
                                      generator=gen, device="cuda")
    max_len = prompt + GEN + 1
    prefill = make_prefill_step(model, max_len)
    generate = make_generate_loop(model, GEN)

    generate(params, batch, max_len)  # warm-up (allocator, cuBLAS heuristics)
    torch.cuda.synchronize()
    t_prefill = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill.append(time.perf_counter() - t0)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = generate(params, batch, max_len)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"{tag} launches during the served run: {counts}")
    want = _expected_launches(cfg)
    if counts != want:
        raise AssertionError(f"{arch}: launch counts {counts}, expected {want}")
    if toks.shape != (BATCH, GEN) or toks.min().item() < 0 \
            or toks.max().item() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: bad tokens: shape {tuple(toks.shape)}, "
                             f"range {toks.min().item()}..{toks.max().item()}")
    pf_ms = min(t_prefill) * 1e3
    dec_ms = (t_gen * 1e3 - pf_ms) / GEN
    log(f"{tag} prefill {pf_ms:.2f} ms (min of {[round(t * 1e3, 2) for t in t_prefill]}), "
        f"decode {dec_ms:.3f} ms/step (floor {floor_ms:.3f}), {BATCH * GEN / t_gen:.1f} tok/s "
        f"(generate {t_gen * 1e3:.1f} ms for {BATCH}x{GEN} tokens, prompt {prompt}) on {smi}")

    # where the time goes: a profiled prefill and a profiled window of decode steps
    (lk, ck), pf_prof = _profile(torch, f"{arch} prefill", lambda: prefill(params, batch), cfg)
    kdec = make_decode_step(model)
    tok = lk[:, :cfg.vocab_size].argmax(-1)

    def decode_window(n=8):
        for t in range(n):
            pos = torch.full((BATCH,), prompt + t, dtype=torch.int32, device="cuda")
            kdec(params, ck, tok, pos)

    _, dec_prof = _profile(torch, f"{arch} decode x8", decode_window, cfg)
    if cfg.enc_dec is not None:
        _check_enc_dec_cache(torch, tag, cfg, ck, max_len)
    del ck

    # teacher-forced parity: kernel path vs plain path, both fed the served
    # tokens (the prefill's argmax, then each step's)
    V = cfg.vocab_size
    inputs = torch.cat([tok[:, None], toks[:, :-1]], dim=1)
    plain = build_model(replace(cfg, attn_impl="ref", scan_impl="ref"))
    routes = {"plain": [], "kernel": [], "floor": []}  # MoE: each run's routing, layer by layer
    with _routing(cfg, routes["plain"]):
        want = _teacher_forced(torch, make_prefill_step(plain, max_len), make_decode_step(plain),
                               params, batch, inputs, prompt)
    with _routing(cfg, routes["kernel"]):
        got = _teacher_forced(torch, prefill, kdec, params, batch, inputs, prompt)
    for t in range(GEN):
        if not torch.equal(got[0][t + 1][:, :V].argmax(-1), toks[:, t]):
            raise AssertionError(f"{arch} step {t}: the served tokens are not the kernel "
                                 f"path's argmax")
    agree = sum((g[:, :V].argmax(-1) == w[:, :V].argmax(-1)).sum().item()
                for g, w in zip(got[0][1:], want[0][1:]))
    log(f"{tag} greedy choice of the kernel and plain paths agrees on "
        f"{agree}/{BATCH * GEN} tokens")
    floor = None
    if arch not in FIXED_LIMIT_PATHS:
        # held to twice the noise floor, per leaf kind.  The floor is the
        # plain path with the kernels' arithmetic (fp32 on the same bf16
        # values; the scans at the kernels' chunks).  For the SSM paths the
        # logits alone do not resolve every state fault (a zeroed prefill
        # state moves zamba2's logits by less than the floor allows); the
        # primed cache, compared leaf by leaf, does.
        sound = {"relative": _rel_by_kind(got, want, V),
                 "fixed_limit": _parity(f"{arch} kernel path (read only; held to the floor "
                                        f"below)", got, want)}
        del got
        with _planted(ops, **_floor_serve(cfg)), _routing(cfg, routes["floor"]):
            floor = _rel_by_kind(_teacher_forced(torch, make_prefill_step(plain, max_len),
                                                 make_decode_step(plain), params, batch,
                                                 inputs, prompt), want, V)
        what = "scan" if cfg.mamba is not None or cfg.rwkv is not None else "attention"
        log(f"{tag} noise floor (plain path, {what} in the kernels' arithmetic, vs plain "
            f"path): relative rms error by leaf {_fmt(floor)}")
        if cfg.moe is not None:
            sound["routing"] = _routing_report(tag, cfg, routes)
        sound["relative_limit"] = {k: 2 * v + 1e-3 for k, v in floor.items()}
        sound["ratio_to_floor"] = max(v / floor[k] for k, v in sound["relative"].items())
        bad = _beyond_floor(sound["relative"], floor)
        log(f"{tag} kernel path: relative rms error by leaf {_fmt(sound['relative'])} "
            f"(at most {sound['ratio_to_floor']:.3f} x the floor); limit 2 x floor + 1e-3 per "
            f"leaf kind: {'FAIL ' + str(bad) if bad else 'ok'}")
        if bad:
            raise AssertionError(f"{arch}: kernel-path leaves {bad} differ from the plain path "
                                 f"by more than twice the noise floor")
    else:
        sound = _parity(f"{arch} kernel path", got, want)
        if sound["logits_beyond"] or sound["cache_beyond"]:
            raise AssertionError(f"{arch}: kernel-path logits or cache differ from the plain "
                                 f"path beyond atol {LIMIT_ATOL} + rtol {LIMIT_RTOL}: {sound}")
        del got

    # controls: the same check on paths with planted faults
    controls = []
    for fault, must_catch, target, patch in _faults(torch, ops, cfg):
        with _planted(target, **patch):
            out = _teacher_forced(torch, prefill, kdec, params, batch, inputs, prompt)
        if floor is not None:
            reading = {"relative": _rel_by_kind(out, want, V)}
            caught = bool(_beyond_floor(reading["relative"], floor))
            log(f"{tag} control, {fault}: relative rms error by leaf "
                f"{_fmt(reading['relative'])}; {'rejected' if caught else 'NOT rejected'}")
        else:
            reading = _parity(f"{arch} control, {fault}", out, want)
            caught = bool(reading["logits_beyond"] or reading["cache_beyond"])
        del out
        if must_catch and not caught:
            raise AssertionError(f"{arch} control {fault}: the limit does not reject it")
        controls.append(dict(reading, fault=fault, caught=caught))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_s = time.perf_counter() - t_phase
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"{tag} peak {peak_gb:.2f} GB allocated of the card's {total_gb:.2f} GB; "
        f"phase {phase_s:.1f} s")
    if peak_gb > SERVE_MEM_SHARE * total_gb:
        raise AssertionError(f"{arch}: peak {peak_gb:.2f} GB exceeds {SERVE_MEM_SHARE:.0%} of "
                             f"the card: cut its depth in PATHS")
    return {"arch": arch, "layers": cfg.n_layers, "prompt": prompt, "params": n_params,
            "peak_gb": peak_gb, "phase_s": phase_s, "decode_floor_ms": floor_ms,
            "prefill_ms": pf_ms, "decode_ms_per_step": dec_ms,
            "tok_per_s": BATCH * GEN / t_gen, "launches": counts, "parity": sound,
            "greedy_agree": agree, "noise_floor": floor, "controls": controls,
            "profile": {"prefill": pf_prof, "decode_x8": dec_prof}}


@contextlib.contextmanager
def _routing(cfg, record):
    """On a MoE path, append each capacity dispatch's top-k experts and kept
    mask, (G, T, K) each, to ``record``: one entry a layer a step."""
    if cfg.moe is None:
        yield
        return
    from repro_torch.models import mlp

    slots = mlp._slots

    def recording(gate_i, E, C):
        pos, keep = slots(gate_i, E, C)
        record.append((gate_i, keep))
        return pos, keep

    with _planted(mlp, _slots=recording):
        yield


def _routing_report(tag, cfg, routes):
    """Shares of (layer, token) pairs whose top-k expert set, and whose kept
    mask (in top-k order), differ from the plain path's: the kernel path's
    and the noise floor's, over the prefill and the decode steps; and the
    share of assignments each run dropped."""
    L = sum(b in ("attn", "mla") for b in cfg.blocks) - cfg.moe.first_dense_layers
    parts = {"prefill": slice(0, L), "decode": slice(L, None)}  # one routing a layer a step

    def differ(run, part):
        n = sets = kept = 0
        for (gi, keep), (gi_w, keep_w) in zip(run[parts[part]], routes["plain"][parts[part]]):
            K = gi.shape[-1]
            sets += (gi.reshape(-1, K).sort(-1).values
                     != gi_w.reshape(-1, K).sort(-1).values).any(-1).sum()
            kept += (keep.reshape(-1, K) != keep_w.reshape(-1, K)).any(-1).sum()
            n += gi.numel() // K
        return {"pairs": n, "topk_differ": (sets / n).item(), "kept_differ": (kept / n).item()}

    def dropped(run, part):
        return (sum((~k).sum() for _, k in run[parts[part]]).item()
                / sum(k.numel() for _, k in run[parts[part]]))

    out = {}
    for name in ("kernel", "floor"):
        if len(routes[name]) != len(routes["plain"]):
            raise AssertionError(f"{tag} {name}: {len(routes[name])} routings, plain path "
                                 f"{len(routes['plain'])}")
        out[name] = {part: differ(routes[name], part) for part in parts}
        r = out[name]
        log(f"{tag} routing, {'kernel path' if name == 'kernel' else 'noise floor'} vs plain "
            f"path: top-k sets differ on {r['prefill']['topk_differ']:.3%} of "
            f"{r['prefill']['pairs']} (layer, token) pairs in prefill and "
            f"{r['decode']['topk_differ']:.3%} of {r['decode']['pairs']} in decode; kept masks "
            f"on {r['prefill']['kept_differ']:.3%} and {r['decode']['kept_differ']:.3%}")
    out["dropped"] = {name: {part: dropped(run, part) for part in parts}
                      for name, run in routes.items()}
    log(f"{tag} routing: assignments dropped (prefill / decode): " + ", ".join(
        f"{name} {d['prefill']:.3%} / {d['decode']:.3%}" for name, d in out["dropped"].items()))
    return out


def _check_enc_dec_cache(torch, tag, cfg, cache, max_len):
    """The encoder-decoder's primed cache, layer by layer: ``self`` k and v
    (B, max_len, KV, hd) and the cross ``mem_k`` and ``mem_v`` (B, H,
    n_audio_ctx, hd), in the compute dtype."""
    H, KV, hd, T = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.enc_dec.n_audio_ctx
    want = {"k": (BATCH, max_len, KV, hd), "v": (BATCH, max_len, KV, hd),
            "mem_k": (BATCH, H, T, hd), "mem_v": (BATCH, H, T, hd)}
    layers = cache["layers"]
    if len(layers) != cfg.n_layers:
        raise AssertionError(f"{tag} cache holds {len(layers)} layers, expected {cfg.n_layers}")
    for i, lc in enumerate(layers):
        for key, t in _cache_leaves(lc):
            if tuple(t.shape) != want[key] or t.dtype != cfg.compute_tdtype():
                raise AssertionError(f"{tag} cache layer {i} {key}: {tuple(t.shape)} {t.dtype}, "
                                     f"expected {want[key]} {cfg.compute_dtype}")
    log(f"{tag} primed cache: {len(layers)} layers, each self k/v {want['k']} and cross "
        f"mem_k/mem_v {want['mem_k']}: ok")


def _cache_leaves(cache):
    """(key, tensor) for every leaf of a cache tree, the key its own name."""
    if isinstance(cache, dict):
        for key, val in cache.items():
            yield from ([(key, val)] if hasattr(val, "shape") else _cache_leaves(val))
    else:
        for val in cache:
            yield from _cache_leaves(val)


def _teacher_forced(torch, prefill, decode, params, batch, inputs, prompt):
    """Prefill, then one decode step per column of ``inputs``; the logits of
    every step (prefill first), the final cache, and a copy of the cache as
    the prefill left it (the decode steps update the cache in place)."""
    from repro_torch.tree import tree_map

    logits, cache = prefill(params, batch)
    primed = tree_map(lambda t: t.clone(), cache)
    out = [logits]
    for t in range(inputs.shape[1]):
        pos = torch.full((BATCH,), prompt + t, dtype=torch.int32, device="cuda")
        logits, cache = decode(params, cache, inputs[:, t], pos)
        out.append(logits)
    return out, cache, primed


def _parity(name, got, want):
    """Logits of every step and the cache (final and as primed by the
    prefill) of a teacher-forced run against the plain path's: max abs error
    and elements beyond the limit atol + rtol * |plain|."""
    from repro_torch.tree import tree_leaves

    res = {}
    for part, g, w in (("logits", got[0], want[0]),
                       ("cache", tree_leaves([got[1], got[2]]),
                        tree_leaves([want[1], want[2]]))):
        readings = [beyond(a, b, LIMIT_ATOL, LIMIT_RTOL) for a, b in zip(g, w)]
        res[f"{part}_max_abs_err"] = max(r[0] for r in readings)
        res[f"{part}_beyond"] = sum(r[1] for r in readings)
        res[f"{part}_limit_share"] = max(r[2] for r in readings)
    log(f"[main] {name}: logits max_abs_err {res['logits_max_abs_err']:.4f} "
        f"({res['logits_beyond']} beyond the limit, {100 * res['logits_limit_share']:.0f}% "
        f"of it at most), cache max_abs_err {res['cache_max_abs_err']:.4f} "
        f"({res['cache_beyond']} beyond, {100 * res['cache_limit_share']:.0f}%); "
        f"limit atol {LIMIT_ATOL} + rtol {LIMIT_RTOL}")
    return res


def _rel_by_kind(got, want, V):
    """Relative rms error, max over the leaves of each kind: "logits" (every
    step, over the V real vocabulary entries: the padded ones are -1e30,
    whose square overflows) and each cache key (final and primed caches
    together)."""
    out = {"logits": max(_relrms(a[:, :V], b[:, :V]) for a, b in zip(got[0], want[0]))}
    for g_cache, w_cache in ((got[1], want[1]), (got[2], want[2])):
        for (key, g), (_, w) in zip(_cache_leaves(g_cache), _cache_leaves(w_cache)):
            out[key] = max(out.get(key, 0.0), _relrms(g, w))
    return out


def _relrms(a, b):
    b = b.float()
    return ((a.float() - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-30)).item()


def _beyond_floor(rel, floor):
    return sorted(k for k, v in rel.items() if not v <= 2 * floor[k] + 1e-3)


def _fmt(rel):
    return "{" + ", ".join(f"{k}: {v:.2e}" for k, v in rel.items()) + "}"


def _floor_scan(cfg):
    """Replacements for ops: the plain chunked scan with the kernel's
    arithmetic (fp32 on the same bf16 values) at the kernel's chunk."""
    from repro_torch.kernels import mamba2_scan, ref
    from repro_torch.kernels.rwkv6_scan import CHUNK

    if cfg.mamba is not None:
        def mamba2(x, dt, A, B, C, h0=None, impl="auto"):
            y, h = ref.mamba2_scan_chunked(x.float(), dt, A, B.float(), C.float(), h0,
                                           chunk=min(mamba2_scan.CHUNK, x.shape[1]))
            return y.to(x.dtype), h
        return {"mamba2": mamba2}

    def rwkv6(r, k, v, w, u, s0=None, impl="auto"):
        y, s = ref.rwkv6_scan_chunked(r.float(), k.float(), v.float(), w, u, s0,
                                      chunk=min(CHUNK, r.shape[1]))
        return y.to(v.dtype), s
    return {"rwkv6": rwkv6}


def _attention_f32():
    """Replacements for ops: the plain attention and decode in the kernels'
    arithmetic (fp32 on the same bf16 values), differentiable."""
    from repro_torch.kernels import ref

    def attention(q, k, v, causal=True, scale=None, impl="auto"):
        return ref.attention_blockwise(q.float(), k.float(), v.float(), causal,
                                       scale).to(q.dtype)

    def decode_attention(q, k, v, length, scale=None, impl="auto"):
        return ref.decode_attention_naive(q.float(), k.float(), v.float(), length,
                                          scale).to(q.dtype)

    return {"attention": attention, "decode_attention": decode_attention}


def _floor_serve(cfg):
    """The noise floor's replacements for ops on a served path: the scan
    of an SSM path, else both attention kernels."""
    if cfg.mamba is not None or cfg.rwkv is not None:
        return _floor_scan(cfg)
    return _attention_f32()


def _faults(torch, ops, cfg):
    """(fault, whether the limit must reject it, the module patched,
    replacements for its functions).  Each replacement calls the sound
    function (and so the kernel) on altered inputs or alters its
    outputs."""
    if cfg.mamba is not None:
        mamba2 = ops.mamba2

        def dt_halved(x, dt, A, B, C, h0=None, impl="auto"):
            return mamba2(x, dt * 0.5, A, B, C, h0, impl)

        def state_zeroed(x, dt, A, B, C, h0=None, impl="auto"):
            y, h = mamba2(x, dt, A, B, C, h0, impl)
            return y, torch.zeros_like(h)

        return [("prefill scan fed dt/2", True, ops, {"mamba2": dt_halved}),
                ("prefill scan's final state zeroed", True, ops, {"mamba2": state_zeroed})]
    if cfg.rwkv is not None:
        rwkv6 = ops.rwkv6

        def wkv_zeroed(r, k, v, w, u, s0=None, impl="auto"):
            y, s = rwkv6(r, k, v, w, u, s0, impl)
            return y, torch.zeros_like(s)

        def w_halved(r, k, v, w, u, s0=None, impl="auto"):
            return rwkv6(r, k, v, w * 0.5, u, s0, impl)

        return [("prefill scan's final state zeroed", True, ops, {"rwkv6": wkv_zeroed}),
                ("prefill scan fed w/2", True, ops, {"rwkv6": w_halved})]
    attention, decode_attention = ops.attention, ops.decode_attention
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    # query head h at position (h % KV) * G + h // KV reads KV head h % KV
    perm = torch.tensor([(h % KV) * G + h // KV for h in range(H)], device="cuda")

    def future_key(q, k, v, causal=True, scale=None, impl="auto"):
        # one more key at the end raises the causal offset T - S by one
        return attention(q, torch.cat([k, k[:, :, -1:]], 2), torch.cat([v, v[:, :, -1:]], 2),
                         causal, scale, impl)

    def head_mod(q, k, v, length, scale=None, impl="auto"):
        qp = torch.empty_like(q)
        qp[:, perm] = q
        return decode_attention(qp, k, v, length, scale, impl)[:, perm]

    def heads_rotated(q, k, v, length, scale=None, impl="auto"):
        return decode_attention(q, k, v, length, scale, impl).roll(1, dims=1)

    def newest_dropped(q, k, v, length, scale=None, impl="auto"):
        return decode_attention(q, k, v, length - 1, scale, impl)

    prefill_fault = ("prefill rows see one future key", True, ops, {"attention": future_key})
    # with KV = H (MHA) or KV = 1 (MQA) "h % KV" is every head's own KV
    # head; there the fault hands head h the output of head h - 1
    head_fault = (("decode head h reads KV head h % KV", head_mod) if 1 < KV < H else
                  ("decode head h gets head h - 1's output", heads_rotated))
    if cfg.enc_dec is not None:
        # the encoder's self-attention run causal; the prefill's
        # cross-attention without the frames of the flash kernel's ragged
        # last key tile (1500 = 23 * 64 + 28: read, not required); the
        # decoder's self-attention decode, as on the other paths
        from repro_torch.models import whisper

        self_attn, cross_attn = whisper._self_attn, whisper._cross_attn
        T = cfg.enc_dec.n_audio_ctx
        tail = T - T % 64 if T % 64 else T - 64

        def encoder_causal(cfg_, bp, x, positions, causal):
            return self_attn(cfg_, bp, x, positions, True)

        def cross_tail_dropped(cfg_, bp, x, mem_k, mem_v):
            return cross_attn(cfg_, bp, x, mem_k[:, :, :tail], mem_v[:, :, :tail])

        return [("the encoder's self-attention runs causal", True, whisper,
                 {"_self_attn": encoder_causal}),
                (f"prefill cross-attention misses frames {tail}..{T - 1} (the last key tile)",
                 False, whisper, {"_cross_attn": cross_tail_dropped}),
                (head_fault[0], True, ops, {"decode_attention": head_fault[1]})]
    if cfg.mla is not None:
        # MLA's own decode, in the latent space (no kernel): its attention
        # over the latent cache, with the attended latents of the heads
        # rotated (head h then goes through head h's v_up with head h - 1's
        # latent), or without the newest position
        from repro_torch.models import attention as mla

        latent = mla.mla_latent_attention

        def latent_rotated(q_lat, q_pe, ckv, kpe, length, scale):
            return latent(q_lat, q_pe, ckv, kpe, length, scale).roll(1, dims=1)

        def latent_newest_dropped(q_lat, q_pe, ckv, kpe, length, scale):
            return latent(q_lat, q_pe, ckv, kpe, length - 1, scale)

        return [prefill_fault,
                ("MLA decode head h gets head h - 1's attended latent", True, mla,
                 {"mla_latent_attention": latent_rotated}),
                ("MLA decode masks out the newest cache position", False, mla,
                 {"mla_latent_attention": latent_newest_dropped})]

    # one key of 1000+ moves the logits about as much as bf16 rounding does:
    # read, not required
    return [prefill_fault,
            (head_fault[0], True, ops, {"decode_attention": head_fault[1]}),
            ("decode drops the newest key", False, ops, {"decode_attention": newest_dropped})]


@contextlib.contextmanager
def _planted(ops, **fns):
    saved = {name: getattr(ops, name) for name in fns}
    for name, fn in fns.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# the profiler ranges that _ranges sets from this script; _profile reads the
# device time of their ops and keeps their own spans out of the busy time
RANGES = ("mla", "encoder", "cross-attention")


@contextlib.contextmanager
def _ranges(torch, cfg):
    """On an MLA path, each MLA block's prefill and decode inside a profiler
    range named "mla"; on the encoder-decoder, ``encode`` inside "encoder"
    and the decoder's cross-attention (the cross K/V projections, the
    prefill's flash call, the plain cross decode) inside
    "cross-attention".  ``_profile`` reads their device time."""
    if cfg is None or (cfg.mla is None and cfg.enc_dec is None):
        yield
        return
    from repro_torch.models import attention, whisper

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    if cfg.mla is not None:
        target, fns = attention, {"mla_prefill": "mla", "mla_decode": "mla"}
    else:
        target, fns = whisper, {"encode": "encoder", "_mem_kv": "cross-attention",
                                "_cross_attn": "cross-attention",
                                "_cross_decode": "cross-attention"}
    with _planted(target, **{fn: ranged(name, getattr(target, fn)) for fn, name in fns.items()}):
        yield


def _profile(torch, name, fn, cfg=None):
    """Run ``fn`` once under torch.profiler; log wall time, the device's busy
    and idle shares, and the kernels that took the most device time; on a
    MoE path (``cfg.moe``) also the device time by part (``_moe_split``;
    on an MLA path with the MLA blocks' share).  The profiler slows the
    host, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    moe = cfg is not None and cfg.moe is not None
    torch.cuda.synchronize()
    with _ranges(torch, cfg), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                          record_shapes=moe) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies); CPU ops carry their kernels'
    # device time as well and would count it twice, and so do the device-side
    # spans of record_function ranges (ops' "plain backward: <kernel>", RANGES)
    cpu = torch.autograd.DeviceType.CPU
    rows = [e for e in prof.key_averages()
            if e.device_type != cpu and e.self_device_time_total > 0
            and not e.key.startswith("plain backward") and e.key not in RANGES]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if busy_ms == 0:
        log(f"[profile] {name}: wall {wall_ms:.2f} ms; the profiler saw no device time "
            f"(busy share not measured)")
        return out, None
    n_kernels = sum(e.count for e in rows)
    log(f"[profile] {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
        f"{n_kernels} device ops")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} {e.key[:90]}")
    # the kernel time inside the ranges ops' Functions mark around their
    # plain backward: the CPU-side range's device time is the sum of the
    # kernels its ops launched (its device-side span would add the gaps)
    plain_bwd = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == cpu and e.key.startswith("plain backward")}
    for key, ms in sorted(plain_bwd.items()):
        log(f"[profile]   {key}: {ms:.3f} ms device, {100 * ms / busy_ms:.1f}% of the busy time"
            if ms > 0 else f"[profile]   {key}: device time not measured (0 attributed)")
    reading = {"wall_ms": wall_ms, "busy_ms": busy_ms, "device_ops": n_kernels,
               "plain_backward_ms": plain_bwd}
    if moe:
        reading["parts_ms"] = _moe_split(prof, cfg, plain_bwd)
    elif cfg is not None and cfg.enc_dec is not None:
        # the ranges' CPU-side events: the device time of the ops inside
        # (the forward's, and a remat recomputation's; not the backward's)
        parts = {key: sum(e.device_time_total for e in prof.key_averages()
                          if e.device_type == cpu and e.key == key) / 1e3
                 for key in ("encoder", "cross-attention")}
        reading["parts_ms"] = {"encoder": parts["encoder"],
                               "decoder cross-attention (its flash calls, the cross K/V "
                               "projections, the plain cross decode)": parts["cross-attention"],
                               "rest": busy_ms - sum(parts.values())}
    for part, ms in reading.get("parts_ms", {}).items():
        log(f"[profile]   {part}: {ms:.3f} ms device, {100 * ms / busy_ms:.1f}% of the busy "
            f"time")
    return out, reading


def _moe_split(prof, cfg, plain_bwd):
    """Device ms of a profiled MoE run by part, from the aten ops that launch
    the kernels (forward, remat recompute and backward alike): the experts'
    products (``bmm`` batched over the E experts), the dispatch and combine
    (the gathers and their ``index_add_`` backward, the slot table's
    ``scatter_``, the combine's weighted sum: ``bmm`` with a unit dimension)
    and attention (the flash and decode kernels and ops' plain attention
    backward).  On an MLA path also the MLA blocks whole (projections,
    latent attention, the flash kernel: the "mla" ranges of
    ``_ranges``), attention among them.  Routing, norms, the other
    projections and the head are the rest."""
    from torch.autograd import DeviceType

    parts = {"moe expert products": 0.0, "moe dispatch/combine": 0.0, "attention": 0.0}
    if cfg.mla is not None:
        parts["mla (attention among it)"] = sum(
            e.device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key == "mla") / 1e3
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU:
            if re.search(r"\b(fa_fwd|decode)_(bf16|f32)\b", e.key):  # the ctypes-launched kernels
                parts["attention"] += e.self_device_time_total / 1e3
            continue
        shape = e.input_shapes[0] if e.input_shapes else []
        if e.key == "aten::bmm" and len(shape) == 3:
            if shape[0] == cfg.moe.num_experts:
                parts["moe expert products"] += e.device_time_total / 1e3
            elif 1 in shape[1:]:
                parts["moe dispatch/combine"] += e.device_time_total / 1e3
        elif e.key in ("aten::index_select", "aten::index_add_") or \
                (e.key == "aten::scatter_" and len(shape) == 1):  # not one_hot's scatter_
            parts["moe dispatch/combine"] += e.device_time_total / 1e3
    parts["attention"] += plain_bwd.get("plain backward: attention", 0.0)
    return parts


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
# the reference's custom-VJP test limits (tests/test_kernels.py), atol = rtol
GRAD_TOL = {"attention": 2e-4, "mamba2": 2e-3, "rwkv6": 2e-3}
# full-width train paths: (arch, layers kept (None: all), batch, seq).  rwkv6-7b
# keeps 4 of its 32 layers: params, grads, master, m and v take ~16 B a
# parameter, ~121 GB at 7.58 B; its plain chunked WKV backward builds a
# (B, 64, 64, H, K) fp32 decay tensor a chunk, 0.54 GB a chunk at batch 8
# (batch 4 peaked at 33.4 GB on an H100 80GB HBM3, 700 W).
# gemma-2b (tied head: the embedding's gradient sums its two uses) trains at
# batch 6, the largest that fits: its step peaked at 69.34 GB of the card's
# 85.02 GB (NVIDIA H100 80GB HBM3, 700.00 W), each sequence adds 5.35 GB
# (the loss chunk's fp32 logits over the 256,000-token vocab), and batch 8
# ran out of memory.  Every step's peak must stay within TRAIN_MEM_SHARE of
# the card.
# granite-moe-3b-a800m trains under its config's remat policy, "dots", at full
# width with 16 of its 32 layers: state at ~16 B a parameter is ~54 GB at
# full depth (3.375 B), and the kernel-vs-plain parity step holds a second
# copy beside it; at 16 layers (1.763 B) the state is ~28 GB, ~63 GB with
# the copy and the plain step's master.  whisper-tiny trains at full depth on
# its published text context, 448 tokens, against 1500 frame embeddings a
# sequence.
TRAIN_PATHS = (("tinyllama-1.1b", None, 8, 1024), ("zamba2-1.2b", None, 8, 1024),
               ("rwkv6-7b", 4, 8, 1024), ("gemma-2b", None, 6, 1024),
               ("granite-moe-3b-a800m", 16, 8, 1024), ("whisper-tiny", None, 8, 448))
TRAIN_MEM_SHARE = 0.85
TRAIN_STEPS = 4
TRAIN_LR = 1e-3


def _dropping(fn_cls, index):
    """``fn_cls`` with a planted fault: its backward returns zeros for input
    ``index``."""
    class Dropped(fn_cls):
        @staticmethod
        def backward(ctx, *grads):
            out = list(fn_cls.backward(ctx, *grads))
            out[index] = out[index].new_zeros(out[index].shape)
            return tuple(out)
    return Dropped


def _grad_case(torch, ops, name, fwd, args, tol, fn_cls, drop, label=""):
    """Kernel forward + plain backward (ops' Function, ``impl="cuda"``)
    against plain autograd (``impl="ref"``), end to end through a loss that
    reads every output; then the same with the backward dropping input
    ``drop``'s gradient, which the limit must reject.  ``label`` tells
    the log lines of two cases of one kernel apart."""
    def grads(impl):
        xs = [a.detach().requires_grad_() for a in args]
        outs = fwd(*xs, impl=impl)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() ** 2).sum() for o in outs)
        return torch.autograd.grad(loss, xs)

    before = ops.launch_counts()[name]
    got = grads("cuda")
    if ops.launch_counts()[name] != before + 1:
        raise AssertionError(f"{name}: the Function's forward did not launch the kernel")
    want = grads("ref")
    errs = [assert_close(f"grad {name}{label} fp32 d{i}", g, w, tol)
            for i, (g, w) in enumerate(zip(got, want))]
    with _planted(ops, **{fn_cls.__name__: _dropping(fn_cls, drop)}):
        faulty = grads("cuda")
    err, bad, _ = beyond(faulty[drop], want[drop], tol, tol)
    log(f"[grads] control, {name}{label} backward drops d{drop}: {bad} elements beyond "
        f"{tol:g} (max_abs_err {err:.3e}): {'rejected' if bad else 'NOT rejected'}")
    if not bad:
        raise AssertionError(f"{name}: a backward that drops d{drop} is not rejected")
    return {"max_abs_err": max(errs), "tol": tol, "control_beyond": bad}


def phase_grads(torch):
    """The three autograd Functions on the card in fp32, at small shapes;
    the attention Function also as MLA calls it (D = 192, V zero-padded
    from 128 and sliced back, scale 192^-0.5) and full (non-causal) with S
    != T, as the encoder-decoder's cross-attention calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    # the reference's custom-VJP tests are at (1, 2, 64, 32) and (1, 64, 2, 8):
    # small shapes the kernels take (D = 64; P, N, K = 16), with two chunks of
    # each plain backward
    gen = torch.Generator(device="cuda").manual_seed(3)
    f32 = torch.float32
    q, k, v = _prefill_inputs(torch, gen, 1, 4, 2, 128, 128, 64, f32)
    x, dt, A, Bm, Cm, _ = _mamba_inputs(torch, gen, 1, 256, 2, 16, 1, 16, f32)
    r, kk, vv, w, u, _ = _rwkv_inputs(torch, gen, 1, 128, 2, 16, f32)
    qm, km, vm = _prefill_inputs(torch, gen, 1, 4, 4, 128, 128, 192, f32)
    qf, kf, vf = _prefill_inputs(torch, gen, 1, 6, 6, 100, 300, 64, f32)

    def mla_attention(q, k, v, impl):
        return ops.attention(q, k, F.pad(v, (0, 64)), True, 192 ** -0.5, impl=impl)[..., :128]

    def full_attention(q, k, v, impl):
        return ops.attention(q, k, v, False, impl=impl)

    out = {
        "attention": _grad_case(torch, ops, "flash_attention_fwd", ops.attention, (q, k, v),
                                GRAD_TOL["attention"], ops._AttentionFn, 1),
        "attention_mla": _grad_case(torch, ops, "flash_attention_fwd", mla_attention,
                                    (qm, km, vm[..., :128]), GRAD_TOL["attention"],
                                    ops._AttentionFn, 1, " (MLA: D = 192, V padded from 128)"),
        "attention_full": _grad_case(torch, ops, "flash_attention_fwd", full_attention,
                                     (qf, kf, vf), GRAD_TOL["attention"], ops._AttentionFn, 1,
                                     " (full, S = 100 vs T = 300, as cross-attention)"),
        "mamba2": _grad_case(torch, ops, "mamba2_scan", ops.mamba2, (x, dt, A, Bm, Cm),
                             GRAD_TOL["mamba2"], ops._Mamba2Fn, 0),
        "rwkv6": _grad_case(torch, ops, "rwkv6_scan", ops.rwkv6, (r, kk, vv, w, u),
                            GRAD_TOL["rwkv6"], ops._RWKV6Fn, 1),
    }
    log("[grads] " + json.dumps(out))
    return out


def _train_config(arch, layers):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is not None:
        cfg = replace(cfg, n_layers=layers, block_pattern=cfg.blocks[:layers])
    return cfg


def _expected_train_launches(cfg):
    """Kernel launches in one train step: each layer's forward, and again
    in its recomputation under remat; the backward is plain torch.  The
    encoder-decoder's encoder layers run outside remat, once."""
    per = 2 if cfg.remat else 1
    if cfg.enc_dec is not None:
        return dict(_expected_launches(cfg), flash_decode=0,
                    flash_attention_fwd=cfg.enc_dec.n_enc_layers + per * 2 * cfg.n_layers)
    return {k: 0 if k == "flash_decode" else per * n for k, n in _expected_launches(cfg).items()}


def _floor_train(torch, cfg):
    """Replacements for ops: plain, differentiable attention and scans in
    the kernels' arithmetic (fp32 on the same bf16 values; the scans at the
    kernels' chunks)."""
    return dict(_floor_scan(cfg) if cfg.mamba is not None or cfg.rwkv is not None else {},
                attention=_attention_f32()["attention"])


def _train_control(ops, cfg):
    """(fault, replacements for ops): the kernel path with a backward that
    drops the gradient of an input the model trains through."""
    if cfg.mamba is not None:
        return "mamba2 backward drops ddt", {"_Mamba2Fn": _dropping(ops._Mamba2Fn, 1)}
    if cfg.rwkv is not None:
        return "rwkv6 backward drops dk", {"_RWKV6Fn": _dropping(ops._RWKV6Fn, 1)}
    return "attention backward drops dk", {"_AttentionFn": _dropping(ops._AttentionFn, 1)}


def phase_train(torch, smi, arch, layers, batch_size, seq):
    """Train one architecture at full width: timed steps, a profiled step,
    and one step on the kernel path against the plain path (where a copy of
    the state fits beside a step)."""
    from repro_torch.bridge import leaf_names
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves, tree_map
    import numpy as np

    cfg = _train_config(arch, layers)
    tag = f"[train {arch}]"
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    model = build_model(cfg)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(4)
    seqs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch_size, seq + 1))).cuda()
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    if cfg.enc_dec is not None:  # seeded frame embeddings, as the reference's test batches
        batch["frames"] = torch.randn((batch_size, cfg.enc_dec.n_audio_ctx, cfg.d_model),
                                      generator=torch.Generator(device="cuda").manual_seed(5),
                                      device="cuda")

    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, opt_cfg, torch.Generator(device="cuda").manual_seed(0))
    names = leaf_names(state["params"])
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    step = make_train_step(model, opt_cfg)
    want = _expected_train_launches(cfg)
    times, losses, gnorms, launches, auxes = [], [], [], [], []
    for i in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _aux_recorded(auxes):
            state, met = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        launches.append(counts)
        losses.append(met["loss"].item())
        gnorms.append(met["grad_norm"].item())
        if counts != want:
            raise AssertionError(f"{arch} train step {i + 1}: launch counts {counts}, "
                                 f"expected {want}")
    auxes = [a.item() for a in auxes]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = min(times[1:]) * 1e3
    tok_s = batch_size * seq / (step_ms / 1e3)
    depth = (f"{cfg.n_layers} of {_train_config(arch, None).n_layers} layers kept" if layers
             else f"{cfg.n_layers} layers")
    log(f"{tag} {n_params / 1e9:.3f} B parameters ({depth}), batch {batch_size} x seq {seq}, "
        f"remat {'on' if cfg.remat else 'off'}, bf16, AdamW lr {TRAIN_LR:g} warmup 1: step "
        f"{step_ms:.2f} ms (min of steps 2-{TRAIN_STEPS}: "
        f"{[round(t * 1e3, 2) for t in times]}), {tok_s:.0f} tok/s, peak "
        f"{peak_gb:.2f} GB allocated, on {smi}")
    log(f"{tag} loss {losses[0]:.4f} -> {losses[-1]:.4f} ({[round(x, 4) for x in losses]}), "
        f"grad norm {[round(x, 4) for x in gnorms]}")
    if cfg.moe is not None:
        log(f"{tag} the loss is xent + aux: aux {[round(a, 6) for a in auxes]}, xent "
            f"{[round(x - a, 4) for x, a in zip(losses, auxes)]}")
    log(f"{tag} launches per step: {launches[0]} (expected {want}, every step)")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{arch}: a loss or grad norm is not finite: {losses}, {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall over {TRAIN_STEPS} steps on one "
                             f"repeated batch: {losses}")
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    if peak_gb > TRAIN_MEM_SHARE * total_gb:
        raise AssertionError(f"{arch}: a train step peaked at {peak_gb:.2f} GB, beyond "
                             f"{TRAIN_MEM_SHARE:.0%} of the card's {total_gb:.2f} GB")

    _, prof = _profile(torch, f"{arch} train step", lambda: step(state, batch), cfg)
    del met
    readings = {"arch": arch, "layers": cfg.n_layers, "params": n_params, "batch": batch_size,
                "seq": seq, "step_ms": step_ms, "step_times_ms": [t * 1e3 for t in times],
                "tok_per_s": tok_s, "peak_gb": peak_gb, "losses": losses, "aux": auxes,
                "grad_norms": gnorms,
                "launches_per_step": launches[0],
                "launches": {k: sum(c[k] for c in launches) for k in launches[0]},
                "profile": prof}

    if cfg.remat and cfg.remat_policy == "dots":
        readings["dots_vs_remat_off"] = _dots_parity(torch, tag, cfg, state, batch)
    if cfg.enc_dec is not None:
        readings["codec"] = _codec_check(torch, tag, model, state, batch)

    # the parity steps hold a copy of the state and the plain step's master
    # beside a step
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    master_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state["opt"]["master"]))
    need_gb = peak_gb + (state_bytes + master_bytes) / 1e9
    if need_gb > 0.9 * total_gb:
        log(f"{tag} one step kernel vs plain path: not run; with a copy of the "
            f"{state_bytes / 1e9:.2f} GB state and the plain step's master beside a step it "
            f"needs ~{need_gb:.1f} GB of the card's {total_gb:.2f} GB (the CPU tests hold this "
            f"arch's loss and grads against the reference's)")
        del state
        readings.update(parity=None, phase_s=time.perf_counter() - t_phase)
        return readings

    # parity: one step from the state the steps above left (its moments
    # populated, so the update is no longer sign(g)) on the kernel path, the
    # plain path, the plain path in the kernels' arithmetic (the noise
    # floor) and the kernel path with a planted backward fault
    plain = build_model(replace(cfg, attn_impl="ref", scan_impl="ref"))
    base = tree_map(lambda t: t.clone(), state)

    def one_step(m, patch):
        tree_map(lambda dst, src: dst.copy_(src), state, base)
        with _planted(ops, **patch):
            _, met = make_train_step(m, opt_cfg)(state, batch)
        return {"loss": met["loss"].item(), "grad_norm": met["grad_norm"].item(),
                "master": tree_leaves(state["opt"]["master"])}

    ref_out = one_step(plain, {})
    ref_out["master"] = [t.clone() for t in ref_out["master"]]
    # the plain step's update per leaf: the scale of a master's error
    ref_out["update_norm"] = [(a - b).norm() for a, b in
                              zip(ref_out["master"], tree_leaves(base["opt"]["master"]))]

    def rel(out):
        return {"loss": abs(out["loss"] - ref_out["loss"]) / abs(ref_out["loss"]),
                "grad_norm": abs(out["grad_norm"] - ref_out["grad_norm"]) / ref_out["grad_norm"],
                **{f"master {n}": ((a - b).norm() / u.clamp_min(1e-30)).item() for n, a, b, u in
                   zip(names, out["master"], ref_out["master"], ref_out["update_norm"])}}

    floor = rel(one_step(plain, _floor_train(torch, cfg)))
    limit = {key: 2 * val + 1e-3 for key, val in floor.items()}
    kernel = rel(one_step(model, {}))
    fault, patch = _train_control(ops, cfg)
    control = rel(one_step(model, patch))

    def summary(r):
        worst = max((k for k in r if k.startswith("master")), key=lambda k: r[k] / limit[k])
        return (f"loss {r['loss']:.2e}, grad norm {r['grad_norm']:.2e}, master worst "
                f"{worst[7:]} {r[worst]:.2e} (limit {limit[worst]:.2e})")

    bad = sorted(k for k, v in kernel.items() if not v <= limit[k])
    caught = sorted(k for k, v in control.items() if not v <= limit[k])
    log(f"{tag} one step, kernel path vs plain path (relative; master: error norm over the "
        f"plain step's update norm, per leaf): {summary(kernel)}; noise floor (plain path in "
        f"the kernels' arithmetic): {summary(floor)}; limit 2 x floor + 1e-3 each: "
        f"{'FAIL ' + str(bad) if bad else 'ok'}")
    log(f"{tag} control, {fault}: {summary(control)}; "
        f"{'rejected on ' + str(len(caught)) + ' readings' if caught else 'NOT rejected'}")
    if bad:
        raise AssertionError(f"{arch}: the kernel path's train step differs from the plain "
                             f"path beyond twice the noise floor on {bad}")
    if not caught:
        raise AssertionError(f"{arch} train control {fault}: the limit does not reject it")
    del ref_out, base, state
    peak_all_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} peak {peak_all_gb:.2f} GB allocated with the parity steps (the state, "
        f"its copy and the plain step's master held beside a step)")
    worst = max(kernel, key=lambda k: kernel[k] / limit[k])
    readings.update(
        peak_with_parity_gb=peak_all_gb, phase_s=time.perf_counter() - t_phase,
        parity={"kernel": {k: kernel[k] for k in ("loss", "grad_norm")},
                "kernel_worst": [worst, kernel[worst], limit[worst]],
                "floor": {k: floor[k] for k in ("loss", "grad_norm")},
                "control": fault, "control_caught": len(caught)})
    return readings


def _codec_check(torch, tag, model, state, batch):
    """The int8 gradient codec over one step's gradients on the card: the
    deterministic path (no error state, then the first round's error
    carried) equals the same calls on CPU copies bit for bit; the second
    round keeps x_hat + err = x + err_in at 1e-6; the stochastic path (a
    card generator) lands every value on one of the two integers around
    it."""
    from repro_torch.bridge import leaf_names
    from repro_torch.optim import compress_grads, quantize_int8
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
    with torch.enable_grad():
        loss = model.loss(params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(
            loss, tree_leaves(params), allow_unused=True, materialize_grads=True))
    del params, loss
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xhat, err = compress_grads(grads)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    xhat2, err2 = compress_grads(grads, err)
    cpu = tree_map(lambda t: t.cpu(), grads)
    cxhat, cerr = compress_grads(cpu)
    cxhat2, cerr2 = compress_grads(cpu, cerr)
    names = [f"{part} {n}" for part in ("x_hat", "error", "x_hat round 2", "error round 2")
             for n in leaf_names(grads)]
    pairs = list(zip(tree_leaves([xhat, err, xhat2, err2]),
                     tree_leaves([cxhat, cerr, cxhat2, cerr2])))
    differ = [n for n, (a, b) in zip(names, pairs) if not torch.equal(a.cpu(), b)]
    # x_hat + err = x + err_in, as the reference's test holds it: atol = rtol = 1e-6
    beyond_ef = sum(beyond(x2 + e2, g.float() + e, 1e-6, 1e-6)[1] for x2, e2, g, e in
                    zip(tree_leaves(xhat2), tree_leaves(err2), tree_leaves(grads),
                        tree_leaves(err)))
    g0 = max(tree_leaves(grads), key=lambda t: t.numel())
    q, sc = quantize_int8(g0, torch.Generator(device="cuda").manual_seed(0))
    y = g0.float() / sc
    off = ((q.float() != y.floor()) & (q.float() != y.floor() + 1)).sum().item()
    n = sum(t.numel() for t in tree_leaves(grads))
    log(f"{tag} int8 codec over the step's {len(pairs) // 4} gradient leaves ({n / 1e6:.2f} M "
        f"values) on the card in {ms:.2f} ms: {len(differ)} of {len(pairs)} outputs differ from "
        f"the CPU's (two rounds, x_hat and error){': ' + ', '.join(differ[:4]) if differ else ''}"
        f"; x_hat + err = x + err_in beyond 1e-6 on {beyond_ef} values; stochastic rounding "
        f"off its two integers on {off} of {g0.numel()}")
    if differ or beyond_ef or off:
        raise AssertionError(f"{tag} int8 codec on the card: {len(differ)} outputs differ from "
                             f"the CPU's, {beyond_ef} values break error feedback, {off} values "
                             f"rounded off their two integers")
    return {"leaves": len(pairs) // 4, "values": n, "ms": ms, "differ_from_cpu": len(differ),
            "error_feedback_beyond_1e-6": beyond_ef, "stochastic_off_bracket": off}


@contextlib.contextmanager
def _aux_recorded(record):
    """Append the aux loss of each ``lm.backbone`` call (one a loss) to
    ``record``."""
    from repro_torch.models import lm

    backbone = lm.backbone

    def recording(cfg, params, batch):
        h, aux = backbone(cfg, params, batch)
        record.append(aux.detach())
        return h, aux

    with _planted(lm, backbone=recording):
        yield


def _dots_parity(torch, tag, cfg, state, batch):
    """The ``dots`` policy's loss and grads against remat off on the same
    params: bit for bit, or within twice the spread of two ``dots`` runs per
    reading where the backward is not deterministic (the gathers' backward
    adds a token's k contributions with atomics)."""
    from repro_torch.bridge import leaf_names
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map

    def grads(c):
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        with torch.enable_grad():
            loss = build_model(c).loss(params, batch)
            return [loss.detach()] + list(torch.autograd.grad(loss, tree_leaves(params)))

    def rel(a, b):
        return [((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)).item()
                for x, y in zip(a, b)]

    names = ["loss"] + leaf_names(state["params"])
    dots = grads(cfg)
    spread = rel(grads(cfg), dots)
    off = grads(replace(cfg, remat=False))
    got = rel(off, dots)
    same = sum(torch.equal(a, b) for a, b in zip(off, dots))
    bad = [n for n, g, f in zip(names, got, spread) if not g <= 2 * f]
    worst = max(range(len(names)), key=lambda i: got[i])
    log(f"{tag} dots vs remat off, loss and {len(names) - 1} grad leaves: {same} of "
        f"{len(names)} bit for bit; loss {got[0]:.2e}; worst {names[worst]} {got[worst]:.2e} "
        f"(two dots runs: {spread[worst]:.2e}, largest spread {max(spread):.2e}); limit 2 x "
        f"that spread per reading (bit for bit where it is 0): "
        f"{'FAIL ' + str(bad[:4]) if bad else 'ok'}")
    if bad:
        raise AssertionError(f"{cfg.name}: the dots policy's loss or grads differ from remat "
                             f"off on {bad}")
    del dots, off
    return {"bit_for_bit": same, "readings": len(names), "worst": [names[worst], got[worst]],
            "largest_spread": max(spread)}


# ---------------------------------------------------------------------------
# the trainer: batch loading, write-behind checkpoints, kill and restore
# ---------------------------------------------------------------------------
# the walkthrough's shape at full width: tinyllama-1.1b in bf16, synthetic
# data (4 shards of 64 records), 8 steps of batch 8 x 1024, write-behind
# saves every 4 steps, a simulated node failure at step 6.  At 11 of its 22
# layers for time: the phase's saves and restores scale with the state
# (15.40 GB at full depth), and at full depth it took 194-245 s of a script
# that reached 1095.9 s of its 1200 on a slow host (NVIDIA H100 80GB HBM3,
# 700.00 W)
TRAINER_ARCH = "tinyllama-1.1b"
TRAINER_LAYERS = 11
TRAINER_BATCH, TRAINER_SEQ = 8, 1024
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_KILL_AT = 8, 4, 6
TRAINER_SHARDS, TRAINER_RECORDS = 4, 64
TRAINER_DIR = ROOT / "build" / "trainer"
# the planted torn snapshot runs at the smoke size: batch 4 x seq 64
TRAINER_SMOKE = (4, 64)


class _Run:
    """One ``Trainer`` on local disk through ``OSDevice`` and
    ``Foreactor(backend="io_uring", depth=32)``, wired as
    ``launch/train.py`` wires it, with its batch loads timed and an optional
    node failure at step ``kill_at``."""

    def __init__(self, cfg, batch, seq, data, root=None, kill_at=0, manager=None):
        from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
        from repro_torch.core import Foreactor, OSDevice
        from repro_torch.data import DataConfig, ShardedTokenDataset, TokenBatchLoader
        from repro_torch.models import build_model
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime import Trainer, TrainerConfig

        disk = OSDevice()
        self.fa = Foreactor(device=disk, backend="io_uring", depth=32)
        ds = ShardedTokenDataset(disk, [f"{data}/shard_{i:05d}.rio"
                                          for i in range(TRAINER_SHARDS)])
        self.loader = TokenBatchLoader(ds, DataConfig(seq_len=seq, batch_size=batch, seed=0),
                                       fa=self.fa)
        self.load_s = []
        load = self.loader.load

        def timed_load(e, s):
            if kill_at and e * self.loader.steps_per_epoch + s >= kill_at:
                raise RuntimeError(f"simulated node failure at step {kill_at}")
            t0 = time.perf_counter()
            out = load(e, s)
            self.load_s.append(time.perf_counter() - t0)
            return out

        self.loader.load = timed_load
        self.ckpt = None if root is None else (manager or CheckpointManager)(
            disk, str(root), fa=self.fa, num_shards=4)
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAINER_STEPS)
        tcfg = TrainerConfig(steps=TRAINER_STEPS, ckpt_every=TRAINER_CKPT_EVERY, log_every=1,
                             retention=CheckpointPolicy(keep_last=3))
        self.trainer = Trainer(build_model(cfg), opt, self.loader, self.ckpt, "cuda", tcfg)

    def fit(self, killed=False):
        try:
            out = self.trainer.fit()
        except RuntimeError as e:
            if not (killed and "simulated node failure" in str(e)):
                raise
            return None
        finally:
            self.loader.close()
            if self.ckpt is not None:
                self.ckpt.close()  # frees its pinned snapshot buffer
            self.fa.shutdown()
        if killed:
            raise AssertionError("the run with a node failure did not raise")
        return out

    def step_ms(self, in_flight=None):
        """Step times after the first, all or those with/without a save in
        flight at their end."""
        return [ev.seconds * 1e3 for ev in self.trainer.events[1:]
                if in_flight is None or ev.save_in_flight == in_flight]


def _leaf_diffs(a, b):
    """Per leaf of two state trees, the norm of a - b (0 iff the leaves are
    equal; across runs it varies far less than the largest element's
    difference does)."""
    from repro_torch.tree import tree_leaves

    return [(x.float() - y.float()).norm().item() for x, y in zip(tree_leaves(a), tree_leaves(b))]


def _ulp(t):
    """One rounding step of a floating leaf at its largest magnitude (0 for
    integer leaves)."""
    import torch

    if not t.is_floating_point() or not t.numel():
        return 0.0
    m = t.abs().max().float().item()
    return torch.finfo(t.dtype).eps * 2.0 ** math.floor(math.log2(m)) if m else 0.0


def _resume_check(tag, names, resumed, cont, spread):
    """Resume equals continuous: bit for bit where two continuous runs
    agree bit for bit, else every state leaf within twice their spread
    (norms of the differences, per leaf).  A leaf's spread counts as at
    least one rounding step at its largest magnitude: one pair of runs can
    miss a one-step flip in a small leaf.
    Logs the reading; returns (rule, leaves beyond it, worst leaf)."""
    from repro_torch.tree import tree_leaves

    bitwise = not any(spread)
    diff = _leaf_diffs(resumed, cont)
    limit = [0.0 if bitwise else 2 * max(s, _ulp(t))
             for s, t in zip(spread, tree_leaves(cont))]
    bad = [n for n, d, lim in zip(names, diff, limit) if d > lim]
    ratio = [d / lim if lim else (math.inf if d else 0.0) for d, lim in zip(diff, limit)]
    i = max(range(len(names)), key=ratio.__getitem__)
    rule = ("bit for bit" if bitwise else
            "within 2 x the spread of two continuous runs (at least one rounding step)")
    log(f"{tag} resumed vs continuous, {rule}: {len(bad)} of {len(names)} leaves beyond; "
        f"worst {names[i]} |diff| {diff[i]:.3e} (spread {spread[i]:.3e})")
    return rule, bad, {"leaf": names[i], "diff": diff[i], "spread": spread[i]}


def _view_snapshot_manager():
    """Planted fault: a write-behind snapshot that keeps views of the live
    state, written when the trainer next waits for it, after the steps in
    between have written into those buffers (what ``.numpy()`` views give
    on the CPU)."""
    from repro_torch.checkpoint import CheckpointManager

    class ViewSnapshot(CheckpointManager):
        _deferred = None

        def save_async(self, step, tree, extra=None, delta=False):
            self.wait_pending()
            self._deferred = (step, tree, extra, delta)

        def wait_pending(self):
            super().wait_pending()
            d, self._deferred = self._deferred, None
            if d is not None:
                self.save(*d)

    return ViewSnapshot


def _resume_from_write_behind(tag, cfg, data, root, manager, names, cont, spread):
    """Kill at step 6, drop its emergency checkpoint (a hard kill leaves
    none), restore the write-behind checkpoint of step 4, finish, and hold
    the final state against the continuous run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import OSDevice

    batch, seq = TRAINER_SMOKE
    _Run(cfg, batch, seq, data, root, kill_at=TRAINER_KILL_AT, manager=manager).fit(killed=True)
    mgr = CheckpointManager(OSDevice(), str(root), num_shards=4)
    mgr._collect(TRAINER_KILL_AT)
    steps = mgr.committed_steps()
    mgr.fa.shutdown()
    if steps != [TRAINER_CKPT_EVERY]:
        raise AssertionError(f"{tag}: committed {steps}, expected [{TRAINER_CKPT_EVERY}]")
    run = _Run(cfg, batch, seq, data, root)
    out = run.fit()
    if run.trainer.events[0].step != TRAINER_CKPT_EVERY or out["final_step"] != TRAINER_STEPS:
        raise AssertionError(f"{tag}: the resumed run did not go from step "
                             f"{TRAINER_CKPT_EVERY} to {TRAINER_STEPS}")
    return _resume_check(tag, names, out["state"], cont, spread)


def _gil_probe(torch, cfg, batch, seq):
    """Train-step ms alone, beside a background thread that runs zlib.crc32
    over 64 MiB (a core and memory bandwidth busy, the GIL released while
    it runs, as the checkpoint writer's CRCs and pwrites release it), and
    beside one that holds the GIL in a Python loop (one step: it takes
    15-70 s on an H100 80GB HBM3 at 700 W): whether the step's launches
    wait for the GIL or for the host's cores."""
    import threading
    import zlib

    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAINER_STEPS)
    state = make_train_state(model, opt, torch.Generator(device="cuda").manual_seed(1))
    step = make_train_step(model, opt)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    buf = bytes(64 << 20)

    def python_loop(stop):
        while not stop.is_set():
            sum(range(1000))

    def crc_loop(stop):
        while not stop.is_set():
            zlib.crc32(buf)

    state, _ = step(state, batch)  # warm
    torch.cuda.synchronize()
    out = {}
    for name, fn, steps in (("alone", None, 2), ("crc32_thread", crc_loop, 2),
                            ("python_thread", python_loop, 1)):
        stop = threading.Event()
        th = threading.Thread(target=fn, args=(stop,), daemon=True) if fn else None
        if th:
            th.start()
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, met = step(state, batch)
            float(met["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        stop.set()
        if th:
            th.join()
        out[name] = ms
    log(f"[trainer] GIL probe, step ms: " + "; ".join(
        f"{k} {[round(x, 1) for x in v]}" for k, v in out.items()))
    return out


def _meminfo_gb(key):
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _maxrss_gb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def phase_trainer(torch, smi):
    """The walkthrough at full width through ``repro_torch.runtime.Trainer``:
    two continuous runs (the noise floor), a run killed at step 6 after a
    write-behind save at 4, a second trainer that restores the emergency
    checkpoint and finishes at 8, a validated restore of the newest
    checkpoint; then the planted torn snapshot at the smoke size."""
    import shutil

    from repro_torch.bridge import leaf_names
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import OSDevice
    from repro_torch.data import DataConfig, write_synthetic_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_state
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    tag = "[trainer]"
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    TRAINER_DIR.mkdir(parents=True)
    rss_before = _maxrss_gb()

    # size before running: three checkpoints on disk (retention keeps 3);
    # in host memory the pinned snapshot, a restore's read chunks and its
    # leaf buffers
    cfg = _train_config(TRAINER_ARCH, None)
    state = make_train_state(build_model(cfg), AdamWConfig(),
                             torch.Generator(device="cuda").manual_seed(0))
    total = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    per_layer = sum(t.numel() * t.element_size()
                    for n, t in zip(leaf_names(state), tree_leaves(state))
                    if "['layers']" in n) / cfg.n_layers
    del state
    free_gb = shutil.disk_usage(TRAINER_DIR).free / 1e9
    avail_gb = _meminfo_gb("MemAvailable")
    full_layers = cfg.n_layers
    layers = min(TRAINER_LAYERS, full_layers)
    size = lambda L: (total - per_layer * (full_layers - L)) / 1e9  # noqa: E731
    while layers > 1 and (3 * size(layers) + 2 > free_gb or 3.5 * size(layers) > avail_gb):
        layers -= 1
    log(f"{tag} free disk under {TRAINER_DIR}: {free_gb:.1f} GB, MemAvailable "
        f"{avail_gb:.1f} GB; a full-depth checkpoint {size(cfg.n_layers):.2f} GB "
        f"({cfg.n_layers} layers): " + ("no cut" if layers == cfg.n_layers else
                                        f"depth cut to {layers} layers ({size(layers):.2f} GB)"))
    if layers < cfg.n_layers:
        cfg = _train_config(TRAINER_ARCH, layers)

    data = TRAINER_DIR / "data"
    write_synthetic_dataset(OSDevice(), str(data),
                            DataConfig(seq_len=TRAINER_SEQ, batch_size=TRAINER_BATCH, seed=0),
                            TRAINER_SHARDS, TRAINER_RECORDS, cfg.vocab_size)
    root = TRAINER_DIR / "ckpt"
    B, S = TRAINER_BATCH, TRAINER_SEQ

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    c1 = _Run(cfg, B, S, data)
    cont = c1.fit()["state"]
    names = leaf_names(cont)
    c2 = _Run(cfg, B, S, data)
    spread = _leaf_diffs(c2.fit()["state"], cont)
    gc.collect()
    log(f"{tag} two continuous runs of {TRAINER_STEPS} steps: "
        + ("bit for bit equal" if not any(spread) else
           f"{sum(1 for s in spread if s)} of {len(spread)} leaves differ, largest spread "
           f"{max(spread):.3e} ({names[spread.index(max(spread))]})"))

    killed = _Run(cfg, B, S, data, root, kill_at=TRAINER_KILL_AT)
    killed.fit(killed=True)
    if killed.ckpt.committed_steps() != [TRAINER_CKPT_EVERY, TRAINER_KILL_AT]:
        raise AssertionError(f"{tag}: after the kill, committed {killed.ckpt.committed_steps()}")
    gc.collect()
    resumed = _Run(cfg, B, S, data, root)
    out = resumed.fit()
    ev = resumed.trainer.events
    if ev[0].step != TRAINER_KILL_AT or out["final_step"] != TRAINER_STEPS:
        raise AssertionError(f"{tag}: the second trainer ran steps "
                             f"{[e.step for e in ev]} to {out['final_step']}")
    rule, bad, worst = _resume_check(tag, names, out["state"], cont, spread)
    if bad:
        raise AssertionError(f"{tag}: the resumed run differs from the continuous one "
                             f"({rule}) on {bad}")

    # the newest committed checkpoint: validates and restores to the final state
    mem = {k: _meminfo_gb(k) for k in ("MemAvailable", "Cached", "Dirty")}
    log(f"{tag} host before the validated restore: " + ", ".join(
        f"{k} {v:.1f} GB" for k, v in mem.items()))
    mgr = CheckpointManager(OSDevice(), str(root), num_shards=4)
    t0 = time.perf_counter()
    got = mgr.restore_latest()
    restore_s = time.perf_counter() - t0
    if got is None or got[0] != TRAINER_STEPS or int(got[2]["step"]) != TRAINER_STEPS:
        raise AssertionError(f"{tag}: the newest checkpoint does not restore step {TRAINER_STEPS}")
    flat = got[1]
    differ = [n for n, t in zip(names, tree_leaves(out["state"]))
              if not torch.equal(flat[n].to(t.device), t)]
    if differ or not mgr.validate(TRAINER_STEPS):
        raise AssertionError(f"{tag}: the restored step {TRAINER_STEPS} differs from the "
                             f"final state on {differ}")
    ckpt_disk = sum(p.stat().st_size for p in (root / f"step_{TRAINER_STEPS:010d}").iterdir())
    mgr.fa.shutdown()
    del flat, got, out
    counts = ops.launch_counts()
    phase_s = time.perf_counter() - t_phase
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps_run = sum(len(r.trainer.events) for r in (c1, c2, killed, resumed))
    want = {k: v * steps_run for k, v in _expected_train_launches(cfg).items()}
    log(f"{tag} launches over the {steps_run} steps of the four runs: {counts} "
        f"(expected {want})")
    if counts != want:
        raise AssertionError(f"{tag}: launch counts {counts}, expected {want}")

    saves = {(r["step"], r["mode"]): r for r in killed.ckpt.save_log + resumed.ckpt.save_log}
    wb = saves[(TRAINER_CKPT_EVERY, "async")]
    em = saves[(TRAINER_KILL_AT, "sync")]
    fin = saves[(TRAINER_STEPS, "sync")]
    loads = [x * 1e3 for r in (c1, c2, killed, resumed) for x in r.load_s]
    quiet = c1.step_ms() + c2.step_ms() + killed.step_ms(False)
    busy = killed.step_ms(True)
    readings = {
        "layers": cfg.n_layers, "state_gb": size(cfg.n_layers),
        "batch": B, "seq": S, "steps": steps_run,
        "step_ms_no_save": quiet, "step_ms_save_in_flight": busy,
        "ckpt_wait_s_write_behind": killed.trainer.ckpt_wait_s,
        "ckpt_wait_s_final_save": resumed.trainer.ckpt_wait_s,
        "write_behind_save_s": wb["seconds"], "write_behind_gb_s": wb["bytes"] / wb["seconds"] / 1e9,
        "write_behind_copy_ms": wb["copy_ms"],
        "emergency_save_s": em["seconds"], "final_save_s": fin["seconds"],
        "restore_s_trainer": resumed.trainer.restore_s, "restore_s_validate": restore_s,
        "restore_log": resumed.ckpt.restore_log + mgr.restore_log,
        "meminfo_before_validated_restore_gb": mem,
        "ckpt_bytes": wb["bytes"], "ckpt_bytes_on_disk": ckpt_disk,
        "loader_ms_mean": sum(loads) / len(loads), "loader_ms_max": max(loads),
        "peak_host_rss_gb": _maxrss_gb(), "peak_host_rss_gb_before": rss_before,
        "peak_cuda_gb": peak_gb, "phase_s": phase_s,
        "resume_rule": rule, "resume_worst": worst,
        "continuous_bitwise": not any(spread), "launches": counts,
    }
    log(f"{tag} step ms without a save in flight {[round(x, 2) for x in quiet]}, with one "
        f"{[round(x, 2) for x in busy]}; ckpt_wait_s {readings['ckpt_wait_s_write_behind']:.3f} "
        f"(write-behind) / {readings['ckpt_wait_s_final_save']:.3f} (final save); "
        f"on {smi}")
    log(f"{tag} write-behind save of {wb['bytes'] / 1e9:.3f} GB: {wb['seconds']:.2f} s "
        f"({readings['write_behind_gb_s']:.3f} GB/s; its device-to-host copies "
        f"{wb['copy_ms']:.1f} ms of device time, ahead of the next step); emergency save "
        f"{em['seconds']:.2f} s; "
        f"final save {fin['seconds']:.2f} s; restore {resumed.trainer.restore_s:.2f} s "
        f"(trainer) / {restore_s:.2f} s (validated); {ckpt_disk / 1e9:.3f} GB on disk")
    log(f"{tag} restores (read the extents + check the CRCs): " + "; ".join(
        f"step {r['step']} {r['seconds']:.2f} s = {r['read_s']:.2f} + {r['crc_s']:.2f}"
        for r in readings["restore_log"]))
    log(f"{tag} loader {readings['loader_ms_mean']:.3f} ms a batch (max "
        f"{readings['loader_ms_max']:.3f}); peak host RSS {readings['peak_host_rss_gb']:.2f} GB "
        f"(before the phase {rss_before:.2f}); peak {peak_gb:.2f} GB allocated on the card; "
        f"{phase_s:.1f} s")
    del cont, c1, c2, killed, resumed
    gc.collect()
    torch.cuda.empty_cache()
    readings["gil_probe_step_ms"] = _gil_probe(torch, cfg, B, S)
    gc.collect()
    torch.cuda.empty_cache()

    # the control, at the smoke size: resumes from the write-behind
    # checkpoint of step 4, with the manager and with a planted snapshot of
    # views; the first must hold, the second must be caught
    # (the smoke width's head_dim 16 is below the kernels' 64: plain attention)
    scfg = replace(get_config(TRAINER_ARCH, smoke=True), attn_impl="ref")
    sdata = TRAINER_DIR / "smoke-data"
    batch, seq = TRAINER_SMOKE
    write_synthetic_dataset(OSDevice(), str(sdata), DataConfig(seq_len=seq, batch_size=batch,
                                                               seed=0),
                            TRAINER_SHARDS, TRAINER_RECORDS, scfg.vocab_size)
    scont = _Run(scfg, batch, seq, sdata).fit()["state"]
    snames = leaf_names(scont)
    sspread = _leaf_diffs(_Run(scfg, batch, seq, sdata).fit()["state"], scont)
    _, ok_bad, _ = _resume_from_write_behind(
        f"{tag} smoke, write-behind", scfg, sdata, TRAINER_DIR / "smoke-ok", None,
        snames, scont, sspread)
    _, torn_bad, _ = _resume_from_write_behind(
        f"{tag} smoke, planted view snapshot", scfg, sdata, TRAINER_DIR / "smoke-torn",
        _view_snapshot_manager(), snames, scont, sspread)
    log(f"{tag} control, a write-behind snapshot of views: "
        + (f"rejected on {len(torn_bad)} leaves" if torn_bad else "NOT rejected"))
    if ok_bad:
        raise AssertionError(f"{tag}: at the smoke size the resume from the write-behind "
                             f"checkpoint differs on {ok_bad}")
    if not torn_bad:
        raise AssertionError(f"{tag}: the planted view snapshot is not rejected")
    readings["control_caught"] = len(torn_bad)
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    return readings


# the dry-run's memory and FLOP model against the card: tinyllama-1.1b's
# train step at phase train's shape and its prefill at phase main's
DRYRUN_ARCH = "tinyllama-1.1b"
DRYRUN_TRAIN = (8, 1024)   # batch, seq
DRYRUN_PREFILL = (8, 1000)  # batch, prompt
DRYRUN_STEPS = 5           # a warm-up step, then the timed ones (median)
# production cells planned on 16x16.  deepseek-v2-236b's prefill_32k is left
# out for time: its trace dispatches 3.9 M ops through the plain blockwise
# attention (minutes on the CPU, PERF.md)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("command-r-35b", "decode_32k"),
                ("zamba2-1.2b", "long_500k"))
ALLOC_SPLIT = 1 << 20  # the caching allocator splits off no remainder of this or less


def _bitwise_equal(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _allocated(torch, make):
    """(make()'s result, the bytes it left allocated on the card, and the
    bytes those allocations asked for)."""
    def now():
        gc.collect()
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["requested_bytes.all.current"])

    a0, r0 = now()
    out = make()
    a1, r1 = now()
    return out, a1 - a0, r1 - r0


def _check_resident(tag, what, reckoned, allocated, requested, leaves):
    """Reckoned bytes against the card: equal to the bytes the leaves asked
    for; the allocator's blocks round each up to 512 B, and a block of a
    large segment keeps a remainder of up to 1 MiB it does not split off."""
    slack = sum(512 if n <= ALLOC_SPLIT else ALLOC_SPLIT + 512 for n in leaves)
    log(f"{tag} {what}: reckoned {reckoned:,} B, requested {requested:,} B, allocated "
        f"{allocated:,} B (+{allocated - reckoned:,} B over {len(leaves)} leaves, the "
        f"allocator's rounding at most {slack:,} B)")
    if requested != reckoned or not 0 <= allocated - reckoned <= slack:
        raise AssertionError(f"{tag} {what}: reckoned {reckoned:,} B, requested "
                             f"{requested:,} B, allocated {allocated:,} B")


def phase_dryrun(torch, smi):
    """The dry-run (``repro_torch.launch.dryrun``) against the card: a world
    of one, its memory model and FLOP count against a real step, and the
    production plan of a few cells on 16x16, inside a one-rank NCCL group
    (``HashStore``: no address, no network) destroyed at the end."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _dryrun_checks(torch, smi)
    finally:
        dist.destroy_process_group()


def _dryrun_checks(torch, smi):
    import statistics

    import numpy as np

    from repro_torch.analysis.roofline import model_flops
    from repro_torch.bridge import leaf_names
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.dryrun import (cell_specs, make_cell, plan,
                                           resident_bytes_per_device, trace_cell)
    from repro_torch.launch.mesh import AbstractMesh, make_host_mesh, make_production_mesh
    from repro_torch.launch.steps import make_prefill_step, make_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    tag = "[dryrun]"
    t_phase = time.perf_counter()
    readings = {"arch": DRYRUN_ARCH}
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    model = build_model(get_config(DRYRUN_ARCH))
    one = AbstractMesh(("data", "model"), (1, 1))

    # 1. a world of one: the params laid out on a (1, 1) DeviceMesh by their specs
    dmesh = make_host_mesh()
    if tuple(dmesh.shape) != (1, 1) or dmesh.mesh_dim_names != ("data", "model"):
        raise AssertionError(f"{tag} host mesh {dmesh}, expected (1, 1) over data, model")
    with torch.device("meta"):
        meta = model.init(torch.Generator())
    params = model.init(gen())
    dparams = shd.distribute(params, shd.param_specs(params, dmesh), dmesh)
    local = [d.to_local() for d in tree_leaves(dparams)]
    differ = [n for n, t, l in zip(leaf_names(params), tree_leaves(params), local)
              if not _bitwise_equal(torch, t, l)]
    reckoned = resident_bytes_per_device([meta], [shd.param_specs(meta, dmesh)], dmesh)
    shards = sum(l.numel() * l.element_size() for l in local)
    log(f"{tag} world of one: {dmesh}; {len(local)} param leaves distributed, local "
        f"shards equal bit for bit: {not differ}; resident {reckoned:,} B reckoned, "
        f"{shards:,} B in the local shards")
    if differ:
        raise AssertionError(f"{tag} local shards differ from their tensors: {differ[:5]}")
    if reckoned != shards:
        raise AssertionError(f"{tag} reckoned resident {reckoned:,} B != local shards "
                             f"{shards:,} B")
    readings["world_of_one"] = {"leaves": len(local), "resident_bytes": reckoned}
    del params, dparams, local

    # 2. + 3. the train step: reckoned against allocated, counted FLOPs against model_flops
    B, S = DRYRUN_TRAIN
    shape = ShapeSpec(f"train_{B}x{S}", S, B, "train")
    t0 = time.perf_counter()
    cell = trace_cell(make_cell(DRYRUN_ARCH, shape))
    trace_s = time.perf_counter() - t0
    rep = plan(cell, one)
    res_state = resident_bytes_per_device([cell.trees["state"]],
                                          [cell_specs(cell, one)["state"]], one)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    state, alloc_state, req_state = _allocated(
        torch, lambda: make_train_state(model, opt_cfg, gen()))
    _check_resident(f"{tag} train {B}x{S}", "params + optimizer state", res_state, alloc_state,
                    req_state, [t.numel() * t.element_size() for t in tree_leaves(state)])
    rng = np.random.default_rng(4)
    seqs = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (B, S + 1))
                            .astype(np.int32)).cuda()
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    step = make_train_step(model, opt_cfg)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    temp = torch.cuda.max_memory_allocated() - base
    step_s = statistics.median(times[1:])
    mflops = model_flops(model.cfg, shape, "train")
    dots = cell.cost.dot_flops
    share = mflops / step_s / H100.peak_flops
    log(f"{tag} train {B}x{S}: resident {rep['memory']['resident_bytes_per_device'] / 1e9:.3f} "
        f"GB + traced temporaries {cell.cost.peak_bytes / 1e9:.3f} GB (the plain path; trace "
        f"{trace_s:.1f} s) = {rep['memory']['hbm_bytes_per_device'] / 1e9:.3f} GB reckoned; "
        f"on the card (kernel path): {alloc_state / 1e9:.3f} GB state + {temp / 1e9:.3f} GB "
        f"peak above it over {DRYRUN_STEPS} steps = {(alloc_state + temp) / 1e9:.3f} GB")
    log(f"{tag} train {B}x{S}: counted dot FLOPs {dots:.4e}, model_flops {mflops:.4e} "
        f"(ratio {dots / mflops:.4f}); step {step_s * 1e3:.2f} ms (median of steps 2-"
        f"{DRYRUN_STEPS}: {[round(t * 1e3, 2) for t in times]}); model-FLOP share of the "
        f"{H100.peak_flops / 1e12:.0f} TFLOP/s datasheet peak: {share:.4f} (counted FLOPs: "
        f"{dots / step_s / H100.peak_flops:.4f}), loss {met['loss'].item():.4f}, on {smi}")
    if not math.isfinite(met["loss"].item()):
        raise AssertionError(f"{tag} train loss is not finite")
    readings["train"] = {
        "reckoned_resident": rep["memory"]["resident_bytes_per_device"],
        "reckoned_temp": cell.cost.peak_bytes, "allocated_state": alloc_state,
        "reckoned_state": res_state, "measured_temp": temp, "dot_flops": dots,
        "model_flops": mflops, "step_ms": step_s * 1e3, "model_flop_share": share}
    del state, met, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the prefill
    B, P = DRYRUN_PREFILL
    shape = ShapeSpec(f"prefill_{B}x{P}", P, B, "prefill")
    cell = trace_cell(make_cell(DRYRUN_ARCH, shape))
    rep = plan(cell, one)
    params, alloc_params, req_params = _allocated(torch, lambda: model.init(gen()))
    res_params = resident_bytes_per_device([cell.trees["params"]],
                                           [cell_specs(cell, one)["params"]], one)
    _check_resident(f"{tag} prefill {B}x{P}", "params", res_params, alloc_params, req_params,
                    [t.numel() * t.element_size() for t in tree_leaves(params)])
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (B, P))
                              .astype(np.int32)).cuda()
    prefill = make_prefill_step(model, P)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base
    log(f"{tag} prefill {B}x{P}: resident "
        f"{rep['memory']['resident_bytes_per_device'] / 1e9:.3f} GB + traced temporaries "
        f"{cell.cost.peak_bytes / 1e9:.3f} GB (the plain path, the cache included) = "
        f"{rep['memory']['hbm_bytes_per_device'] / 1e9:.3f} GB reckoned; on the card (kernel "
        f"path): {alloc_params / 1e9:.3f} GB params + {temp / 1e9:.3f} GB peak above them = "
        f"{(alloc_params + temp) / 1e9:.3f} GB; counted dot FLOPs {cell.cost.dot_flops:.4e}, "
        f"model_flops {model_flops(model.cfg, shape, 'prefill'):.4e}")
    if tuple(logits.shape) != (B, model.cfg.padded_vocab) or not bool(logits.isfinite().all()):
        raise AssertionError(f"{tag} prefill logits {tuple(logits.shape)} not finite "
                             f"(B, V) values")
    readings["prefill"] = {
        "reckoned_resident": rep["memory"]["resident_bytes_per_device"],
        "reckoned_temp": cell.cost.peak_bytes, "allocated_params": alloc_params,
        "measured_temp": temp}
    del params, logits, cache
    gc.collect()
    torch.cuda.empty_cache()

    # 4. production planning on 16x16
    mesh = make_production_mesh()
    readings["plan_16x16"] = []
    for arch, shape_name in DRYRUN_CELLS:
        cell = trace_cell(make_cell(arch, shape_name))
        rep = plan(cell, mesh)
        mem, roof = rep["memory"], rep["roofline"]
        log(f"{tag} 16x16 {arch} {shape_name}: HBM/device {mem['hbm_bytes_per_device'] / 1e9:.3f}"
            f" GB ({mem['resident_bytes_per_device'] / 1e9:.3f} resident + "
            f"{mem['temp_bytes_per_device'] / 1e9:.3f} temporary) of the datasheet's "
            f"{H100.hbm_bytes / 1e9:.0f} GB ({mem['hbm_share']:.1%}); {roof['dominant']} "
            f"bound {roof['bound_s'] * 1e3:.3f} ms (compute {roof['compute_s'] * 1e3:.3f}, "
            f"memory {roof['memory_s'] * 1e3:.3f}, collectives not counted); trace "
            f"{cell.trace_s:.1f} s")
        readings["plan_16x16"].append({"arch": arch, "shape": shape_name,
                                       "hbm_bytes_per_device": mem["hbm_bytes_per_device"],
                                       "dominant": roof["dominant"], "bound_s": roof["bound_s"]})
    readings["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} phase {readings['phase_s']:.1f} s")
    return readings


# ---------------------------------------------------------------------------
# mesh: the multi-device slice on a one-rank NCCL mesh, and its dry-run
# ---------------------------------------------------------------------------
# served over the (1, 1) host mesh against meshless, full width: tinyllama at
# full depth (flash + decode), zamba2 at full depth (mamba2 + its shared
# attention's flash and decode), rwkv6-7b at 4 of its 32 layers (rwkv6)
MESH_SERVE = (("tinyllama-1.1b", 1000, None), ("zamba2-1.2b", 1024, None),
              ("rwkv6-7b", 1024, 4))
MESH_GEN = 16
# the trainer over the mesh: tinyllama at full width, 4 of its 22 layers
# (one checkpoint of its train state is 4.3 GB), batch 8 x 1024
MESH_TRAIN_LAYERS, MESH_TRAIN = 4, (8, 1024)
MESH_AB_REPS = 5   # the overhead A/B: median of 5 each, alternating
MESH_DIR = ROOT / "build" / "mesh"


def phase_mesh(torch, smi):
    """The port over a ``DeviceMesh`` (``launch.mesh.mesh_context``): inside
    a one-rank NCCL group (``HashStore``) destroyed at the end, its (1, 1)
    host mesh against meshless, bit for bit; then tinyllama-1.1b's
    train_4k planned on 16x16 with its collectives counted over a fake
    256-rank group."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        readings = _mesh_checks(torch, smi)
    finally:
        dist.destroy_process_group()
    readings["dryrun"] = _mesh_dryrun(smi)
    return readings


def _mesh_serve(torch, smi, mesh, arch, prompt, layers):
    """Prefill + ``MESH_GEN`` greedy tokens meshless and over the mesh: the
    logits of every step bit for bit, the tokens, the launch counts."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import gather, mesh_context, replicate, shard_batch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    tag = f"[mesh {arch}]"
    cfg = _train_config(arch, layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, prompt))
                              .astype(np.int32)).cuda()
    max_len = prompt + MESH_GEN + 1
    prefill, decode = make_prefill_step(model, max_len), make_decode_step(model)
    V = cfg.vocab_size

    def serve(p, batch):
        logits, cache = prefill(p, batch)
        seen = [gather(logits)]
        tok = logits[:, :V].argmax(-1)
        for t in range(MESH_GEN):
            pos = torch.full((BATCH,), prompt + t, dtype=torch.int32, device="cuda")
            logits, cache = decode(p, cache, tok, pos)
            seen.append(gather(logits))
            tok = logits[:, :V].argmax(-1)
        return torch.stack(seen), cache

    ops.reset_launch_counts()
    want, cache = serve(params, {"tokens": tokens})
    torch.cuda.synchronize()
    want_counts = ops.launch_counts()
    ops.reset_launch_counts()
    with mesh_context(mesh):
        dparams = replicate(params, mesh)
        got, dcache = serve(dparams, shard_batch({"tokens": tokens}, mesh))
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    # the overhead of one decode step, mesh against meshless, alternating
    tok = got[-1][:, :V].argmax(-1)
    pos = torch.full((BATCH,), prompt + MESH_GEN, dtype=torch.int32, device="cuda")
    ab = {"meshless": [], "mesh": []}
    for _ in range(MESH_AB_REPS):
        ab["meshless"].append(_wall_ms(torch, lambda: decode(params, cache, tok, pos)))
        with mesh_context(mesh):
            ab["mesh"].append(_wall_ms(torch, lambda: decode(dparams, dcache, tok, pos)))
    same_logits = _bitwise_equal(torch, got, want)
    toks_got, toks_want = got[1:, :, :V].argmax(-1), want[1:, :, :V].argmax(-1)
    diff = (got.float() - want.float()).abs().max().item()
    med = {k: sorted(v)[len(v) // 2] for k, v in ab.items()}
    log(f"{tag} {BATCH} x {prompt} + {MESH_GEN} tokens, {cfg.n_layers} layers: logits of "
        f"prefill and every decode step bit for bit: {same_logits} (max |diff| {diff:.3e}); "
        f"tokens identical: {bool(torch.equal(toks_got, toks_want))}; launches mesh {counts} "
        f"meshless {want_counts}; decode step {med['mesh']:.3f} ms over the mesh, "
        f"{med['meshless']:.3f} ms without (median of {MESH_AB_REPS}, alternating: "
        f"{[round(t, 3) for t in ab['mesh']]} / {[round(t, 3) for t in ab['meshless']]}) "
        f"on {smi}")
    if not same_logits or not torch.equal(toks_got, toks_want):
        raise AssertionError(f"{tag} served over the mesh differs from meshless "
                             f"(max |diff| {diff:.3e})")
    if counts != want_counts:
        raise AssertionError(f"{tag} launches over the mesh {counts} != meshless {want_counts}")
    return {"arch": arch, "layers": cfg.n_layers, "launches": counts,
            "decode_ms_mesh": med["mesh"], "decode_ms_meshless": med["meshless"]}


def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _mesh_trainer(mesh, data, cfg, steps, root=None):
    """``Trainer.fit`` of ``cfg`` to ``steps`` on ``mesh`` (or a device),
    checkpoints in ``root`` (resumed from when one is there), wired as
    ``launch/train.py`` wires it."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import Foreactor, OSDevice
    from repro_torch.data import DataConfig, ShardedTokenDataset, TokenBatchLoader
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    disk = OSDevice()
    fa = Foreactor(device=disk, backend="io_uring", depth=32)
    B, S = MESH_TRAIN
    ds = ShardedTokenDataset(disk, [f"{data}/shard_{i:05d}.rio" for i in range(2)])
    loader = TokenBatchLoader(ds, DataConfig(seq_len=S, batch_size=B, seed=0), fa=fa)
    ckpt = None if root is None else CheckpointManager(disk, str(root), fa=fa, num_shards=4)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=3)
    tcfg = TrainerConfig(steps=steps, ckpt_every=0, log_every=1)
    try:
        return Trainer(build_model(cfg), opt, loader, ckpt, mesh, tcfg).fit()
    finally:
        loader.close()
        if ckpt is not None:
            ckpt.close()
        fa.shutdown()


def _mesh_checks(torch, smi):
    import shutil

    import numpy as np

    from repro_torch.core import OSDevice
    from repro_torch.data import DataConfig, write_synthetic_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import gather, make_host_mesh, mesh_context, replicate
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    tag = "[mesh]"
    t_phase = time.perf_counter()
    mesh = make_host_mesh("cuda")
    if tuple(mesh.shape) != (1, 1) or mesh.mesh_dim_names != ("data", "model"):
        raise AssertionError(f"{tag} host mesh {mesh}, expected (1, 1) over data, model")
    readings = {"serve": [], "remat_context": _mesh_remat_context(torch, mesh)}
    launches = {}
    for arch, prompt, layers in MESH_SERVE:
        r = _mesh_serve(torch, smi, mesh, arch, prompt, layers)
        readings["serve"].append(r)
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()

    # the trainer: three steps meshless; over the mesh two steps, a save, a
    # second trainer that restores it and takes the third
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    cfg = _train_config("tinyllama-1.1b", MESH_TRAIN_LAYERS)
    B, S = MESH_TRAIN
    data = MESH_DIR / "data"
    write_synthetic_dataset(OSDevice(), str(data), DataConfig(seq_len=S, batch_size=B, seed=0),
                            2, 16, cfg.vocab_size)
    ops.reset_launch_counts()
    plain = _mesh_trainer("cuda", data, cfg, 3)
    plain_counts = ops.launch_counts()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    first = _mesh_trainer(mesh, data, cfg, 2, MESH_DIR / "ckpt")
    rest = _mesh_trainer(mesh, data, cfg, 3, MESH_DIR / "ckpt")
    mesh_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    losses = first["losses"] + rest["losses"]
    final = [t for t in tree_leaves(gather(rest["state"]))]
    want = tree_leaves(plain["state"])
    differ = sum(not _bitwise_equal(torch, a, b) for a, b in zip(final, want))
    log(f"{tag} trainer, tinyllama-1.1b at {cfg.n_layers} layers, batch {B} x {S}: losses "
        f"over the mesh {losses} (steps 0-1, save, restore, step 2) vs meshless "
        f"{plain['losses']}; state leaves differing bit for bit: {differ} of {len(want)}; "
        f"launches {counts} (meshless {plain_counts}); {mesh_s:.1f} s over the mesh")
    if losses != plain["losses"] or differ or len(final) != len(want):
        raise AssertionError(f"{tag} the trainer over the mesh differs from meshless: losses "
                             f"{losses} vs {plain['losses']}, {differ} leaves")
    if counts != plain_counts:
        raise AssertionError(f"{tag} trainer launches over the mesh {counts} != meshless "
                             f"{plain_counts}")
    del first, rest, plain, final, want
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # one train step: grad norm and loss bit for bit, then the step's overhead
    model = build_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    rng = np.random.default_rng(5)
    seqs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).cuda()
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    step = make_train_step(model, opt)
    a = make_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0))
    b = make_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0))
    _, met_a = step(a, batch)
    db, dbatch = replicate(b, mesh), replicate(batch, mesh)
    with mesh_context(mesh):
        _, met_b = step(db, dbatch)
        met_b = gather(met_b)
    ab = {"meshless": [], "mesh": []}
    for _ in range(MESH_AB_REPS):
        ab["meshless"].append(_wall_ms(torch, lambda: step(a, batch)))
        with mesh_context(mesh):
            ab["mesh"].append(_wall_ms(torch, lambda: step(db, dbatch)))
    same = {k: _bitwise_equal(torch, met_a[k], met_b[k]) for k in ("loss", "grad_norm")}
    med = {k: sorted(v)[len(v) // 2] for k, v in ab.items()}
    log(f"{tag} train step: loss {met_a['loss'].item():.6f} / {met_b['loss'].item():.6f}, grad "
        f"norm {met_a['grad_norm'].item():.6f} / {met_b['grad_norm'].item():.6f} (meshless / "
        f"mesh), bit for bit {same}; step {med['mesh']:.2f} ms over the mesh, "
        f"{med['meshless']:.2f} ms without (median of {MESH_AB_REPS}, alternating: "
        f"{[round(t, 2) for t in ab['mesh']]} / {[round(t, 2) for t in ab['meshless']]}) "
        f"on {smi}")
    if not all(same.values()):
        raise AssertionError(f"{tag} the train step's metrics over the mesh differ: {same}")
    readings.update(train_layers=cfg.n_layers, train_step_ms_mesh=med["mesh"],
                    train_step_ms_meshless=med["meshless"], launches=launches)
    for name in ("flash_attention_fwd", "flash_decode", "mamba2_scan", "rwkv6_scan"):
        if not launches.get(name):
            raise AssertionError(f"{tag} {name} was not launched on the mesh path: {launches}")
    del a, b, db, dbatch, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    readings["checks_s"] = time.perf_counter() - t_phase
    log(f"{tag} launches on the mesh path {launches}; {readings['checks_s']:.1f} s")
    return readings


def _mesh_remat_context(torch, mesh):
    """What a remat recompute sees of ``mesh_context`` on the card, where
    autograd runs the backward on its device thread: through
    ``models.common.remat`` the forward's mesh and profile (else no
    constraint would apply in the recompute); through a bare
    ``torch.utils.checkpoint``, read for the record."""
    import threading

    from torch.utils.checkpoint import checkpoint

    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models.common import active_mesh, get_sharding_profile, remat

    tag = "[mesh remat]"
    seen = {}

    def run(wrap, name):
        def f(x):
            seen.setdefault(name, []).append((active_mesh() is mesh, get_sharding_profile(),
                                              threading.get_ident() == main))
            return (x * 2).sin()
        x = torch.ones(8, device="cuda", requires_grad=True)
        with mesh_context(mesh, "fsdp"):
            wrap(f, x, use_reentrant=False).sum().backward()
        torch.cuda.synchronize()

    main = threading.get_ident()
    run(remat, "remat")
    run(checkpoint, "checkpoint")
    log(f"{tag} (mesh active, profile, on the calling thread) in the forward and the "
        f"recompute: remat {seen['remat']}, bare checkpoint {seen['checkpoint']}")
    if seen["remat"][1][:2] != (True, "fsdp"):
        raise AssertionError(f"{tag} the recompute under remat did not see the mesh context: "
                             f"{seen['remat']}")
    return seen


def _mesh_dryrun(smi):
    """tinyllama-1.1b train_4k on 16x16: the collectives one device issues
    (``launch.dryrun.trace_mesh`` over a fake 256-rank group) and the
    roofline with its collective term."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import make_cell, plan, trace_cell, trace_mesh
    from repro_torch.launch.mesh import make_production_mesh

    tag = "[mesh dryrun]"
    mesh = make_production_mesh()
    cell = trace_cell(make_cell("tinyllama-1.1b", "train_4k"))
    try:
        trace_mesh(cell, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rep = plan(cell, mesh)
    hlo, roof = rep["hlo"], rep["roofline"]
    by_kind = {k: v for k, v in hlo["collectives"].items()}
    log(f"{tag} tinyllama-1.1b train_4k on 16x16 ({rep['profile']}): {hlo['collective_count']} "
        f"collectives, {hlo['collective_bytes'] / 1e9:.3f} GB a device by kind "
        f"{ {k: round(v / 1e9, 4) for k, v in by_kind.items()} } GB; roofline compute "
        f"{roof['compute_s'] * 1e3:.3f} ms, memory {roof['memory_s'] * 1e3:.3f} ms, collective "
        f"{roof['collective_s'] * 1e3:.3f} ms ({roof['dominant']}); traces "
        f"{cell.trace_s:.1f} s meshless, {rep['mesh_trace_s']:.1f} s over the mesh; on {smi}")
    if not hlo["collective_count"] or roof["collective_s"] is None:
        raise AssertionError(f"{tag} no collectives counted: {hlo}")
    return {"collectives": by_kind, "collective_count": hlo["collective_count"],
            "collective_bytes": hlo["collective_bytes"], "collective_s": roof["collective_s"],
            "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
            "trace_s": cell.trace_s, "mesh_trace_s": rep["mesh_trace_s"]}


# ---------------------------------------------------------------------------
# iostore: the paper's case studies and the I/O server on the machine's disk
# ---------------------------------------------------------------------------
IOSTORE_DIR = ROOT / "build" / "iostore"
IOSTORE_DU = (100, 100)  # directories, files in each
IOSTORE_CP_BYTES = 1 << 30
IOSTORE_CP_BUF = 128 * 1024  # the cp plugin's buffer (fileutils.CP_BUF)
IOSTORE_BPT_KEYS, IOSTORE_BPT_DEGREE = 1_000_000, 510
# 16 overlapping L0 tables of 62,500 keys, 256-byte values: a Get searches
# up to 16 candidate tables (the paper's LevelDB chains are 12-19 deep)
IOSTORE_LSM_KEYS, IOSTORE_LSM_VALUE, IOSTORE_LSM_TABLES = 1_000_000, 256, 16
IOSTORE_GETS, IOSTORE_MULTIGET_BATCH = 2000, 8
IOSTORE_DEPTH = 32  # as the trainer phase's Foreactor
# the I/O server's CLI, each run as its own process
IOSTORE_SERVER_RUNS = (("--mode", "all", "--clients", "8"),
                       ("--openloop", "--mode", "shared", "--sessions", "1024", "--rate", "0.35",
                        "--duration", "2.0"),
                       ("--remine",))


def _mount_of(path):
    """(mount point, file system type, source) of the mount that holds
    ``path``, from /proc/self/mountinfo, and the block device of its
    ``st_dev`` (from /sys/dev/block, or None)."""
    path = os.path.realpath(path)
    best = ("", "?", "?")
    with open("/proc/self/mountinfo") as f:
        for line in f:
            left, _, right = line.partition(" - ")
            point = left.split()[4].replace("\\040", " ")
            fstype, source = right.split()[:2]
            inside = path == point or path.startswith(point.rstrip("/") + "/")
            if inside and len(point) >= len(best[0]):
                best = (point, fstype, source)
    dev = os.stat(path).st_dev
    block = Path(f"/sys/dev/block/{os.major(dev)}:{os.minor(dev)}")
    return best + ((block.resolve().name if block.exists() else
                    f"none (st_dev {os.major(dev)}:{os.minor(dev)})"),)


def _lsm_value(blob, k):
    """The value of key ``k``: its 8 bytes and 248 bytes of a seeded blob."""
    o = (k * 131) % (len(blob) - IOSTORE_LSM_VALUE)
    return k.to_bytes(8, "little") + blob[o:o + IOSTORE_LSM_VALUE - 8]


def _latencies(fn, items):
    """Per-call seconds of ``fn(item)`` and the results."""
    out, lat = [], []
    for it in items:
        t0 = time.perf_counter()
        out.append(fn(it))
        lat.append(time.perf_counter() - t0)
    return out, lat


def phase_iostore(smi):
    """The paper's case studies (du, cp, B+-tree Load and Scan, LSM Get and
    multi_get) serially and through their foreaction graphs on this
    machine's own disk under ``build/iostore`` (``OSDevice``, direct reads
    where the file system takes them), ``wrap(auto_graph=True)`` mining du,
    and the I/O server's CLI in three modes.  Answers and exit codes are
    checked; times are reported, not gated."""
    import shutil
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch.core import Foreactor, OSDevice
    from repro_torch.store import plugins
    from repro_torch.store.bptree import BPTree
    from repro_torch.store.fileutils import cp_file, du_dir
    from repro_torch.store.lsm import LSMTree

    tag = "[iostore]"
    shutil.rmtree(IOSTORE_DIR, ignore_errors=True)
    IOSTORE_DIR.mkdir(parents=True)
    point, fstype, source, block = _mount_of(IOSTORE_DIR)
    dev = OSDevice(direct=True)
    readings = {"mount": point, "fs": fstype, "source": source, "block_device": block}

    def where():
        free = shutil.disk_usage(IOSTORE_DIR).free / 1e9
        return (f"[{smi}; {fstype} {source} on {point}, block {block}; free {free:.1f} GB; "
                f"direct opens {dev.direct_opens} fallbacks {dev.direct_fallbacks}]")

    def reading(name, seconds, **extra):
        readings[name] = dict(s=seconds, **extra)
        log(f"{tag} {name}: {seconds:.4f} s" + "".join(f", {k} {v}" for k, v in extra.items())
            + f" {where()}")

    def graphs():
        fa = Foreactor(device=dev, backend="io_uring", depth=IOSTORE_DEPTH)
        plugins.register_all(fa, precompile=True)
        return fa

    t_phase = time.perf_counter()
    try:
        log(f"{tag} {IOSTORE_DIR}: {where()}")
        rng = np.random.default_rng(0)

        # -- du over 10,000 files in 100 directories -------------------------
        ndirs, nfiles = IOSTORE_DU
        sizes = rng.integers(0, 8192, size=(ndirs, nfiles))
        dirs = [str(IOSTORE_DIR / "du" / f"d{i:03d}") for i in range(ndirs)]
        for d, row in zip(dirs, sizes):
            os.makedirs(d)
            for j, n in enumerate(row.tolist()):
                with open(f"{d}/f{j:03d}", "wb") as f:
                    f.write(rng.bytes(n))
        want = [int(s) for s in sizes.sum(axis=1)]
        fa = graphs()
        du = fa.wrap("du", plugins.capture_du)(du_dir)
        for label, fn in (("du serial", du_dir), ("du graph", du), ("du graph 2", du),
                          ("du serial 2", du_dir)):
            t0 = time.perf_counter()
            got = [fn(dev, d) for d in dirs]
            reading(label, time.perf_counter() - t0, total=sum(got))
            if got != want:
                raise AssertionError(f"{tag} {label}: totals differ from the sizes written")
        auto = fa.wrap("du_auto", plugins.capture_du, auto_graph=True, observe_calls=2)(du_dir)
        t0 = time.perf_counter()
        got = [auto(dev, d) for d in dirs]
        state = dict(auto.__foreactor_auto__)
        reading(f"du auto_graph (2 observed, {ndirs - 2} speculated)", time.perf_counter() - t0,
                state=state["state"])
        if got != want or state["state"] != "speculating":
            raise AssertionError(f"{tag} auto_graph du: state {state}, totals equal "
                                 f"{got == want}")
        # the same two observations mined apart from the wrapper: the graph
        # the wrapper registered, with its signature
        obs_fa = Foreactor(device=dev, backend="sync")
        obs = obs_fa.observe("du_auto", plugins.capture_du)(du_dir)
        obs(dev, dirs[0])
        obs(dev, dirs[1])
        mined = obs_fa.mine("du_auto", register=False)
        obs_fa.shutdown()
        if mined.to_dot() != fa.graph("du_auto").to_dot():
            raise AssertionError(f"{tag} the wrapper's mined graph differs from a mining of "
                                 f"the same two observations")
        log(f"{tag} du auto_graph mined signature:\n{mined.signature()}")
        readings["du_auto_signature"] = mined.signature()
        fa.shutdown()
        shutil.rmtree(IOSTORE_DIR / "du")

        # -- cp of one 1 GiB file, 128 KiB buffers ----------------------------
        src = IOSTORE_DIR / "cp_src.bin"
        crc = 0
        with open(src, "wb") as f:
            for _ in range(IOSTORE_CP_BYTES // (64 << 20)):
                chunk = rng.bytes(64 << 20)
                crc = zlib.crc32(chunk, crc)
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())

        def crc_of(p):
            c = 0
            with open(p, "rb") as f:
                while chunk := f.read(64 << 20):
                    c = zlib.crc32(chunk, c)
            return c

        fa = graphs()
        cp = fa.wrap("cp", plugins.capture_cp)(cp_file)
        for label, fn in (("cp serial", cp_file), ("cp graph", cp)):
            dst = IOSTORE_DIR / "cp_dst.bin"
            t0 = time.perf_counter()
            n = fn(dev, str(src), str(dst), IOSTORE_CP_BUF)
            s = time.perf_counter() - t0
            got = crc_of(dst)
            reading(label, s, bytes=n, GB_s=round(n / s / 1e9, 3), crc32=f"{got:08x}")
            if n != IOSTORE_CP_BYTES or got != crc:
                raise AssertionError(f"{tag} {label}: copied {n} B, crc32 {got:08x}, "
                                     f"source {crc:08x}")
            dst.unlink()
        fa.shutdown()
        src.unlink()

        # -- B+-tree: bulk Load of 1,000,000 keys at degree 510, full Scan ----
        keys = np.sort(rng.choice(1 << 40, size=IOSTORE_BPT_KEYS, replace=False)).astype(np.uint64)
        vals = rng.integers(0, 1 << 63, size=len(keys), dtype=np.uint64)
        fa = graphs()
        load = fa.wrap("bptree_load", plugins.capture_bptree_load)(plugins.load_with_graph)
        for way, fn in (("serial", BPTree.bulk_load), ("graph", load)):
            tree = BPTree(dev, str(IOSTORE_DIR / f"{way}.db"), degree=IOSTORE_BPT_DEGREE)
            t0 = time.perf_counter()
            fn(tree, keys, vals)
            reading(f"bptree load {way}", time.perf_counter() - t0, leaves=tree.nleaves,
                    height=tree.height)
            tree.close()
        if (IOSTORE_DIR / "serial.db").read_bytes() != (IOSTORE_DIR / "graph.db").read_bytes():
            raise AssertionError(f"{tag} the two loads wrote different files")
        want = list(zip(keys.tolist(), vals.tolist()))
        tree = BPTree(dev, str(IOSTORE_DIR / "graph.db")).open()
        scan = fa.wrap("bptree_scan", plugins.capture_bptree_scan)(plugins.scan_with_graph)
        for label, fn in (("bptree scan serial", tree.scan),
                          ("bptree scan graph", lambda lo, hi: scan(tree, lo, hi))):
            t0 = time.perf_counter()
            got = fn(int(keys[0]), int(keys[-1]))
            reading(label, time.perf_counter() - t0, records=len(got))
            if got != want:
                raise AssertionError(f"{tag} {label}: the records differ from the loaded ones")
        tree.close()
        fa.shutdown()
        del want, got

        # -- LSM: 1,000,000 keys of 256 B in 16 overlapping L0 tables ---------
        blob = rng.bytes(1 << 20)
        root = str(IOSTORE_DIR / "lsm")
        per_table = IOSTORE_LSM_KEYS // IOSTORE_LSM_TABLES
        t0 = time.perf_counter()
        build = LSMTree(OSDevice(), root, l0_limit=10 ** 6,
                        memtable_limit_bytes=per_table * (IOSTORE_LSM_VALUE + 12))
        for k in rng.permutation(IOSTORE_LSM_KEYS).tolist():
            build.put(k, _lsm_value(blob, k))
        build.flush()
        size = sum(t.size_bytes for t in build.levels[0])
        build.close()
        log(f"{tag} LSM built in {time.perf_counter() - t0:.1f} s: "
            f"{len(build.levels[0])} L0 tables, {size / 1e6:.1f} MB")
        if len(build.levels[0]) != IOSTORE_LSM_TABLES or len(build.levels) != 1:
            raise AssertionError(f"{tag} LSM levels {[len(lv) for lv in build.levels]}")
        lsm = LSMTree.open_existing(dev, root)
        gets = [int(k) for k in rng.integers(0, IOSTORE_LSM_KEYS, size=IOSTORE_GETS)]
        want = [_lsm_value(blob, k) for k in gets]
        chain = [len(lsm.candidates(k)) for k in gets]
        log(f"{tag} Get candidate chains: min {min(chain)}, mean {sum(chain) / len(chain):.2f}, "
            f"max {max(chain)}")
        # whether the disk overlaps reads at all: the Gets' first candidate
        # blocks read straight from the device, by one thread and by 16
        blocks = [lsm.candidates(k)[0] for k in gets]
        for threads in (1, 16):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda c: dev.pread(c[0].fd, c[2], c[1]), blocks))
                reading(f"raw block reads, {threads} thread(s)", time.perf_counter() - t0,
                        reads=len(blocks))
        fa = graphs()
        get = fa.wrap("lsm_get", plugins.capture_lsm_get)(lambda t, k: t.get(k))
        mget = fa.wrap("lsm_multiget", plugins.capture_lsm_multiget)(lambda t, ks: t.multi_get(ks))
        batches = [gets[i:i + IOSTORE_MULTIGET_BATCH]
                   for i in range(0, len(gets), IOSTORE_MULTIGET_BATCH)]
        for label, fn, items in (("lsm get serial", lsm.get, gets),
                                 ("lsm get graph", lambda k: get(lsm, k), gets),
                                 ("lsm multi_get graph", lambda ks: mget(lsm, ks), batches)):
            t0 = time.perf_counter()
            got, lat = _latencies(fn, items)
            total = time.perf_counter() - t0
            if label.startswith("lsm multi_get"):
                got = [v for vs in got for v in vs]
            unit = f"batch of {IOSTORE_MULTIGET_BATCH}" if "multi" in label else "Get"
            p50, p99 = np.percentile(lat, [50, 99]) * 1e3
            reading(label, total, p50_ms=round(float(p50), 4), p99_ms=round(float(p99), 4),
                    per=unit)
            if got != want:
                bad = sum(g != w for g, w in zip(got, want))
                raise AssertionError(f"{tag} {label}: {bad} of {len(want)} answers differ "
                                     f"from the oracle")
        stats = fa.total_stats
        log(f"{tag} engine over the graph Gets and multi_gets: pre_issued {stats.pre_issued}, "
            f"served_async {stats.served_async}, cancelled {stats.cancelled}, "
            f"wasted {stats.wasted_completions}")
        fa.shutdown()
        lsm.close()
        readings["direct_opens"], readings["direct_fallbacks"] = (dev.direct_opens,
                                                                  dev.direct_fallbacks)

        # -- the I/O server's CLI ------------------------------------------------
        env = dict(os.environ, PYTHONPATH=str(SRC))
        for args in IOSTORE_SERVER_RUNS:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "repro_torch.launch.ioserver", *args],
                                 env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
            s = time.perf_counter() - t0
            summary = [ln for ln in res.stdout.splitlines()
                       if ln.startswith(("[ioserver]", "[openloop]", "  class", "  remine"))]
            for ln in summary:
                log(f"{tag} {' '.join(args)} | {ln.strip()}")
            reading(f"ioserver {' '.join(args)}", s, rc=res.returncode)
            heads = [ln for ln in summary if ln.startswith(("[ioserver]", "[openloop]"))]
            if res.returncode != 0 or not heads or any("errors=0" not in h for h in heads):
                raise AssertionError(f"{tag} ioserver {args}: rc {res.returncode}\n"
                                     f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    finally:
        shutil.rmtree(IOSTORE_DIR, ignore_errors=True)
    readings["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} phase {readings['phase_s']:.1f} s")
    return readings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {name}: {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_start:.1f} s since the start)")
        return out

    smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch) + timed("scans", phase_scans, torch)
    results = []
    for arch, prompt, layers in PATHS:
        results.append(timed(f"main {arch}", phase_main, torch, smi, arch, prompt, layers))
        log(f"[main {arch}] " + json.dumps(dict(results[-1], card=smi)))
        gc.collect()  # free the model before the next one loads
        torch.cuda.empty_cache()
    grads = timed("grads", phase_grads, torch)
    trained = []
    for arch, layers, batch_size, seq in TRAIN_PATHS:
        trained.append(timed(f"train {arch}", phase_train, torch, smi, arch, layers, batch_size,
                             seq))
        log(f"[train {arch}] " + json.dumps(dict(trained[-1], card=smi)))
        gc.collect()
        torch.cuda.empty_cache()
    trainer = timed("trainer", phase_trainer, torch, smi)
    log("[trainer] " + json.dumps(dict(trainer, card=smi)))
    gc.collect()
    torch.cuda.empty_cache()
    dry = timed("dryrun", phase_dryrun, torch, smi)
    log("[dryrun] " + json.dumps(dict(dry, card=smi)))
    meshed = timed("mesh", phase_mesh, torch, smi)
    log("[mesh] " + json.dumps(dict(meshed, card=smi)))
    gc.collect()
    torch.cuda.empty_cache()
    iostore = timed("iostore", phase_iostore, smi)
    log("[iostore] " + json.dumps(dict(iostore, card=smi)))
    for row in rows:  # launches on the served, trained, trainer's and mesh paths together
        row["launches"] = sum(r["launches"][row["name"]] for r in results + trained + [trainer]) \
            + meshed["launches"][row["name"]]
        row["launches_mesh"] = meshed["launches"][row["name"]]
        row["launches_serve"] = {r["arch"]: r["launches"][row["name"]] for r in results}
        row["launches_train"] = sum(r["launches"][row["name"]] for r in trained)
        row["launches_trainer"] = trainer["launches"][row["name"]]
        row["grad_parity"] = grads.get({"flash_attention_fwd": "attention", "mamba2_scan": "mamba2",
                                        "rwkv6_scan": "rwkv6"}.get(row["name"]))
        if row["name"] == "flash_attention_fwd":
            row["grad_parity_mla_d192"] = grads["attention_mla"]
            row["grad_parity_full"] = grads["attention_full"]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
