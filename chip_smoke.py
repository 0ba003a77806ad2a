#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. device  — name and power limit (nvidia-smi), torch and CUDA versions;
             requires compute capability 9.0; turns TF32 off.
2. build   — compiles ``src/repro_torch/csrc/*.cu`` with nvcc.
3. kernels — every kernel against its plain torch version on the card, at
             the serve shapes and ragged ones, in bf16 and fp32; the bf16
             flash kernel also against a dense fp32 reference on the same
             bf16 values, with a tight limit that planted faults must
             break; then CUDA event timings of kernel, plain version and
             the PyTorch library call (SDPA, a yardstick the port never
             calls).
4. main    — full-width tinyllama-1.1b in bf16, random weights from a
             seed, serves batch 8, prompt 1000, gen 64 greedily through
             ``make_generate_loop``; checks launch counts, token range, and
             the kernel path's logits (prefill and every decode step) and
             final cache against the plain path's, teacher forced; then
             the same check on paths with planted faults, which it must
             reject.
5. report  — one ``kernels`` JSON line, the nvidia-smi line, and the result
             line ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX or of the reference
package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# datasheet peaks of the H100 SXM (NVIDIA), used for the bound columns
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # atol = rtol, as the reference's kernel tests
# bf16 flash kernel against a dense fp32 reference on the same bf16 values:
# what is left is the kernel's own rounding of P (before P V) and of the
# output to bf16, each at most a relative 2^-8.  atol + rtol * |want|.
TIGHT_ATOL, TIGHT_RTOL = 5e-3, 1e-2

# main path: full-width tinyllama serving
ARCH, BATCH, PROMPT, GEN = "tinyllama-1.1b", 8, 1000, 64
# bf16 logits and cache, kernel path vs plain path, teacher forced:
# atol + rtol * |plain|.  The two paths round attention in different places
# (fp32 scores in the kernel, bf16 scores in the plain path); 22 bf16 layers
# carry that difference to the logits, whose scale is ~1 for these random
# weights.  The planted faults of phase 4 must break this limit.
LIMIT_ATOL, LIMIT_RTOL = 0.1, 0.05


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


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
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
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return libs


def _prefill_inputs(torch, gen, B, H, KV, S, T, D, dtype):
    # (B,S,H,D) activations seen as (B,H,S,D), as the model hands them over
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    return q, k, v


def _decode_inputs(torch, gen, B, H, KV, T, D, dtype, length):
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    # the cache is stored (B,T,KV,D) and read as (B,KV,T,D)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    return q, k, v, torch.as_tensor(length, dtype=torch.int32, device="cuda")


def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    errs = {}

    # --- flash attention: (B, H, KV, S, T, D, causal)
    main_fa = (BATCH, 32, 4, PROMPT, PROMPT, 64, True)
    fa_cases = [main_fa,
                (2, 8, 2, 130, 257, 64, True),     # S != T, both ragged
                (1, 4, 2, 130, 130, 128, True),
                (2, 4, 1, 257, 257, 256, True),
                (1, 2, 1, 257, 130, 64, False)]    # non-causal, S > T
    for case in fa_cases:
        B, H, KV, S, T, D, causal = case
        for dname, dt in dtypes.items():
            q, k, v = _prefill_inputs(torch, gen, B, H, KV, S, T, D, dt)
            got = fa.flash_attention_fwd(q, k, v, causal)
            want = fa.attention_plain(q, k, v, causal)
            torch.cuda.synchronize()
            label = f"flash_attention_fwd {dname} B={B} H={H} KV={KV} S={S} T={T} D={D} " \
                    f"causal={causal}"
            errs[("fa", case, dname)] = assert_close(label, got, want, TOL[dname])
            if dt == torch.bfloat16:
                errs[("fa32", case)] = assert_close(
                    label + " vs fp32 reference", got, attention_f32(torch, q, k, v, causal),
                    TIGHT_ATOL, TIGHT_RTOL)
            if case == main_fa and dt == torch.bfloat16:
                main_bf16 = (q, k, v, got)
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

    # --- flash decode: (B, H, KV, T, D)
    T_main = PROMPT + GEN + 1
    main_dec = (BATCH, 32, 4, T_main, 64)
    lengths = torch.randint(1, T_main + 1, (BATCH,), generator=gen, device="cuda").tolist()
    lengths[0], lengths[1] = 1, T_main
    dec_cases = [(main_dec, lengths), ((3, 8, 2, 300, 128), [1, 300, 157]),
                 ((2, 8, 8, 77, 64), [77, 13])]
    for (B, H, KV, T, D), length in dec_cases:
        for dname, dt in dtypes.items():
            q, k, v, ln = _decode_inputs(torch, gen, B, H, KV, T, D, dt, length)
            got = dec.flash_decode(q, k, v, ln)
            want = dec.decode_plain(q, k, v, ln)
            torch.cuda.synchronize()
            err = assert_close(f"flash_decode {dname} B={B} H={H} KV={KV} T={T} D={D} "
                               f"length={min(length)}..{max(length)}", got, want, TOL[dname])
            errs[("dec", (B, H, KV, T, D), dname)] = err
    for dname, dt in dtypes.items():
        q, k, v, ln = _decode_inputs(torch, gen, 2, 8, 2, 64, 64, dt, [0, 5])
        got = dec.flash_decode(q, k, v, ln)
        torch.cuda.synchronize()
        if got[0].abs().max().item() != 0.0:
            raise AssertionError("flash_decode: length 0 does not give zeros")
        log(f"[kernels] flash_decode {dname} length=0 gives zeros: ok")

    # --- timings at the serve shapes, bf16
    B, H, KV, S, T, D, _ = main_fa
    bf = torch.bfloat16
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * T * D)
    fa_in = copies_beyond_l2(lambda: _prefill_inputs(torch, gen, B, H, KV, S, T, D, bf), nbytes)
    pairs = sum(min(T, i + T - S + 1) for i in range(S))  # causal (query, key) pairs
    fa_bound, fa_by = bound(4 * B * H * D * pairs, nbytes, PEAK_BF16_FLOPS)
    fa_row = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "shape": f"B={B} H={H} KV={KV} S={S} T={T} D={D} causal bf16",
        "max_abs_err": errs[("fa", main_fa, "bfloat16")],
        "max_abs_err_fp32": errs[("fa", main_fa, "float32")],
        "tol": TOL["bfloat16"], "tol_fp32": TOL["float32"],
        "max_abs_err_vs_fp32_reference": errs[("fa32", main_fa)],
        "tol_vs_fp32_reference": {"atol": TIGHT_ATOL, "rtol": TIGHT_RTOL},
        "controls": fa_controls,
        "ms": time_ms(torch, lambda q, k, v: fa.flash_attention_fwd(q, k, v, True), fa_in),
        "plain_ms": time_ms(torch, lambda q, k, v: fa.attention_plain(q, k, v, True), fa_in,
                            iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), fa_in),
        "bound_ms": fa_bound, "bound_by": fa_by,
    }
    del fa_in

    B, H, KV, T, D = main_dec
    length = [T - 1] * B  # the last decode step of the main path: position T - 2
    nbytes = 2 * (2 * B * H * D + 2 * KV * D * sum(length)) + 4 * B
    dec_in = copies_beyond_l2(
        lambda: _decode_inputs(torch, gen, B, H, KV, T, D, bf, length), nbytes)
    dec_bound, dec_by = bound(4 * H * D * sum(length), nbytes, PEAK_BF16_FLOPS)

    def sdpa_decode(q, k, v, ln):
        mask = (torch.arange(k.shape[2], device="cuda")[None, :] < ln[:, None])[:, None, None]
        return F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                              enable_gqa=True)[:, :, 0]

    dec_row = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:67",
        "shape": f"B={B} H={H} KV={KV} T={T} D={D} length={T - 1} bf16",
        "max_abs_err": errs[("dec", main_dec, "bfloat16")],
        "max_abs_err_fp32": errs[("dec", main_dec, "float32")],
        "tol": TOL["bfloat16"], "tol_fp32": TOL["float32"],
        "ms": time_ms(torch, dec.flash_decode, dec_in),
        "plain_ms": time_ms(torch, dec.decode_plain, dec_in),
        "library_ms": time_ms(torch, sdpa_decode, dec_in),
        "bound_ms": dec_bound, "bound_by": dec_by,
    }
    del dec_in
    for row in (fa_row, dec_row):
        row["kernel_ms"] = row["ms"]
        log(f"[kernels] {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, datasheet peaks)")
    return [fa_row, dec_row]


def _kernel_controls(torch, q, k, v, got):
    """Hold the sound bf16 kernel output against fp32 references of kernels
    with planted faults: the tight limit must reject every one of them.
    Also reads how many elements the plain-path limit (2e-2) would flag."""
    S = q.shape[2]
    tail = S - S % 64 if S % 64 else S - 64  # first key of the last partial tile
    readings = []
    for fault, kw in (("causal offset +1 (one future key)", {"shift": 1}),
                      ("causal offset -1 (diagonal key missing)", {"shift": -1}),
                      (f"keys {tail}..{S - 1} dropped (last tile)", {"drop_from": tail})):
        want = attention_f32(torch, q, k, v, True, **kw)
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


def phase_main(torch, smi):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (make_decode_step, make_generate_loop,
                                          make_prefill_step)
    from repro_torch.models import build_model

    cfg = get_config(ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    L, D, H, KV, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for leaf, shape in ((params["layers"][0]["attn"]["wq"], (L, D, H, hd)),
                        (params["layers"][0]["attn"]["wk"], (L, D, KV, hd)),
                        (params["layers"][0]["attn"]["wo"], (L, H, hd, D)),
                        (params["layers"][0]["ffn"]["wi"], (L, D, cfg.d_ff)),
                        (params["lm_head"], (cfg.padded_vocab, D))):
        if tuple(leaf.shape) != shape or leaf.dtype != torch.bfloat16:
            raise AssertionError(f"parameter {tuple(leaf.shape)} {leaf.dtype}, "
                                 f"expected {shape} bfloat16")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[main] {cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.param_dtype}) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s; reading them once "
        f"takes {n_params * 2 / PEAK_BYTES * 1e3:.3f} ms at the datasheet rate (the "
        f"decode-step floor)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                                     device="cuda")}
    max_len = PROMPT + GEN + 1
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
    log(f"[main] launches during the served run: {counts}")
    want = {"flash_attention_fwd": cfg.n_layers, "flash_decode": cfg.n_layers * GEN}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if toks.shape != (BATCH, GEN) or toks.min().item() < 0 \
            or toks.max().item() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {tuple(toks.shape)}, "
                             f"range {toks.min().item()}..{toks.max().item()}")
    pf_ms = min(t_prefill) * 1e3
    dec_ms = (t_gen * 1e3 - pf_ms) / GEN
    log(f"[main] prefill {pf_ms:.2f} ms (min of {[round(t * 1e3, 2) for t in t_prefill]}), "
        f"decode {dec_ms:.3f} ms/step, {BATCH * GEN / t_gen:.1f} tok/s "
        f"(generate {t_gen * 1e3:.1f} ms for {BATCH}x{GEN} tokens) on {smi}")

    # where the time goes: a profiled prefill and a profiled window of decode steps
    (lk, ck), _ = _profile(torch, "prefill", lambda: prefill(params, batch))
    kdec = make_decode_step(model)
    tok = lk[:, :cfg.vocab_size].argmax(-1)

    def decode_window(n=8):
        for t in range(n):
            pos = torch.full((BATCH,), PROMPT + t, dtype=torch.int32, device="cuda")
            kdec(params, ck, tok, pos)

    _profile(torch, "decode x8", decode_window)

    # teacher-forced parity: kernel path vs plain path, both fed the served
    # tokens (the prefill's argmax, then each step's)
    V = cfg.vocab_size
    inputs = torch.cat([tok[:, None], toks[:, :-1]], dim=1)
    plain = build_model(replace(cfg, attn_impl="ref"))
    want = _teacher_forced(torch, make_prefill_step(plain, max_len), make_decode_step(plain),
                           params, batch, inputs)
    got = _teacher_forced(torch, prefill, kdec, params, batch, inputs)
    for t in range(GEN):
        if not torch.equal(got[0][t + 1][:, :V].argmax(-1), toks[:, t]):
            raise AssertionError(f"step {t}: the served tokens are not the kernel "
                                 f"path's argmax")
    agree = sum((g[:, :V].argmax(-1) == w[:, :V].argmax(-1)).sum().item()
                for g, w in zip(got[0][1:], want[0][1:]))
    sound = _parity("kernel path", got, want)
    log(f"[main] greedy choice of the kernel and plain paths agrees on "
        f"{agree}/{BATCH * GEN} tokens")
    if sound["logits_beyond"] or sound["cache_beyond"]:
        raise AssertionError(f"kernel-path logits or cache differ from the plain path "
                             f"beyond atol {LIMIT_ATOL} + rtol {LIMIT_RTOL}: {sound}")
    del got

    # controls: the same check on paths with planted faults
    controls = []
    for fault, must_catch, patch in _faults(torch, ops, cfg.n_heads, cfg.n_kv_heads):
        with _planted(ops, **patch):
            reading = _parity(f"control, {fault}",
                              _teacher_forced(torch, prefill, kdec, params, batch, inputs), want)
        caught = bool(reading["logits_beyond"] or reading["cache_beyond"])
        if must_catch and not caught:
            raise AssertionError(f"control {fault}: the limit does not reject it")
        controls.append(dict(reading, fault=fault, caught=caught))
    return {"prefill_ms": pf_ms, "decode_ms_per_step": dec_ms,
            "tok_per_s": BATCH * GEN / t_gen, "launches": counts, "parity": sound,
            "greedy_agree": agree, "controls": controls}


def _teacher_forced(torch, prefill, decode, params, batch, inputs):
    """Prefill, then one decode step per column of ``inputs``; the logits of
    every step (prefill first) and the final cache."""
    logits, cache = prefill(params, batch)
    out = [logits]
    for t in range(inputs.shape[1]):
        pos = torch.full((BATCH,), PROMPT + t, dtype=torch.int32, device="cuda")
        logits, cache = decode(params, cache, inputs[:, t], pos)
        out.append(logits)
    return out, cache


def _parity(name, got, want):
    """Logits of every step and the final cache of a teacher-forced run
    against the plain path's: max abs error and elements beyond the limit."""
    res = {}
    for part, g, w in (("logits", got[0], want[0]),
                       ("cache", list(_leaves(got[1])), list(_leaves(want[1])))):
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


def _faults(torch, ops, H, KV):
    """(fault, whether the limit must reject it, replacements for ops).
    Each replacement calls the sound front door (and so the kernel) on
    altered inputs."""
    attention, decode_attention = ops.attention, ops.decode_attention
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

    def newest_dropped(q, k, v, length, scale=None, impl="auto"):
        return decode_attention(q, k, v, length - 1, scale, impl)

    # one key of 1000+ moves the logits about as much as bf16 rounding does:
    # read, not required
    return [("prefill rows see one future key", True, {"attention": future_key}),
            ("decode head h reads KV head h % KV", True, {"decode_attention": head_mod}),
            ("decode drops the newest key", False, {"decode_attention": newest_dropped})]


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


def _profile(torch, name, fn):
    """Run ``fn`` once under torch.profiler; log wall time, the device's busy
    and idle shares, and the kernels that took the most device time.  The
    profiler slows the host, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies); CPU ops carry their kernels'
    # device time as well and would count it twice
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
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
    return out, {"wall_ms": wall_ms, "busy_ms": busy_ms, "device_ops": n_kernels}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    smi = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    main_res = phase_main(torch, smi)
    for row in rows:
        row["launches"] = main_res["launches"][row["name"]]
    log("[main] " + json.dumps(dict(main_res, card=smi)))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
