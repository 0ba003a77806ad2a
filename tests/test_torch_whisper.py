"""The port's Whisper encoder-decoder vs the JAX reference, with the same
weights.

whisper-smoke (d 64, 2 encoder and 2 decoder layers, 4 heads of 16, the
plain GELU MLP, LayerNorm, qkv biases, no RoPE, 64 audio frames; fp32)
crosses from JAX through ``repro_torch.bridge``; both packages then run,
on the same tokens and frame embeddings from a seeded numpy generator:

* the tree (leaf names, shapes, dtypes, the lists of layers), the encoder
  positions (``sinusoids``) and ``encode``;
* prefill logits and every cache leaf (the self-attention ``k``/``v`` and
  the cross ``mem_k``/``mem_v``), four decode steps, the final cache and
  the greedy tokens;
* the loss and every gradient leaf with remat off and on, and three
  ``make_train_step`` steps;
* twins of tests/test_models.py's per-arch tests, the serve CLI, and the
  train CLI's refusal of enc_dec and visual_stub configs (as the
  reference's driver refuses them).

The JAX side runs its ``ref`` path and, with ``attn_impl = "interpret"``,
its Pallas kernels in interpret mode.  Tolerances: fp32 on the CPU, atol
= rtol = 1e-4 (as tests/test_torch_serve.py), train steps 1e-5 (as
tests/test_torch_train.py), the twins of tests/test_models.py its 2e-3.
"""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.launch.steps import make_generate_loop as jmake_generate_loop
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jbuild_model
from repro.models import whisper as jwhisper
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.steps import (make_decode_step, make_generate_loop, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model, whisper
from repro_torch.optim import AdamWConfig, global_norm
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ARCH = "whisper-tiny"
TOL = 1e-4
STEP_TOL = 1e-5
B, S, GEN = 2, 32, 4
MAX_LEN = S + GEN + 1
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)  # as test_torch_train.py
ZERO_LAUNCHES = {"flash_attention_fwd": 0, "flash_decode": 0, "mamba2_scan": 0,
                 "rwkv6_scan": 0}


def close(got, want, tol=TOL, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    # `pytest -s` shows these lines: the CPU parity readings of PERF.md
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split(' ')[0]} {name}: "
          f"max_abs_err={np.abs(got - want).max():.3e} tol={tol:g}")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=name)


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _batch(cfg, seed=0, labels=False):
    """numpy tokens, frame embeddings (B, n_audio_ctx, d_model) and labels."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "frames": rng.normal(size=(B, cfg.enc_dec.n_audio_ctx, cfg.d_model))
             .astype(np.float32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config(ARCH, smoke=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, get_config(ARCH, smoke=True), _port(jparams), {}


def _keystr_names(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


def test_port_init_has_the_reference_tree():
    """Same leaf names, shapes and dtypes as the JAX tree in bf16: lists of
    per-layer dicts (not stacked), ``pos_dec`` of 32776 rows, the unused
    ``wg`` of the plain MLP, LayerNorm biases, qkv biases, no ``lm_head``;
    the bridge carries the JAX tree across bit for bit."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jbuild_model(replace(jget_config(ARCH, smoke=True), **bf16)).init(
        jax.random.PRNGKey(0))
    cfg = replace(get_config(ARCH, smoke=True), **bf16)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    names = bridge.leaf_names(params)
    assert names == _keystr_names(jparams)
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for (path, a), b in zip(jleaves, tree_leaves(params)):
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        assert b.dtype == want_dtype[a.dtype.name], jax.tree_util.keystr(path)
    assert sorted(params) == ["dec_layers", "dec_norm", "embed", "enc_layers", "enc_norm",
                              "pos_dec"]
    assert len(params["enc_layers"]) == cfg.enc_dec.n_enc_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    assert tuple(params["pos_dec"].shape) == (32776, cfg.d_model)
    assert sorted(params["dec_layers"][0]) == ["attn", "ln1", "ln2", "lnx", "mlp", "xattn"]
    assert sorted(params["enc_layers"][0]["mlp"]) == ["wg", "wi", "wo"]
    assert sorted(params["dec_layers"][1]["xattn"]) == ["bk", "bq", "bv", "wk", "wo", "wq", "wv"]
    np_tree = jax.tree.map(np.asarray, jparams)
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_tree, "cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("length,channels", [(64, 64), (1500, 384)])
def test_sinusoids_match_jax(length, channels):
    """The encoder positions in fp32, at the smoke size and whisper-tiny's
    (1500 frames, d 384), element by element within what fp32 allows: the
    two packages' ``exp`` may differ by one unit in the last place of a
    timescale, which the angle t * inv carries t-fold (1e-4 at t = 1499),
    and the angle and the sine each round once.  So |got - want| <=
    2^-22 (t * inv + 1)."""
    got = whisper.sinusoids(length, channels)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, channels)
    want = np.asarray(jwhisper.sinusoids(length, channels))
    inv = np.exp(-np.log(10000.0) / (channels // 2 - 1) * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    bound = 2.0 ** -22 * (np.concatenate([ang, ang], axis=1) + 1)
    err = np.abs(got.numpy().astype(np.float64) - want)
    print(f"[parity] sinusoids {length}x{channels}: max_abs_err={err.max():.3e}, "
          f"{100 * (err / bound).max():.0f}% of the elementwise bound at most")
    assert (err <= bound).all()


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_encode_matches_jax(smoke, impl):
    jcfg, jparams, cfg, params, _ = smoke
    frames = _batch(cfg)["frames"]
    want = jax.jit(lambda p, f: jwhisper.encode(replace(jcfg, attn_impl=impl), p, f))(
        jparams, jnp.asarray(frames))
    with torch.inference_mode():
        got = whisper.encode(cfg, params, torch.from_numpy(frames))
    assert tuple(got.shape) == (B, cfg.enc_dec.n_audio_ctx, cfg.d_model)
    close(got, want, name="encoder output")


def _close_cache(cache, jcache, name):
    """Every leaf, by its keystr name, shape and value."""
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert bridge.leaf_names(cache) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (path, want), got in zip(jleaves, tree_leaves(cache)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        close(got, want, name=f"{name} {jax.tree_util.keystr(path)}")


def _jax_prefill_decode(jcfg, jparams, batch, impl):
    """JAX prefill logits and cache, then GEN decode steps fed JAX's greedy
    tokens; the logits of every step, the primed and final caches, and the
    tokens fed."""
    model = jbuild_model(replace(jcfg, attn_impl=impl))
    logits, cache = jax.jit(model.prefill, static_argnums=2)(jparams, _jbatch(batch), MAX_LEN)
    out = [np.asarray(logits)]
    primed = jax.tree.map(np.asarray, cache)
    step = jax.jit(model.decode_step)
    fed = []
    for t in range(GEN):
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], -1)
        fed.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok, jnp.full((B,), S + t, jnp.int32))
        out.append(np.asarray(logits))
    return out, primed, jax.tree.map(np.asarray, cache), fed


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_prefill_cache_and_decode_match_jax(smoke, impl):
    """Prefill logits, every leaf of the primed cache (``self`` k/v of
    MAX_LEN slots, ``mem_k``/``mem_v`` (B, H, n_audio_ctx, hd)), every
    decode step's logits and the final cache."""
    jcfg, jparams, cfg, params, _ = smoke
    batch = _batch(cfg)
    want, jprimed, jfinal, fed = _jax_prefill_decode(jcfg, jparams, batch, impl)
    model = build_model(cfg)
    logits, cache = make_prefill_step(model, MAX_LEN)(params, _tbatch(batch))
    close(logits, want[0], name="prefill logits")
    _close_cache(cache, jprimed, "primed cache")
    H, hd, T = cfg.n_heads, cfg.hd, cfg.enc_dec.n_audio_ctx
    for lc in cache["layers"]:
        assert tuple(lc["mem_k"].shape) == tuple(lc["mem_v"].shape) == (B, H, T, hd)
        assert tuple(lc["self"]["k"].shape) == (B, MAX_LEN, cfg.n_kv_heads, hd)
    step = make_decode_step(model)
    for t in range(GEN):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = step(params, cache, torch.tensor(fed[t]).long(), pos)
        close(logits, want[t + 1], name=f"decode step {t}")
    _close_cache(cache, jfinal, "final cache")
    assert ops.launch_counts() == ZERO_LAUNCHES


def test_generate_tokens_identical_to_jax(smoke):
    jcfg, jparams, cfg, params, _ = smoke
    batch = _batch(cfg)
    jgen = jax.jit(jmake_generate_loop(jbuild_model(jcfg), GEN), static_argnums=2)
    want = np.asarray(jgen(jparams, _jbatch(batch), MAX_LEN))
    got = make_generate_loop(build_model(cfg), GEN)(params, _tbatch(batch), MAX_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(smoke, remat, impl):
    """Loss and every grad leaf at 1e-4, remat off and on (each decoder
    layer checkpointed with its cross keys and values recomputed inside);
    the tied embedding's gradient sums its two uses; the unused ``wg`` of
    every plain MLP has a zero gradient on both sides.  ``impl="cuda"`` on
    CPU tensors runs ops' autograd Function with the kernel's plain
    version."""
    jcfg, jparams, cfg, _, cache = smoke
    batch = _batch(cfg, seed=1, labels=True)
    if remat not in cache:
        cache[remat] = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
            jbuild_model(replace(jcfg, remat=remat)).loss))(jparams, _jbatch(batch)))
    jloss, jgrads = cache[remat]
    params = _port(jparams)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = build_model(replace(cfg, remat=remat, attn_impl=impl)).loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    close(loss.item(), float(jloss), name="loss")
    names = bridge.leaf_names(params)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads) == len(names)
    close(np.concatenate([g.numpy().ravel() for g in grads]),
          np.concatenate([np.ravel(jg) for jg in jleaves]), name="every grad leaf")
    for n, g, jg in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, atol=TOL, rtol=TOL, err_msg=n)
        if n.endswith("['mlp']['wg']"):
            assert not g.any() and not np.any(jg), n
        elif "['xattn']" in n or "['attn']['w" in n:
            assert g.abs().max() > 0, n


def test_train_steps_match_jax(smoke):
    """Three ``make_train_step`` steps against JAX's: every state leaf at
    1e-5 and the metrics."""
    jcfg, jparams, cfg, _, _ = smoke
    jstate = {"params": jparams, "opt": jadamw_init(JAdamWConfig(**OPT), jparams)}
    state = _port(jstate)
    jstep = jax.jit(jmake_train_step(jbuild_model(jcfg), JAdamWConfig(**OPT)))
    step = make_train_step(build_model(replace(cfg, attn_impl="cuda")), AdamWConfig(**OPT))
    for i in range(3):
        batch = _batch(cfg, seed=10 + i, labels=True)
        jstate, jmet = jstep(jstate, _jbatch(batch))
        state, met = step(state, _tbatch(batch))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=k)
        assert int(state["opt"]["step"]) == i + 1
        got = np.concatenate([bridge.params_to_numpy(t).astype(np.float32).ravel()
                              for t in tree_leaves(state)])
        want = np.concatenate([np.asarray(t, np.float32).ravel()
                               for t in jax.tree.leaves(jstate)])
        close(got, want, tol=STEP_TOL, name=f"step {i + 1} every state leaf")


def test_arch_smoke_train_step():
    """Twin of tests/test_models.py's: one forward and backward of the
    port's own init, finite loss and grads with a positive norm, prefill
    logits of the right shape."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg)
    assert model.is_enc_dec and model.logits is None
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg, seed=1, labels=True))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss(params, batch)
    assert torch.isfinite(loss)
    gn = float(global_norm(torch.autograd.grad(loss, leaves, allow_unused=True,
                                               materialize_grads=True)))
    assert np.isfinite(gn) and gn > 0
    with torch.no_grad():
        logits, _ = model.prefill(params, batch, S + 4)
    assert logits.shape == (B, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()


def test_arch_decode_matches_forward():
    """Twin of tests/test_models.py's enc_dec branch: prefill S - 4 tokens,
    decode the last 4; each step's logits against a prefill of the tokens
    up to it (the reference checks the last), at that test's 2e-3."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg, seed=1))
    P = S - 4
    with torch.inference_mode():
        logits, cache = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :P]), S)
        for t in range(P, S):
            logits, cache = model.decode_step(params, cache, batch["tokens"][:, t],
                                              torch.full((B,), t, dtype=torch.int32))
            full, _ = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :t + 1]), S)
            close(logits[:, :cfg.vocab_size], full[:, :cfg.vocab_size], tol=2e-3,
                  name=f"decode {t}")


def test_serve_cli_runs_whisper_on_cpu():
    """``launch/serve.py --arch whisper-tiny --smoke --device cpu`` hands the
    encoder its seeded frame embeddings."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("[serve] generated (2, 3) tokens")
    assert out[1] == "[serve] audio frame embeddings (2, 64, 64) through the encoder"
    assert out[3] == f"[serve] kernel launches (warm run): {ZERO_LAUNCHES}"
    assert out[4].startswith("[serve] prefill ") and "ms/step" in out[4]


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_train_cli_refuses_multimodal_like_the_reference(arch, tmp_path, monkeypatch):
    """Both packages' train drivers stop with a ``SystemExit`` naming the LM
    archs before they make data or a model: their batches hold tokens
    only."""
    argv = ["--arch", arch, "--smoke", "--data", str(tmp_path / "data"),
            "--ckpt", str(tmp_path / "ckpt")]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    with pytest.raises(SystemExit) as jexit:
        jtrain.main()
    with pytest.raises(SystemExit) as texit:
        train.main([*argv, "--device", "cpu"])
    for exc in (jexit.value, texit.value):
        assert isinstance(exc.code, str) and exc.code.startswith("train driver covers LM archs")
    assert not any(tmp_path.iterdir())
