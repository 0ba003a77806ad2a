"""The port's multi-head latent attention and deepseek-v2-236b vs the JAX
reference, with the same weights.

* the MLA block alone (``mla_apply``; ``mla_prefill``'s output and its
  ``ckv``/``kpe`` caches; ``mla_decode`` steps against the primed cache)
  on one block's JAX-initialised weights, JAX on its plain attention and
  on its Pallas kernel in interpret mode;
* deepseek-v2 smoke (two layers: a leading dense layer and a MoE layer
  with a shared expert, d 128, MLA at q_lora 64, kv_lora 32, qk_nope 16,
  qk_rope 16, v_head 16; fp32) through both packages: the tree, full
  logits, prefill, every cache leaf, four decode steps, greedy tokens,
  the loss (xent + aux) and every grad leaf with remat off, ``nothing``
  and ``dots``, three train steps;
* twins of tests/test_models.py's per-arch tests and the serve CLI.

Weights cross from JAX through ``repro_torch.bridge``; inputs come from a
seeded numpy generator.  Tolerances: fp32 on the CPU, atol = rtol = 1e-4
(as tests/test_torch_serve.py), train steps 1e-5 (as
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

from _torch_twins import PUBLISHED_ONLY, PUBLISHED_ONLY_MOE, with_reference_rope_and_routing
from repro.configs import get_config as jget_config
from repro.launch.steps import make_generate_loop as jmake_generate_loop
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import (make_decode_step, make_generate_loop, make_prefill_step,
                                      make_train_step)
from repro_torch.models import attention, build_model
from repro_torch.models.lm import layer_groups
from repro_torch.optim import AdamWConfig, global_norm
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
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
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _batch(cfg, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def deepseek():
    jcfg = jget_config(ARCH, smoke=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, get_config(ARCH, smoke=True), _port(jparams), {}


def test_config_is_the_reference_config():
    """The published config field for field (sub-configs included), and
    the smoke config; the layers form a ``dense`` and a ``moe`` group of
    ``mla`` blocks.  The full config also states what the reference lacks
    (YaRN, group-limited routing with scaled gates, the dropless dispatch):
    with the reference's RoPE and routing in their place it is the
    reference's, and the smoke config is the reference's as it is."""
    full = get_config(ARCH)
    assert (full.rope_type, full.yarn_factor, full.yarn_original_max_len, full.yarn_beta_fast,
            full.yarn_beta_slow, full.yarn_mscale, full.yarn_mscale_all_dim) == \
        ("yarn", 40.0, 4096, 32.0, 1.0, 0.707, 0.707)
    assert (full.moe.n_group, full.moe.topk_group, full.moe.routed_scaling,
            full.moe.norm_topk, full.moe.dropless) == (8, 3, 16.0, False, True)
    assert with_reference_rope_and_routing(get_config(ARCH, smoke=True)) == \
        get_config(ARCH, smoke=True)
    for smoke in (False, True):
        want = jget_config(ARCH, smoke=smoke).__dict__
        got = with_reference_rope_and_routing(get_config(ARCH, smoke=smoke)).__dict__
        assert set(got) - set(want) == set(PUBLISHED_ONLY) - {"rope_type"}
        assert set(got["moe"].__dict__) - set(want["moe"].__dict__) == set(PUBLISHED_ONLY_MOE)
        got = {k: v for k, v in got.items() if k in want}
        for k, v in want.items():
            if k in ("attn_impl", "scan_impl"):  # the port's "auto": kernels on the card
                continue
            if k == "moe":
                assert {f: x for f, x in got[k].__dict__.items()
                        if f not in PUBLISHED_ONLY_MOE} == v.__dict__, k
            elif k == "mla":
                assert got[k].__dict__ == v.__dict__, k
            else:
                assert got[k] == v, k
    groups = layer_groups(get_config(ARCH))
    assert [(g.kind, g.ffn, g.count) for g in groups] == [("mla", "dense", 1), ("mla", "moe", 59)]


# -- the block alone ------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    """One MLA block's weights (JAX init) in both packages and a seeded input."""
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = jattn.mla_init(jcfg, jax.random.PRNGKey(7))
    x = np.random.default_rng(7).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return jcfg, cfg, jp, _port(jp), x, pos


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_mla_apply_matches_jax(block, impl, causal):
    """The reference's padded-V attention at head_dim qk_nope + qk_rope =
    32 (V 16 wide, padded and sliced back), scale 32^-0.5."""
    jcfg, cfg, jp, p, x, pos = block
    want = jattn.mla_apply(replace(jcfg, attn_impl=impl), jp, jnp.asarray(x), jnp.asarray(pos),
                           causal=causal)
    for port_impl in ("ref", "cuda"):  # cuda on CPU tensors: ops' Function, plain version
        got = attention.mla_apply(replace(cfg, attn_impl=port_impl), p, torch.from_numpy(x),
                                  torch.from_numpy(pos).long(), causal=causal)
        close(got, want, name=f"mla_apply ({port_impl})")
    assert ops.launch_counts() == ZERO_LAUNCHES


def test_mla_prefill_and_decode_match_jax(block):
    """Prefill's output and both caches, then four decode steps: each
    step's output and the caches after it."""
    jcfg, cfg, jp, p, x, pos = block
    P = S - GEN
    jcache = jattn.mla_init_cache(jcfg, B, S, jnp.float32)
    cache = attention.mla_init_cache(cfg, B, S, torch.float32, torch.device("cpu"))
    jy, jcache = jattn.mla_prefill(jcfg, jp, jnp.asarray(x[:, :P]), jnp.asarray(pos[:, :P]),
                                   jcache)
    y, cache = attention.mla_prefill(cfg, p, torch.from_numpy(x[:, :P]),
                                     torch.from_numpy(pos[:, :P]).long(), cache)
    close(y, jy, name="prefill out")
    for key in ("ckv", "kpe"):
        assert tuple(cache[key].shape) == jcache[key].shape
        close(cache[key], jcache[key], name=f"prefill cache {key}")
    for t in range(P, S):
        jy, jcache = jattn.mla_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                      jnp.full((B,), t, jnp.int32), jcache)
        y, cache = attention.mla_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                        torch.full((B,), t, dtype=torch.int32), cache)
        close(y, jy, name=f"decode {t} out")
        for key in ("ckv", "kpe"):
            close(cache[key], jcache[key], name=f"decode {t} cache {key}")
    # decoding the whole sequence one step at a time ends where one
    # full-sequence pass does: the latent attention equals the expanded one
    close(y[:, 0], attention.mla_apply(cfg, p, torch.from_numpy(x),
                                       torch.from_numpy(pos).long())[:, -1].numpy(),
          tol=2e-4, name="last decode vs full pass")


def test_mla_decode_masks_future_positions(block):
    """A decode step at position t reads only cache slots <= t: garbage in
    the later slots changes nothing."""
    _, cfg, _, p, x, pos = block
    P = S - GEN
    outs = []
    for fill in (0.0, 1e3):
        cache = attention.mla_init_cache(cfg, B, S, torch.float32, torch.device("cpu"))
        cache["ckv"].fill_(fill)
        cache["kpe"].fill_(fill)
        _, cache = attention.mla_prefill(cfg, p, torch.from_numpy(x[:, :P]),
                                         torch.from_numpy(pos[:, :P]).long(), cache)
        y, _ = attention.mla_decode(cfg, p, torch.from_numpy(x[:, P:P + 1]),
                                    torch.full((B,), P, dtype=torch.int32), cache)
        outs.append(y)
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


# -- deepseek-v2 smoke through both packages --------------------------------------------
def test_port_init_has_the_reference_tree():
    """In bf16: the same leaf names, shapes and dtypes as the JAX tree (the
    MLA projections and norms, the dense first layer, the router fp32
    beside the bf16 experts and the shared expert); the bridge carries it
    bit for bit."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jbuild_model(replace(jget_config(ARCH, smoke=True), **bf16)).init(
        jax.random.PRNGKey(0))
    cfg = replace(get_config(ARCH, smoke=True), **bf16)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    names = bridge.leaf_names(params)
    assert names == [jax.tree_util.keystr(p) for p, _ in jleaves]
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for (path, a), b in zip(jleaves, tree_leaves(params)):
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        assert b.dtype == want_dtype[a.dtype.name], jax.tree_util.keystr(path)
    m, H = cfg.mla, cfg.n_heads
    mix = params["layers"][1]["attn"]
    assert sorted(mix) == ["k_up", "kv_down", "kv_norm", "q_down", "q_norm", "q_up", "v_up",
                           "wo"]
    assert tuple(mix["q_up"].shape) == (1, m.q_lora, H, m.qk_nope + m.qk_rope)
    assert tuple(mix["kv_down"].shape) == (1, cfg.d_model, m.kv_lora + m.qk_rope)
    assert tuple(mix["wo"].shape) == (1, H, m.v_head, cfg.d_model)
    assert "['lm_head']" in names
    np_tree = jax.tree.map(np.asarray, jparams)
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_tree, "cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_full_logits_match_jax(deepseek):
    jcfg, jparams, cfg, params, _ = deepseek
    batch = _batch(cfg)
    want = jbuild_model(jcfg).logits(jparams, _jbatch(batch))
    with torch.inference_mode():
        got = build_model(cfg).logits(params, _tbatch(batch))
    close(got, want, name="logits")


def _close_cache(cache, jcache, name):
    """Every leaf (``ckv``/``kpe`` of each group) by name, shape and value."""
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert bridge.leaf_names(cache) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    assert {n.split("'")[-2] for n in bridge.leaf_names(cache)} == {"ckv", "kpe"}
    for (path, want), got in zip(jleaves, tree_leaves(cache)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        close(got, want, name=f"{name} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_prefill_cache_and_decode_match_jax(deepseek, impl):
    """Prefill logits, every leaf of the primed cache, four decode steps'
    logits and the final cache; JAX on its plain path and on its Pallas
    kernels in interpret mode."""
    jcfg, jparams, cfg, params, _ = deepseek
    batch = _batch(cfg)
    model = jbuild_model(replace(jcfg, attn_impl=impl))
    jlogits, jcache = jax.jit(model.prefill, static_argnums=2)(jparams, _jbatch(batch), MAX_LEN)
    logits, cache = make_prefill_step(build_model(cfg), MAX_LEN)(params, _tbatch(batch))
    close(logits, jlogits, name="prefill logits")
    _close_cache(cache, jax.tree.map(np.asarray, jcache), "primed cache")
    jstep, step = jax.jit(model.decode_step), make_decode_step(build_model(cfg))
    for t in range(GEN):
        tok = np.array(jnp.argmax(jlogits[:, :cfg.vocab_size], -1))
        pos = S + t
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.full((B,), pos, jnp.int32))
        logits, cache = step(params, cache, torch.from_numpy(tok).long(),
                             torch.full((B,), pos, dtype=torch.int32))
        close(logits, jlogits, name=f"decode step {t}")
    _close_cache(cache, jax.tree.map(np.asarray, jcache), "final cache")
    assert ops.launch_counts() == ZERO_LAUNCHES


def test_generate_tokens_identical_to_jax(deepseek):
    jcfg, jparams, cfg, params, _ = deepseek
    batch = _batch(cfg)
    jgen = jax.jit(jmake_generate_loop(jbuild_model(jcfg), GEN), static_argnums=2)
    want = np.asarray(jgen(jparams, _jbatch(batch), MAX_LEN))
    got = make_generate_loop(build_model(cfg), GEN)(params, _tbatch(batch), MAX_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("remat,policy", [(False, "nothing"), (True, "nothing"),
                                          (True, "dots")], ids=["off", "nothing", "dots"])
def test_loss_and_grads_match_jax(deepseek, remat, policy, impl):
    """The loss (xent + the MoE layer's aux) and every grad leaf at 1e-4,
    the MLA projections' included.  ``impl="cuda"`` on CPU tensors runs
    ops' attention Function with the kernel's plain version."""
    jcfg, jparams, _, _, cache = deepseek
    cfg = get_config(ARCH, smoke=True)
    batch = _batch(cfg, seed=1, labels=True)
    key = (remat, policy)
    if key not in cache:
        jmodel = jbuild_model(replace(jcfg, remat=remat, remat_policy=policy))
        cache[key] = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(jmodel.loss))(
            jparams, _jbatch(batch)))
    jloss, jgrads = cache[key]
    params = _port(jparams)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    model = build_model(replace(cfg, remat=remat, remat_policy=policy, attn_impl=impl))
    loss = model.loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves)
    close(loss.item(), float(jloss), name="loss (xent + aux)")
    names = bridge.leaf_names(params)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads) == len(names)
    close(np.concatenate([g.numpy().ravel() for g in grads]),
          np.concatenate([np.ravel(jg) for jg in jleaves]), name="every grad leaf")
    for n, g, jg in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, atol=TOL, rtol=TOL, err_msg=n)
    mla = [g for n, g in zip(names, grads) if "['attn']" in n]  # 8 leaves a group
    assert len(mla) == 8 * len(layer_groups(cfg)) and all(g.abs().max() > 0 for g in mla)


def test_train_steps_match_jax(deepseek):
    """Three ``make_train_step`` steps against JAX's: every state leaf at
    1e-5 and the metrics."""
    jcfg, jparams, cfg, _, _ = deepseek
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
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg, seed=1, labels=True))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss(params, batch)
    assert torch.isfinite(loss)
    gn = float(global_norm(torch.autograd.grad(loss, leaves)))
    assert np.isfinite(gn) and gn > 0
    with torch.no_grad():
        logits, _ = model.prefill(params, batch, S + 4)
    assert logits.shape == (B, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()


def test_arch_decode_matches_forward():
    """Twin of tests/test_models.py's: prefill S - 4 tokens, decode the last
    4 in the latent space, each step's logits against one full forward
    (expanded per-head keys), at that test's 2e-3 (the smoke config is
    dropless, so no capacity separates them)."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg, seed=1))
    P = S - 4
    with torch.inference_mode():
        full = model.logits(params, batch)
        logits, cache = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :P]), S)
        close(logits, full[:, P - 1], tol=2e-3, name="prefill")
        for t in range(P, S):
            logits, cache = model.decode_step(params, cache, batch["tokens"][:, t],
                                              torch.full((B,), t, dtype=torch.int32))
            close(logits, full[:, t], tol=2e-3, name=f"decode {t}")


def test_serve_cli_runs_deepseek_on_cpu():
    """``launch/serve.py --arch deepseek-v2-236b --smoke --device cpu``."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("[serve] generated (2, 3) tokens")
    assert out[2] == f"[serve] kernel launches (warm run): {ZERO_LAUNCHES}"
    assert out[3].startswith("[serve] prefill ") and "ms/step" in out[3]
