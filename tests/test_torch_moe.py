"""The port's mixture-of-experts layer and granite-moe-3b-a800m vs the JAX
reference, with the same weights.

* ``moe_apply`` (capacity dispatch and dropless) against the dense oracle,
  twins of tests/test_models.py's MoE tests, and against the reference's
  ``moe_apply`` at 1e-4: y, the aux loss and, for the capacity path, the
  kept mask of every assignment (boolean equality, drops included);
* the router's fp32 logits from bf16 inputs against the reference's, held
  to a bound on the order of the fp32 sums;
* granite-moe smoke (two layers, d 128, dropless, fp32) through both
  packages: the tree, full logits, prefill, every cache leaf, decode
  steps, greedy tokens, the loss (xent + aux) and every grad leaf with
  remat off, ``nothing`` and ``dots``, three train steps; a
  deepseek-style variant (a shared expert, a leading dense layer) with
  and without capacity drops;
* ``dots`` saves the 2-D products: the backward recomputes fewer
  ``aten.mm`` than under ``nothing``.

Weights cross from JAX through ``repro_torch.bridge``; inputs come from a
seeded numpy generator.  The reference's kept mask and router logits are
read from its own ``_moe_group`` by evaluating its jaxpr equation by
equation.  Tolerances: fp32 on the CPU, atol = rtol = 1e-4 (as
tests/test_torch_serve.py), train steps 1e-5 (as tests/test_torch_train.py),
the oracle twins that file's 2e-4.
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
from jax.extend import core as jcore
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.launch.steps import make_generate_loop as jmake_generate_loop
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jbuild_model
from repro.models import mlp as jmlp
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import (make_decode_step, make_generate_loop, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model, lm, mlp
from repro_torch.models.lm import layer_groups
from repro_torch.optim import AdamWConfig, global_norm
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ARCH = "granite-moe-3b-a800m"
TOL = 1e-4
STEP_TOL = 1e-5
B, S, GEN = 2, 32, 6
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


def _moe_cfgs(**moe):
    """The granite smoke config of both packages with its MoE fields changed."""
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    return replace(jcfg, moe=replace(jcfg.moe, **moe)), replace(cfg, moe=replace(cfg.moe, **moe))


def _reference_intermediates(fn, x, pick):
    """Evaluate ``fn(x)``'s jaxpr equation by equation; the outputs for which
    ``pick(primitive name, output)`` holds, in order."""
    closed = jax.make_jaxpr(fn)(x)
    env = dict(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, [x]))
    found = []
    for eqn in closed.jaxpr.eqns:
        args = [v.val if isinstance(v, jcore.Literal) else env[v] for v in eqn.invars]
        outs = eqn.primitive.bind(*args, **eqn.params)
        outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
        found += [o for o in outs if pick(eqn.primitive.name, o)]
    return found


def _reference_keep(jcfg, jp, xg, cf):
    """The reference's kept mask (G, T, K): the boolean output of ``pos < C``
    in its ``_moe_group``, group by group."""
    T, K = xg.shape[1], jcfg.moe.top_k
    out = []
    for g in xg:
        (keep,) = _reference_intermediates(
            lambda x: jmlp._moe_group(jcfg, jp, x, cf), g,
            lambda name, o: name == "lt" and o.dtype == jnp.bool_ and o.shape == (T, K))
        out.append(np.asarray(keep))
    return np.stack(out)


# -- the layer: oracle twins ---------------------------------------------------------
def _layer(cfg, seed, shape=(2, 64)):
    """The port's own init and a seeded input."""
    p = mlp.moe_init(cfg, torch.Generator().manual_seed(seed))
    x = np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    return p, torch.from_numpy(x)


def test_moe_capacity_and_dropless_match_oracle():
    """Twin of tests/test_models.py's: with capacity to spare (cf 8) the
    capacity path, and the dropless path, equal the all-experts oracle."""
    _, cfg = _moe_cfgs(dropless=False, capacity_factor=8.0, group_tokens=32)
    p, x = _layer(cfg, 3)
    y_oracle = mlp.moe_apply_dense_oracle(cfg, p, x)
    y_cap, aux = mlp.moe_apply(cfg, p, x)
    close(y_cap, y_oracle, tol=2e-4, name="capacity vs oracle")
    y_dl, _ = mlp.moe_apply(replace(cfg, moe=replace(cfg.moe, dropless=True)), p, x)
    close(y_dl, y_oracle, tol=2e-4, name="dropless vs oracle")
    assert float(aux) >= 0


def test_moe_capacity_drops_bounded():
    """Twin of tests/test_models.py's: at cf 1 some assignments drop; the
    output stays finite and within 0.9 of the oracle's norm."""
    _, cfg = _moe_cfgs(dropless=False, capacity_factor=1.0, group_tokens=64)
    p, x = _layer(cfg, 4)
    y, _ = mlp.moe_apply(cfg, p, x)
    y_oracle = mlp.moe_apply_dense_oracle(cfg, p, x)
    assert torch.isfinite(y).all()
    assert float((y - y_oracle).norm() / y_oracle.norm()) < 0.9


# -- the layer against the reference -------------------------------------------------
# (name, MoE fields, serve, (B, S)).  "drops": cf 1 leaves some assignments
# past the capacity; "odd groups": B * S = 80 is no multiple of the 32-token
# group, so the groups are gcd(80, 32) = 16 tokens, five of them, with drops.
LAYER_CASES = [
    ("capacity", dict(dropless=False, group_tokens=32), False, (2, 64)),
    ("capacity serve", dict(dropless=False, group_tokens=32), True, (2, 64)),
    ("drops", dict(dropless=False, capacity_factor=1.0, group_tokens=32), False, (2, 64)),
    ("odd groups", dict(dropless=False, capacity_factor=1.0, group_tokens=32), False, (2, 40)),
    ("dropless", dict(dropless=True), False, (2, 64)),
    ("dropless serve", dict(dropless=True), True, (2, 64)),
]


@pytest.mark.parametrize("name,moe,serve,shape", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_moe_apply_matches_jax(monkeypatch, name, moe, serve, shape):
    """y and aux at 1e-4; on the capacity path every assignment's kept flag
    equals the reference's, drops included."""
    jcfg, cfg = _moe_cfgs(**moe)
    jp = jmlp.moe_init(jcfg, jax.random.PRNGKey(5))
    x = np.random.default_rng(5).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    jy, jaux = jmlp.moe_apply(jcfg, jp, jnp.asarray(x), serve=serve)
    seen = []
    slots = mlp._slots
    monkeypatch.setattr(mlp, "_slots", lambda gi, E, C: seen.append(slots(gi, E, C)) or seen[-1])
    y, aux = mlp.moe_apply(cfg, _port(jp), torch.from_numpy(x), serve=serve)
    close(y, jy, name="y")
    close(aux.item(), float(jaux), name="aux")
    if cfg.moe.dropless:
        assert not seen
        return
    (_, keep), = seen
    G = keep.shape[0]
    cf = cfg.moe.serve_capacity_factor if serve else cfg.moe.capacity_factor
    want = _reference_keep(jcfg, jp, jnp.asarray(x.reshape(G, -1, cfg.d_model)), cf)
    np.testing.assert_array_equal(keep.numpy(), want)
    dropped = int((~keep).sum())
    print(f"[parity] {name}: {G} groups, {dropped} of {keep.numel()} assignments dropped "
          f"in both packages")
    if name in ("drops", "odd groups"):
        assert dropped > 0


def test_router_logits_in_bf16_match_jax_to_the_order_of_sums():
    """From bf16 inputs at granite's width (D 1536, E 40) the router's logits
    are fp32 sums of exact bf16 products in both packages, so they differ
    only by the order of the sums: within 2 gamma_D sum_d |x_d r_d|
    (gamma_n = n u / (1 - n u), u = 2^-24), the bound on two fp32 dot
    products of length D.  Rounding the logits to bf16 (``x @
    router.to(bf16)``) breaks that bound."""
    jcfg = jget_config(ARCH)
    D, E = jcfg.d_model, jcfg.moe.num_experts
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((256, D)).astype(np.float32), jnp.bfloat16)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    jp = {"router": jnp.asarray(router), "wi": jnp.zeros((E, D, 8), jnp.bfloat16),
          "wg": jnp.zeros((E, D, 8), jnp.bfloat16), "wo": jnp.zeros((E, 8, D), jnp.bfloat16)}
    (want,) = _reference_intermediates(
        lambda v: jmlp._moe_group(jcfg, jp, v), x,
        lambda name, o: name == "dot_general" and o.shape == (256, E) and o.dtype == jnp.float32)
    want = np.asarray(want, np.float64)
    p = {"router": torch.from_numpy(router)}
    xt = bridge.params_from_numpy(np.asarray(x), "cpu")
    got = mlp._router_logits(p, xt)
    assert got.dtype == torch.float32
    r16 = p["router"].to(torch.bfloat16).double()
    exact = xt.double() @ r16
    u = 2.0 ** -24
    bound = 2 * (D * u / (1 - D * u)) * (xt.double().abs() @ r16.abs())
    err = (got.double() - torch.from_numpy(want)).abs()
    print(f"[parity] router logits bf16: max_abs_err={err.max().item():.3e}, "
          f"{(err / bound).max().item():.2e} of the order-of-sums bound; fp32 vs exact "
          f"{(got.double() - exact).abs().max().item():.3e}")
    assert (err <= bound).all()
    rounded = (xt @ p["router"].to(torch.bfloat16)).double()
    beyond = ((rounded - torch.from_numpy(want)).abs() > bound).double().mean().item()
    print(f"[parity] router logits rounded to bf16: {beyond:.1%} of them beyond the bound")
    assert beyond > 0


# -- granite-moe smoke through both packages -----------------------------------------
@pytest.fixture(scope="module")
def granite():
    jcfg = jget_config(ARCH, smoke=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, get_config(ARCH, smoke=True), _port(jparams), {}


def _close_cache(cache, jcache, name):
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert bridge.leaf_names(cache) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (path, want), got in zip(jleaves, tree_leaves(cache)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        close(got, want, name=f"{name} {jax.tree_util.keystr(path)}")


def test_port_init_has_the_reference_tree():
    """In bf16: the same leaf names, shapes and dtypes as the JAX tree, the
    router fp32 and the experts bf16; the bridge carries it bit for bit."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jbuild_model(replace(jget_config(ARCH, smoke=True), **bf16)).init(
        jax.random.PRNGKey(0))
    cfg = replace(get_config(ARCH, smoke=True), **bf16)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert bridge.leaf_names(params) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for (path, a), b in zip(jleaves, tree_leaves(params)):
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        assert b.dtype == want_dtype[a.dtype.name], jax.tree_util.keystr(path)
    ffn = params["layers"][0]["ffn"]
    m, L, D = cfg.moe, cfg.n_layers, cfg.d_model
    assert ffn["router"].dtype == torch.float32 and ffn["wi"].dtype == torch.bfloat16
    assert tuple(ffn["router"].shape) == (L, D, m.num_experts)
    assert tuple(ffn["wi"].shape) == (L, m.num_experts, D, m.d_expert)
    assert tuple(ffn["wo"].shape) == (L, m.num_experts, m.d_expert, D)
    np_tree = jax.tree.map(np.asarray, jparams)
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_tree, "cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_full_logits_match_jax(granite):
    jcfg, jparams, cfg, params, _ = granite
    batch = _batch(cfg)
    want = jbuild_model(jcfg).logits(jparams, _jbatch(batch))
    with torch.inference_mode():
        got = build_model(cfg).logits(params, _tbatch(batch))
    close(got, want, name="logits")


def _prefill_cache_decode(jcfg, jparams, cfg, params, batch, impl):
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


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_prefill_cache_and_decode_match_jax(granite, impl):
    """Prefill logits, every leaf of the primed cache, every decode step's
    logits and the final cache; JAX on its plain path and on its Pallas
    kernels in interpret mode."""
    jcfg, jparams, cfg, params, _ = granite
    _prefill_cache_decode(jcfg, jparams, cfg, params, _batch(cfg), impl)
    assert ops.launch_counts() == ZERO_LAUNCHES


def test_generate_tokens_identical_to_jax(granite):
    jcfg, jparams, cfg, params, _ = granite
    batch = _batch(cfg)
    jgen = jax.jit(jmake_generate_loop(jbuild_model(jcfg), GEN), static_argnums=2)
    want = np.asarray(jgen(jparams, _jbatch(batch), MAX_LEN))
    got = make_generate_loop(build_model(cfg), GEN)(params, _tbatch(batch), MAX_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def _loss_and_grads(jcfg, jparams, cfg, batch, remat, policy, impl, cache):
    """Port loss and every grad leaf vs ``jax.value_and_grad`` at 1e-4."""
    key = (remat, policy)
    if key not in cache:
        jmodel = jbuild_model(replace(jcfg, remat=remat, remat_policy=policy))
        cache[key] = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(jmodel.loss))(
            jparams, _jbatch(batch)))
    jloss, jgrads = cache[key]
    params = _port(jparams)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    cfg = replace(cfg, remat=remat, remat_policy=policy, attn_impl=impl)
    loss = build_model(cfg).loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves)
    close(loss.item(), float(jloss), name="loss (xent + aux)")
    names = bridge.leaf_names(params)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads) == len(names)
    close(np.concatenate([g.numpy().ravel() for g in grads]),
          np.concatenate([np.ravel(jg) for jg in jleaves]), name="every grad leaf")
    for n, g, jg in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, atol=TOL, rtol=TOL, err_msg=n)
    return loss


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("remat,policy", [(False, "nothing"), (True, "nothing"),
                                          (True, "dots")], ids=["off", "nothing", "dots"])
def test_loss_and_grads_match_jax(granite, remat, policy, impl):
    """The loss is the xent plus the layers' aux losses; the aux part is
    nonzero.  ``impl="cuda"`` on CPU tensors runs ops' autograd Functions
    with the kernels' plain versions."""
    jcfg, jparams, cfg, params, cache = granite
    batch = _batch(cfg, seed=1, labels=True)
    loss = _loss_and_grads(jcfg, jparams, cfg, batch, remat, policy, impl, cache)
    with torch.no_grad():
        _, aux = lm.backbone(cfg, params, _tbatch(batch))
    assert 0 < aux.item() < loss.item()


def test_train_steps_match_jax(granite):
    """Three ``make_train_step`` steps against JAX's: every state leaf at
    1e-5 and the metrics."""
    jcfg, jparams, cfg, _, _ = granite
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
    4, each step's logits against one full forward, at that test's 2e-3
    (the smoke config is dropless, so no capacity separates them)."""
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


@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
def test_shared_experts_and_dense_layers_match_jax(dropless):
    """deepseek-v2's MoE on the granite smoke config: one shared expert and
    a leading dense layer of width 256, so the layers form a ``dense`` and
    a ``moe`` group; the tree, full logits, prefill, every cache leaf, the
    decode steps, and the loss and every grad leaf (remat ``dots``).  With
    capacity (cf 1.0: drops) the full logits take the train capacity and
    prefill and decode the serve one, in both packages."""
    moe = dict(num_shared=1, first_dense_layers=1, dense_d_ff=256, dropless=dropless,
               capacity_factor=1.0)
    jcfg, cfg = _moe_cfgs(**moe)
    groups = layer_groups(cfg)
    assert [(g.ffn, g.count) for g in groups] == [("dense", 1), ("moe", 1)]
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = _port(jparams)
    assert bridge.leaf_names(build_model(cfg).init(torch.Generator().manual_seed(0))) == \
        [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    assert tuple(params["layers"][0]["ffn"]["wi"].shape) == (1, cfg.d_model, 256)
    assert tuple(params["layers"][1]["ffn"]["shared"]["wi"].shape) == (1, cfg.d_model, 64)
    batch = _batch(cfg)
    with torch.inference_mode():
        close(build_model(cfg).logits(params, _tbatch(batch)),
              jbuild_model(jcfg).logits(jparams, _jbatch(batch)), name="logits")
    _prefill_cache_decode(jcfg, jparams, cfg, params, batch, "ref")
    _loss_and_grads(jcfg, jparams, cfg, _batch(cfg, seed=1, labels=True), True, "dots", "ref",
                    {})


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_policy_recomputes_fewer_matmuls():
    """Under ``dots`` the backward finds the layers' 2-D products saved and
    recomputes none of them; under ``nothing`` it recomputes every one.  So
    it runs fewer ``aten.mm``, fewer by exactly the layers' forward count
    (the forward with remat off, less the head's one product a loss chunk).
    Loss and grads are the same either way."""
    cfg = replace(get_config(ARCH, smoke=True), remat=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg, seed=1, labels=True))

    def run(policy, remat=True):
        tree = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tree)
        fwd, bwd = _CountMM(), _CountMM()
        with fwd:
            loss = build_model(replace(cfg, remat=remat, remat_policy=policy)).loss(tree, batch)
        with bwd:
            grads = torch.autograd.grad(loss, leaves)
        return loss, grads, fwd.mm, bwd.mm

    # deterministic: the embedding's backward (index_put with accumulate)
    # otherwise adds in a different order from run to run on the CPU
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        l_n, g_n, _, bwd_nothing = run("nothing")
        l_d, g_d, _, bwd_dots = run("dots")
        _, _, fwd_all, _ = run("nothing", remat=False)
    finally:
        torch.use_deterministic_algorithms(prev)
    layers_fwd = fwd_all - S // min(cfg.loss_chunk, S)
    print(f"[parity] aten.mm in the backward: nothing {bwd_nothing}, dots {bwd_dots}; "
          f"the layers' forward {layers_fwd}")
    assert bwd_dots < bwd_nothing
    assert bwd_nothing - bwd_dots == layers_fwd
    assert torch.equal(l_n, l_d)
    for a, b in zip(g_n, g_d):
        assert torch.equal(a, b)


def test_serve_cli_runs_granite_on_cpu():
    """``launch/serve.py --arch granite-moe-3b-a800m --smoke --device cpu``."""
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
