"""The port's training step against the JAX package's, on the same weights.

Smoke configs in fp32 on the CPU; JAX-initialised trees cross into the
port through ``repro_torch.bridge``; tokens, labels and inputs come from
``numpy.random.default_rng``.  Covered:

* the chunked loss (twin of tests/test_models.py's full-softmax check, and
  against JAX with a padded vocab and a loss mask);
* the three autograd Functions of ``repro_torch.kernels.ops`` (kernel
  forward, plain backward; on CPU tensors the forward is the kernel's plain
  version) against JAX's custom-VJP grads in interpret mode, at the
  reference's tolerances (attention 2e-4, scans 2e-3, RWKV6's w on the
  2^-6 grid), and their refusals;
* per ported architecture: a smoke train step, loss and every gradient
  leaf against ``jax.value_and_grad(model.loss)`` at 1e-4 (remat on and
  off, the plain path and the Functions), three ``make_train_step`` steps
  against JAX's at 1e-5 on every state leaf, the state's leaf names, and
  the layer groups.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.steps import train_state_shape as jtrain_state_shape
from repro.models import build_model as jbuild_model
from repro.models.common import chunked_softmax_xent as jchunked_softmax_xent
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import build_model, ssm
from repro_torch.models.common import chunked_softmax_xent, lm_head_logits
from repro_torch.models.lm import layer_groups
from repro_torch.optim import AdamWConfig, global_norm
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ARCHS = ("tinyllama-1.1b", "zamba2-1.2b", "rwkv6-7b")
B, S = 2, 128  # two RWKV6 chunks and two loss chunks (smoke loss_chunk 64)
TOL = 1e-4
STEP_TOL = 1e-5
# eps 1e-3 keeps the update continuous at the grads' scale (median ~5e-5):
# with 1e-8 the first step is lr * sign(g), and grads within fp32 noise of
# zero (embedding rows: ~5e-7 apart between the packages) flip it by 2 lr
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)


def _np(t):
    return bridge.params_to_numpy(t)


def _close(name, got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    # `pytest -s` shows these lines: the CPU parity readings of PERF.md
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split(' ')[0]} {name}: "
          f"max_abs_err={np.abs(got - want).max():.3e} tol={tol:g}")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=name)


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- chunked loss -------------------------------------------------------------------
def test_chunked_loss_matches_full_softmax():
    cfg = get_config("tinyllama_1_1b", smoke=True)
    g = torch.Generator().manual_seed(0)
    w = torch.randn((cfg.padded_vocab, cfg.d_model), generator=g) * 0.02
    h = torch.randn((2, 64, cfg.d_model), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    l1 = chunked_softmax_xent(cfg, {"tok": w}, w, h, labels)
    logits = lm_head_logits(cfg, {"tok": w}, w, h)
    lse = torch.logsumexp(logits, -1)
    lab = torch.gather(logits, -1, labels[..., None])[..., 0]
    l2 = (lse - lab).mean()
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)


def test_chunked_loss_and_grads_match_jax_padded_vocab_and_mask():
    """vocab 500 padded to 512 (the padded rows masked), four chunks, a
    0/1 loss mask; loss and its grads with respect to h and the head."""
    cfg = replace(get_config("tinyllama_1_1b", smoke=True), vocab_size=500, loss_chunk=16)
    jcfg = replace(jget_config("tinyllama_1_1b", smoke=True), vocab_size=500, loss_chunk=16)
    assert cfg.padded_vocab == 512
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(512, cfg.d_model)) * 0.05).astype(np.float32)
    h = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, 500, (2, 64)).astype(np.int32)
    mask = (rng.uniform(size=(2, 64)) < 0.7).astype(np.float32)

    def jloss(h, w):
        return jchunked_softmax_xent(jcfg, {"tok": w}, w, h, jnp.asarray(labels),
                                     jnp.asarray(mask))

    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tl = chunked_softmax_xent(cfg, {"tok": tw}, tw, th, torch.from_numpy(labels),
                              torch.from_numpy(mask))
    gh, gw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-6, rtol=1e-5)
    assert float(gw[500:].abs().max()) == 0.0  # padded rows get no gradient


def test_chunked_loss_refuses_ragged_chunks():
    cfg = replace(get_config("tinyllama_1_1b", smoke=True), loss_chunk=32)
    w = torch.zeros((cfg.padded_vocab, cfg.d_model))
    with pytest.raises(ValueError, match="divide loss_chunk"):
        chunked_softmax_xent(cfg, {"tok": w}, w, torch.zeros((1, 48, cfg.d_model)),
                             torch.zeros((1, 48), dtype=torch.long))


def test_chunked_loss_saves_one_chunk_of_logits():
    """Autograd keeps no (B, C, V) logits: each chunk runs under a checkpoint."""
    cfg = replace(get_config("tinyllama_1_1b", smoke=True), loss_chunk=16)
    w = torch.randn((cfg.padded_vocab, cfg.d_model), requires_grad=True)
    h = torch.randn((2, 64, cfg.d_model), requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = chunked_softmax_xent(cfg, {"tok": w}, w, h, torch.zeros((2, 64), dtype=torch.long))
    assert saved and (2, 16, cfg.padded_vocab) not in saved
    torch.autograd.grad(loss, (h, w))


# -- the autograd Functions against JAX's custom VJPs --------------------------------
def _grads_vs_jax(jfn, tfn, args, argnums, tol):
    jg = jax.grad(jfn, argnums=argnums)(*[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_(i in argnums) for i, a in enumerate(args)]
    tg = torch.autograd.grad(tfn(*targs), [targs[i] for i in argnums])
    for i, a, b in zip(argnums, tg, jg):
        _close(f"d{i}", a.numpy(), b, tol)


@pytest.mark.parametrize("loss", ["sum", "square"])
def test_attention_function_grads_match_jax_custom_vjp(loss):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, 2, 64, 32)).astype(np.float32) for _ in range(3))
    red = (lambda o: o.sum()) if loss == "sum" else (lambda o: (o ** 2).sum())
    _grads_vs_jax(lambda q, k, v: red(jops.attention(q, k, v, causal=True, impl="interpret")),
                  lambda q, k, v: red(ops.attention(q, k, v, causal=True, impl="cuda")),
                  (q, k, v), (0, 1, 2), 2e-4)


def test_attention_function_grads_gqa_match_jax_custom_vjp():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 4, 64, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 64, 32)).astype(np.float32) for _ in range(2))
    _grads_vs_jax(lambda q, k, v: (jops.attention(q, k, v, impl="interpret") ** 2).sum(),
                  lambda q, k, v: (ops.attention(q, k, v, impl="cuda") ** 2).sum(),
                  (q, k, v), (0, 1, 2), 2e-4)


def _mamba2_args(rng, Bsz=1, S=64, H=2, P=8, G=1, N=8):
    return (rng.normal(size=(Bsz, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (Bsz, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2, H).astype(np.float32),
            rng.normal(size=(Bsz, S, G, N)).astype(np.float32),
            rng.normal(size=(Bsz, S, G, N)).astype(np.float32))


def test_mamba2_function_grads_match_jax_custom_vjp():
    """Every input's grad; the loss reads y and the final state."""
    args = _mamba2_args(np.random.default_rng(0))

    def jf(*a):
        y, h = jops.mamba2(*a, impl="interpret", chunk=32)
        return (y ** 2).sum() + (h ** 2).sum()

    def tf(*a):
        y, h = ops.mamba2(*a, impl="cuda")
        return (y ** 2).sum() + (h ** 2).sum()

    _grads_vs_jax(jf, tf, args, (0, 1, 2, 3, 4), 2e-3)


def _rwkv6_args(rng, Bsz=1, S=64, H=2, K=16):
    w = -np.maximum(np.round(rng.uniform(0.01, 3.0, (Bsz, S, H, K)) * 64), 1) / 64
    return (rng.normal(size=(Bsz, S, H, K)).astype(np.float32),
            rng.normal(size=(Bsz, S, H, K)).astype(np.float32),
            rng.normal(size=(Bsz, S, H, K)).astype(np.float32),
            w.astype(np.float32),
            (rng.normal(size=(H, K)) * 0.5).astype(np.float32))


def test_rwkv6_function_grads_match_jax_custom_vjp():
    """Every input's grad, w on the 2^-6 grid; the loss reads y and the
    final state; two chunks of 64."""
    args = _rwkv6_args(np.random.default_rng(0), S=128)

    def jf(*a):
        y, s = jops.rwkv6(*a, impl="interpret", chunk=32)
        return (y ** 2).sum() + (s ** 2).sum()

    def tf(*a):
        y, s = ops.rwkv6(*a, impl="cuda")
        return (y ** 2).sum() + (s ** 2).sum()

    _grads_vs_jax(jf, tf, args, (0, 1, 2, 3, 4), 2e-3)


def test_scan_functions_take_an_initial_state_grad():
    """h0 / s0 given: it gets a grad; h0 / s0 None: the others still do."""
    rng = np.random.default_rng(2)
    x, dt, A, Bm, Cm = (torch.from_numpy(a).requires_grad_() for a in _mamba2_args(rng))
    h0 = torch.randn(1, 2, 8, 8, requires_grad=True)
    y, h = ops.mamba2(x, dt, A, Bm, Cm, h0, impl="cuda")
    y2, h2 = ops.mamba2(x, dt, A, Bm, Cm, h0, impl="ref")
    for a, b in zip(torch.autograd.grad(y.sum() + h.sum(), (x, h0)),
                    torch.autograd.grad(y2.sum() + h2.sum(), (x, h0))):
        torch.testing.assert_close(a, b)
    r, k, v, w, u = (torch.from_numpy(a).requires_grad_() for a in _rwkv6_args(rng))
    s0 = torch.randn(1, 2, 16, 16, requires_grad=True)
    y, s = ops.rwkv6(r, k, v, w, u, s0, impl="cuda")
    y2, s2 = ops.rwkv6(r, k, v, w, u, s0, impl="ref")
    for a, b in zip(torch.autograd.grad(y.sum() + s.sum(), (u, s0)),
                    torch.autograd.grad(y2.sum() + s2.sum(), (u, s0))):
        torch.testing.assert_close(a, b)


def test_scan_functions_refuse_ragged_s_when_called(monkeypatch):
    """The CUDA scans take any S, the chunked backward does not: with grad
    enabled the Functions refuse S % chunk != 0 in the forward pass.  The
    kernels are replaced by stand-ins that, like them, take any S."""
    monkeypatch.setattr(m2, "mamba2_scan", lambda x, dt, A, Bm, Cm, h0=None: (
        torch.zeros_like(x), torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[3])))
    monkeypatch.setattr(r6, "rwkv6_scan", lambda r, k, v, w, u, s0=None: (
        torch.zeros_like(v), torch.zeros(r.shape[0], r.shape[2], r.shape[3], v.shape[3])))
    rng = np.random.default_rng(0)
    margs = [torch.from_numpy(a).requires_grad_() for a in _mamba2_args(rng, S=200)]
    rargs = [torch.from_numpy(a).requires_grad_() for a in _rwkv6_args(rng, S=100)]
    with pytest.raises(ValueError, match="S must divide chunk"):
        ops.mamba2(*margs, impl="cuda")
    with pytest.raises(ValueError, match="S must divide chunk"):
        ops.rwkv6(*rargs, impl="cuda")
    with torch.no_grad():  # serving: any S
        ops.mamba2(*margs, impl="cuda")
        ops.rwkv6(*rargs, impl="cuda")
    ops.mamba2(*[a.detach() for a in margs], impl="cuda")
    for S_ok in (64, 256):  # shorter than the chunk, or a multiple of it
        ops.mamba2(*[torch.from_numpy(a).requires_grad_()
                     for a in _mamba2_args(rng, S=S_ok)], impl="cuda")


def test_wrappers_refuse_grad_when_called_directly():
    """Called with grad enabled on inputs that need it, the kernel wrappers'
    card-side checks refuse: only ops' Functions may call them then.  The
    decode wrapper (serving only, no VJP in the reference) always refuses."""
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    with pytest.raises(NotImplementedError):
        fa._check_cuda(q, q, q)
    rng = np.random.default_rng(0)
    margs = [torch.from_numpy(a).requires_grad_() for a in _mamba2_args(rng, P=16, N=16)]
    with pytest.raises(NotImplementedError):
        m2._check_cuda(*margs, None)
    rargs = [torch.from_numpy(a).requires_grad_() for a in _rwkv6_args(rng)]
    with pytest.raises(NotImplementedError):
        r6._check_cuda(*rargs, None)
    with torch.no_grad():  # as inside a Function's forward
        fa._check_cuda(q, q, q)
        m2._check_cuda(*margs, None)
        r6._check_cuda(*rargs, None)
        with pytest.raises(NotImplementedError):
            dec._check_cuda(q[:, :, 0], q, q, torch.ones(1, dtype=torch.int32))


# -- the model: loss, grads and train steps against JAX ------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jget_config(request.param, smoke=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return request.param, jcfg, jparams, {}


def _port_params(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_layer_groups_partition_blocks():
    for name in ARCHS:
        cfg = get_config(name, smoke=True)
        gs = layer_groups(cfg)
        assert sum(g.count for g in gs) == cfg.n_layers
        i = 0  # groups tile the pattern contiguously
        for g in gs:
            assert g.start == i
            for j in range(g.count):
                assert cfg.blocks[i + j] == g.kind
            i += g.count


def test_arch_smoke_train_step(arch):
    """One forward and backward of the port's own init: finite loss, finite
    grads with a positive norm, prefill logits of the right shape."""
    name = arch[0]
    cfg = get_config(name, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg.vocab_size, 1))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss(params, batch)
    assert torch.isfinite(loss)
    grads = torch.autograd.grad(loss, leaves)
    gn = float(global_norm(grads))
    assert np.isfinite(gn) and gn > 0
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": batch["tokens"]}, S + 4)
    assert logits.shape == (B, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(arch, remat, impl):
    """``impl="cuda"`` on CPU tensors runs the autograd Functions with the
    kernels' plain versions forward; ``"ref"`` is plain autograd."""
    name, jcfg, jparams, cache = arch
    batch = _batch(jcfg.vocab_size, 1)
    if remat not in cache:
        jmodel = jbuild_model(replace(jcfg, remat=remat))
        cache[remat] = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(jmodel.loss))(
            jparams, _jbatch(batch)))
    jloss, jgrads = cache[remat]
    cfg = replace(get_config(name, smoke=True), remat=remat, attn_impl=impl, scan_impl=impl)
    params = _port_params(jparams)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = build_model(cfg).loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves)
    _close("loss", loss.item(), float(jloss), TOL)
    names = bridge.leaf_names(params)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads) == len(names)
    _close("every grad leaf", np.concatenate([g.numpy().ravel() for g in grads]),
           np.concatenate([np.ravel(jg) for jg in jleaves]), TOL)
    for n, g, jg in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, atol=TOL, rtol=TOL, err_msg=n)


def test_train_steps_match_jax(arch):
    """Three steps on three batches from the same state: every state leaf
    at 1e-5, ``step`` equal, and the metrics."""
    name, jcfg, jparams, _ = arch
    jstate = {"params": jparams, "opt": jadamw_init(JAdamWConfig(**OPT), jparams)}
    state = _port_params(jstate)
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].dim() == 0
    jstep = jax.jit(jmake_train_step(jbuild_model(jcfg), JAdamWConfig(**OPT)))
    cfg = replace(get_config(name, smoke=True), attn_impl="cuda", scan_impl="cuda")
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
    for i in range(3):
        batch = _batch(jcfg.vocab_size, 10 + i)
        jstate, jmet = jstep(jstate, _jbatch(batch))
        state, met = step(state, _tbatch(batch))
        for k in ("loss", "grad_norm", "lr"):
            assert met[k].dim() == 0
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=k)
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == i + 1
        leaves = [(n, _np(got).astype(np.float32), np.asarray(want, np.float32)) for n, got, want
                  in zip(bridge.leaf_names(state), tree_leaves(state), jax.tree.leaves(jstate))]
        _close(f"step {i + 1} every state leaf", np.concatenate([g.ravel() for _, g, _ in leaves]),
               np.concatenate([w.ravel() for _, _, w in leaves]), STEP_TOL)
        for n, got, want in leaves:
            np.testing.assert_allclose(got, want, atol=STEP_TOL, rtol=STEP_TOL,
                                       err_msg=f"step {i + 1} {n}")
        assert not any(t.requires_grad for t in tree_leaves(state))


def test_train_state_matches_jax_layout(arch):
    """The state's leaf names are the reference's keystr order (so that a
    checkpoint restores across packages), with its dtypes and shapes; it
    survives a round trip through numpy."""
    name, jcfg, _, _ = arch
    jshape = jtrain_state_shape(jbuild_model(jcfg), JAdamWConfig())
    state = make_train_state(build_model(get_config(name, smoke=True)), AdamWConfig(),
                             torch.Generator().manual_seed(0))
    jnames = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jshape)]
    assert bridge.leaf_names(state) == jnames
    for t, j in zip(tree_leaves(state), jax.tree.leaves(jshape)):
        assert tuple(t.shape) == tuple(j.shape) and str(t.dtype)[6:] == j.dtype.name
    back = bridge.params_from_numpy(bridge.params_to_numpy(state), "cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    masters = {t.data_ptr() for t in tree_leaves(state["opt"]["master"])}
    assert not masters & {t.data_ptr() for t in tree_leaves(state["params"])}


def test_training_passes_no_previous_token_state(monkeypatch):
    """Training runs the token shifts with no previous state, so the one
    in-place write of ``ssm._shift`` (position 0 from a cache) never meets
    a tensor autograd needs."""
    seen = []
    shift = ssm._shift
    monkeypatch.setattr(ssm, "_shift", lambda x, prev: seen.append(prev) or shift(x, prev))
    cfg = get_config("rwkv6-7b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(**OPT))
    step({"params": params, "opt": make_train_state(model, AdamWConfig(**OPT),
                                                    torch.Generator().manual_seed(0))["opt"]},
         _tbatch(_batch(cfg.vocab_size, 1)))
    assert seen and all(p is None for p in seen)


def test_check_supported_refuses_dots_remat():
    """The ``dots`` policy is ported now: check_supported takes it, and the
    tinyllama smoke config under it gives the loss and every grad of the
    ``nothing`` policy bit for bit (selective checkpointing saves products
    it would otherwise recompute, in the same arithmetic)."""
    cfg = replace(get_config("tinyllama-1.1b", smoke=True), remat=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg.vocab_size, 1))
    out = {}
    # deterministic: the embedding's backward (index_put with accumulate)
    # otherwise adds in a different order from run to run on the CPU
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for policy in ("nothing", "dots"):
            tree = tree_map(lambda p: p.detach().requires_grad_(), params)
            leaves = tree_leaves(tree)
            loss = build_model(replace(cfg, remat_policy=policy)).loss(tree, batch)
            out[policy] = (loss, torch.autograd.grad(loss, leaves))
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(out["nothing"][0], out["dots"][0])
    for a, b in zip(out["nothing"][1], out["dots"][1]):
        assert torch.equal(a, b)
