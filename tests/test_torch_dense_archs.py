"""The port's dense architectures vs the JAX reference, with the same weights.

gemma-2b (MQA, head_dim 32 in the smoke config, GeGLU, unit-offset
RMSNorm, scaled and tied embeddings), gemma-7b (MHA), command-r-35b
(parallel blocks, LayerNorm, tied head) and qwen2-vl-7b (M-RoPE, qkv
biases, visual embeddings spliced over the first 8 token slots).  A
JAX-initialised smoke tree of each crosses into the port through
``repro_torch.bridge``; both packages then prefill, decode, generate and
differentiate the loss on the same tokens (and visual embeddings) from
numpy.  The JAX side runs its ``ref`` path and, with ``attn_impl =
"interpret"``, its Pallas kernels in interpret mode.  Tolerance: fp32 on
the CPU, atol = rtol = 1e-4, as in tests/test_torch_serve.py; the twins
of tests/test_models.py keep that file's 2e-3 (decode against forward)
and 1e-5 (M-RoPE against RoPE).  The bf16 cases are bit-exact.
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
from repro.launch.steps import make_generate_loop as jmake_generate_loop
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_decode_step, make_generate_loop, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.optim import global_norm
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

TOL = 1e-4
B, S, GEN = 2, 32, 6
MAX_LEN = S + GEN + 1
N_IMG = 8  # visual embeddings a prompt, as the reference's serve.py and tests
ARCHS = ("gemma-2b", "gemma-7b", "command-r-35b", "qwen2-vl-7b")
ZERO_LAUNCHES = {"flash_attention_fwd": 0, "flash_decode": 0, "mamba2_scan": 0,
                 "rwkv6_scan": 0}


def close(got, want, tol=TOL, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    # `pytest -s` shows these lines: the CPU parity readings of PERF.md
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split(' ')[0]} {name}: "
          f"max_abs_err={np.abs(got - want).max():.3e} tol={tol:g}")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=name)


def _batch(cfg, seed=0, labels=False):
    """numpy tokens (and labels, and visual embeddings for a visual_stub config)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.visual_stub:
        batch["visual_embeds"] = rng.normal(size=(B, N_IMG, cfg.d_model)).astype(np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jget_config(request.param, smoke=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(request.param, smoke=True)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return request.param, jcfg, jparams, cfg, params, {}


def _close_cache(cache, jcache, name):
    """Every leaf, by its keystr name, shape and value."""
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert bridge.leaf_names(cache) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (path, want), got in zip(jleaves, tree_leaves(cache)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        close(got, want, name=f"{name} {jax.tree_util.keystr(path)}")


def test_port_init_has_the_reference_tree(setup):
    """Same leaf names, shapes and dtypes as the JAX tree in bf16: no
    ``lm_head`` when tied, no ``ln2`` in a parallel block, the norms'
    ``bias`` for LayerNorm, ``bq``/``bk``/``bv`` for qkv biases; the
    bridge carries the JAX tree across bit for bit."""
    arch, jcfg, _, cfg, _, _ = setup
    jcfg = replace(jcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    names = bridge.leaf_names(params)
    assert names == [jax.tree_util.keystr(p) for p, _ in jleaves]
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for (path, a), b in zip(jleaves, tree_leaves(params)):
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        assert b.dtype == want_dtype[a.dtype.name], jax.tree_util.keystr(path)
    assert ("['lm_head']" in names) == (not cfg.tie_embeddings)
    assert any("['ln2']" in n for n in names) == (not cfg.parallel_block)
    assert any("['bias']" in n for n in names) == (cfg.norm == "layernorm")
    assert any("['bq']" in n for n in names) == cfg.qkv_bias
    if cfg.norm_unit_offset:  # stored as an offset from 1
        assert not params["final_norm"]["scale"].any()
    np_tree = jax.tree.map(np.asarray, jparams)
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_tree, "cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


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
def test_prefill_cache_and_decode_match_jax(setup, impl):
    """Prefill logits, every leaf of the primed cache, every decode step's
    logits and the final cache."""
    _, jcfg, jparams, cfg, params, _ = setup
    batch = _batch(cfg)
    want, jprimed, jfinal, fed = _jax_prefill_decode(jcfg, jparams, batch, impl)
    model = build_model(cfg)
    logits, cache = make_prefill_step(model, MAX_LEN)(params, _tbatch(batch))
    close(logits, want[0], name="prefill logits")
    _close_cache(cache, jprimed, "primed cache")
    step = make_decode_step(model)
    for t in range(GEN):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = step(params, cache, torch.tensor(fed[t]).long(), pos)
        close(logits, want[t + 1], name=f"decode step {t}")
    _close_cache(cache, jfinal, "final cache")
    assert ops.launch_counts() == ZERO_LAUNCHES


def test_generate_tokens_identical_to_jax(setup):
    _, jcfg, jparams, cfg, params, _ = setup
    batch = _batch(cfg)
    jgen = jax.jit(jmake_generate_loop(jbuild_model(jcfg), GEN), static_argnums=2)
    want = np.asarray(jgen(jparams, _jbatch(batch), MAX_LEN))
    got = make_generate_loop(build_model(cfg), GEN)(params, _tbatch(batch), MAX_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_logits_match_jax(setup):
    _, jcfg, jparams, cfg, params, _ = setup
    batch = _batch(cfg)
    want = jbuild_model(jcfg).logits(jparams, _jbatch(batch))
    with torch.inference_mode():
        got = build_model(cfg).logits(params, _tbatch(batch))
    close(got, want, name="logits")


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_loss_and_grads_match_jax(setup, impl):
    """Loss and every grad leaf at 1e-4; the tied embedding's gradient sums
    its two uses (the lookup and the head).  ``impl="cuda"`` on CPU
    tensors runs ops' autograd Functions with the kernels' plain versions."""
    _, jcfg, jparams, cfg, _, cache = setup
    batch = _batch(cfg, seed=1, labels=True)
    if "grads" not in cache:
        cache["grads"] = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
            jbuild_model(jcfg).loss))(jparams, _jbatch(batch)))
    jloss, jgrads = cache["grads"]
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = build_model(replace(cfg, attn_impl=impl)).loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves)
    close(loss.item(), float(jloss), name="loss")
    names = bridge.leaf_names(params)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads) == len(names)
    close(np.concatenate([g.numpy().ravel() for g in grads]),
          np.concatenate([np.ravel(jg) for jg in jleaves]), name="every grad leaf")
    for n, g, jg in zip(names, grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, atol=TOL, rtol=TOL, err_msg=n)


def test_arch_smoke_train_step(setup):
    """Twin of tests/test_models.py's: one forward and backward of the
    port's own init, finite loss and grads with a positive norm, prefill
    logits of the right shape."""
    cfg = setup[3]
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


def test_arch_decode_matches_forward(setup):
    """Twin of tests/test_models.py's: prefill S - 4 tokens (with the visual
    embeddings), decode the last 4, each step's logits against one full
    forward over all S tokens, at that test's 2e-3."""
    cfg = setup[3]
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


def test_mrope_equals_rope_for_text_positions():
    """Twin of tests/test_models.py's: with the three position streams
    equal, M-RoPE is RoPE; and the port's M-RoPE equals JAX's on distinct
    streams."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16))
    pos3 = np.broadcast_to(pos[None], (3, 2, 16))
    a = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10000.0)
    b = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3.copy()), 10000.0, (4, 6, 6))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    pos3 = rng.integers(0, 64, (3, 2, 16)).astype(np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 10000.0, (4, 6, 6))
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 10000.0, (4, 6, 6))
    close(got, want, name="mrope, distinct streams")
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 10000.0, (4, 6, 7))


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma-7b", "command-r-35b"])
def test_bf16_embeddings_and_norms_match_jax(arch):
    """In bf16, ``embed_tokens`` (Gemma: scaled by sqrt(d_model) rounded to
    bf16 first, 55.5 for gemma-7b's 3072) equals JAX's bit for bit.
    ``apply_norm`` (Gemma's unit-offset RMSNorm, 1 added in fp32;
    Command-R's LayerNorm with bias) equals JAX's in all but at most 1 in
    1,000 elements, and those lie one bf16 step apart.  The cause is shown,
    not assumed: the same norm on the bf16 values seen as fp32 gives each
    package's value before its cast (casting it reproduces that package's
    bf16 output); the two packages' fp32 values agree within 4 fp32
    roundings of the terms they are computed from (|x| r |scale|, plus
    |mu| r |scale| and |bias| for LayerNorm), and every element whose bf16
    differs has its two fp32 values on either side of the bf16 rounding
    boundary between the two results.  Adding the 1 in bf16, or dropping
    it, moves most elements."""
    jcfg = replace(jget_config(arch), vocab_size=512)
    cfg = replace(get_config(arch), vocab_size=512)
    rng = np.random.default_rng(2)
    D = cfg.d_model
    tok = (rng.normal(size=(cfg.padded_vocab, D)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    jemb = {"tok": jnp.asarray(tok, jnp.bfloat16)}
    emb = {"tok": torch.from_numpy(tok).to(torch.bfloat16)}
    want = np.asarray(jcommon.embed_tokens(jcfg, jemb, jnp.asarray(tokens)).astype(jnp.float32))
    got = common.embed_tokens(cfg, emb, torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    if arch == "gemma-7b":  # the scalar the reference multiplies by
        assert float(jnp.asarray(np.sqrt(D), jnp.bfloat16)) == 55.5
    x = (rng.normal(size=(2, 16, D)) * 3).astype(np.float32)
    p = {k: (rng.normal(size=(D,)) * 0.1).astype(np.float32)
         for k in jcommon.norm_init(jcfg, D)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jcommon.apply_norm(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    got = common.apply_norm(cfg, tp, xb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    # each package's fp32 value before its cast, from the same bf16 values
    x32 = xb.float().numpy()
    want32 = np.asarray(jcommon.apply_norm(
        jcfg, {k: v.astype(jnp.float32) for k, v in jp.items()}, jnp.asarray(x32)))
    got32 = common.apply_norm(cfg, {k: v.float() for k, v in tp.items()},
                              torch.from_numpy(x32)).numpy()

    def bf16(a):
        return torch.from_numpy(np.array(a)).to(torch.bfloat16).float().numpy()

    np.testing.assert_array_equal(bf16(want32), want)
    np.testing.assert_array_equal(bf16(got32), got)
    xf = x32.astype(np.float64)
    scale = np.abs(tp["scale"].double().numpy() + (1.0 if cfg.norm_unit_offset else 0.0))
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdims=True)
        r = 1 / np.sqrt(((xf - mu) ** 2).mean(-1, keepdims=True) + cfg.norm_eps)
        terms = (np.abs(xf) + np.abs(mu)) * r * scale + np.abs(tp["bias"].double().numpy())
    else:
        r = 1 / np.sqrt((xf ** 2).mean(-1, keepdims=True) + cfg.norm_eps)
        terms = np.abs(xf) * r * scale
    roundings = np.abs(got32.astype(np.float64) - want32) / (2.0 ** -23 * terms)
    differ = got != want
    step = 2.0 ** (np.floor(np.log2(np.abs(want[differ]))) - 7)  # one bf16 step
    print(f"[parity] {arch} bf16 norm: {differ.sum()} of {want.size} elements one bf16 step "
          f"from JAX's; fp32 before the cast within {roundings.max():.2f} roundings of the terms")
    assert roundings.max() <= 4
    assert differ.mean() <= 1e-3
    np.testing.assert_array_equal(np.abs(got[differ] - want[differ]), step)
    boundary = (got[differ] + want[differ]) / 2  # the bf16 rounding boundary between them
    lo = np.minimum(got32[differ], want32[differ])
    hi = np.maximum(got32[differ], want32[differ])
    assert ((lo <= boundary) & (boundary <= hi)).all()


def test_serve_cli_runs_visual_stub_on_cpu():
    """``launch/serve.py`` hands a visual_stub config its seeded visual
    embeddings and serves it through the normal entry point."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-vl-7b", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("[serve] generated (2, 3) tokens")
    assert out[1].startswith("[serve] visual embeddings (2, 8, 128)")
    assert out[3] == f"[serve] kernel launches (warm run): {ZERO_LAUNCHES}"
