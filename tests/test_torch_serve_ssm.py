"""The port's zamba2 and rwkv6 serving vs the JAX reference, with the same weights.

A JAX-initialised smoke tree of each architecture crosses into the port
through ``repro_torch.bridge``; both packages then prefill, decode and
greedily generate on the same tokens.  The JAX side runs its default
``ref`` path and, through ``attn_impl = scan_impl = "interpret"``, its
Pallas kernels in interpret mode.  Tolerance: fp32 on the CPU, atol = rtol
= 1e-4, as in tests/test_torch_serve.py.  The prompt (32) is shorter than
both scans' chunks, so each chunked scan runs as one chunk of 32, as the
reference's ``ops`` does.
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
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_generate_loop, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.common import apply_norm, embed_tokens
from repro_torch.models.lm import _index
from repro_torch.models.ssm import _mamba2_split

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

TOL = 1e-4
B, S, GEN = 2, 32, 6
MAX_LEN = S + GEN + 1
ARCHS = ("zamba2-1.2b", "rwkv6-7b")
ZERO_LAUNCHES = {"flash_attention_fwd": 0, "flash_decode": 0, "mamba2_scan": 0,
                 "rwkv6_scan": 0}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jget_config(request.param, smoke=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    cfg = get_config(request.param, smoke=True)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params, tokens


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    # `pytest -s` shows these lines: the CPU parity table of PERF.md
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split(' ')[0]}: "
          f"max_abs_err={np.abs(got - want).max():.3e} tol={tol:g}")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _jax_prefill_decode(jcfg, jparams, tokens, impl):
    """JAX prefill logits and cache, then GEN decode steps fed JAX's greedy
    tokens; returns the logits of every step, the final cache and those
    tokens."""
    model = jbuild_model(replace(jcfg, attn_impl=impl, scan_impl=impl))
    logits, cache = jax.jit(model.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, MAX_LEN)
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


def _close_cache(cache, jcache):
    """Every leaf, by its keystr name, shape and value."""
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert bridge.leaf_names(cache) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (_, want), got in zip(jleaves, jax.tree.leaves(cache)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        close(got, want)


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_prefill_cache_and_decode_match_jax(setup, impl):
    """Prefill logits, the primed cache (SSM and conv states, tm_x, wkv,
    cm_x, shared-attention K/V), every decode step's logits and the final
    cache.  The port's Mamba2 prefill takes output and state from one scan
    where the reference runs it twice; the cache pins that they agree."""
    jcfg, jparams, cfg, params, tokens = setup
    want, jprimed, jfinal, fed = _jax_prefill_decode(jcfg, jparams, tokens, impl)
    model = build_model(cfg)
    logits, cache = make_prefill_step(model, MAX_LEN)(
        params, {"tokens": torch.from_numpy(tokens).long()})
    close(logits, want[0])
    _close_cache(cache, jprimed)
    step = make_decode_step(model)
    for t in range(GEN):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = step(params, cache, torch.tensor(fed[t]).long(), pos)
        close(logits, want[t + 1])
    _close_cache(cache, jfinal)
    assert ops.launch_counts() == ZERO_LAUNCHES


def test_generate_tokens_identical_to_jax(setup):
    jcfg, jparams, cfg, params, tokens = setup
    jgen = jax.jit(jmake_generate_loop(jbuild_model(jcfg), GEN), static_argnums=2)
    want = np.asarray(jgen(jparams, {"tokens": jnp.asarray(tokens)}, MAX_LEN))
    got = make_generate_loop(build_model(cfg), GEN)(
        params, {"tokens": torch.from_numpy(tokens).long()}, MAX_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_logits_match_jax(setup):
    jcfg, jparams, cfg, params, tokens = setup
    want = jbuild_model(jcfg).logits(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got = build_model(cfg).logits(params, {"tokens": torch.from_numpy(tokens).long()})
    close(got, want)


def test_port_init_has_the_reference_tree(setup):
    """Same leaf names, shapes and dtypes as the JAX tree: stacked runs, the
    ``{}`` placeholders of shared_attn groups, the unstacked shared block,
    ln0 for RWKV, and the float32 leaves inside bf16 models."""
    jcfg = replace(setup[0], param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = replace(setup[2], param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert bridge.leaf_names(params) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for (path, a), b in zip(jleaves, jax.tree.leaves(params)):
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        assert b.dtype == want_dtype[a.dtype.name], jax.tree_util.keystr(path)
    assert [len(g) for g in params["layers"]] == [len(g) for g in jparams["layers"]]
    # the bridge carries the JAX tree across unchanged, bf16 bit-exact
    np_tree = jax.tree.map(np.asarray, jparams)
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_tree, "cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("prompt", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompt_primes_state_and_decode_equals_scan(arch, prompt):
    """A prompt shorter than Mamba2's d_conv - 1 = 3 rows of conv history:
    the primed conv state is the zero-padded history, and decoding on from
    it gives the logits that one full-sequence pass over the same tokens
    gives.  (The reference's decode refuses such a state.)"""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    n = prompt + 4
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, n))).long()
    logits, cache = make_prefill_step(model, n + 1)(params, {"tokens": tokens[:, :prompt]})
    with torch.inference_mode():
        want = model.logits(params, {"tokens": tokens})
    close(logits, want[:, prompt - 1])
    if cfg.mamba is not None:
        lp = _index(params["layers"][0], 0)  # layer 0: mamba2
        h = apply_norm(cfg, lp["ln1"], embed_tokens(cfg, params["embed"], tokens[:, :prompt]))
        xbc = _mamba2_split(cfg, h @ lp["mixer"]["in_proj"])[1]
        hist = torch.cat([xbc.new_zeros((B, cfg.mamba.d_conv - 1 - prompt, xbc.shape[-1])),
                          xbc], 1)
        close(cache[0]["conv"][0], hist)
        for c in cache:  # every Mamba2 layer: zeros in front of the prompt's rows
            if "conv" in c:
                assert not c["conv"][:, :, :cfg.mamba.d_conv - 1 - prompt].any()
    step = make_decode_step(model)
    for t in range(prompt, n):
        logits, cache = step(params, cache, tokens[:, t], torch.full((B,), t, dtype=torch.int32))
        close(logits, want[:, t])
    assert ops.launch_counts() == ZERO_LAUNCHES


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("[serve] generated (2, 3) tokens")
    assert out[2] == f"[serve] kernel launches (warm run): {ZERO_LAUNCHES}"
    assert out[3].startswith("[serve] prefill ") and "ms/step" in out[3]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_without_gpu_raises(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke"])
