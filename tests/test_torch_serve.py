"""The port's serving slice vs the JAX reference, with the same weights.

A JAX-initialised tinyllama smoke tree crosses into the port through
``repro_torch.bridge``; both packages then prefill, decode and greedily
generate on the same tokens.  The JAX side runs its default ``ref``
attention and, through ``attn_impl="interpret"``, its Pallas kernels in
interpret mode.  Tolerance: fp32 on the CPU, atol = rtol = 1e-4 (the two
frameworks sum in different orders; 1e-4 is the reference's own
decode-vs-forward check tightened twentyfold).
"""

import os
import subprocess
import sys
from dataclasses import fields, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_generate_loop as jmake_generate_loop
from repro.models import build_model as jbuild_model
from repro.models.common import lm_head_logits as j_lm_head_logits
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, PORTED, UNPORTED, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_generate_loop, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.common import lm_head_logits
from repro_torch.models.config import EncDecConfig, MLAConfig, MoEConfig

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

TOL = 1e-4
B, S, GEN = 2, 32, 6
MAX_LEN = S + GEN + 1


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("tinyllama-1.1b", smoke=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    cfg = get_config("tinyllama-1.1b", smoke=True)
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
    tokens; returns the logits of every step and those tokens."""
    model = jbuild_model(replace(jcfg, attn_impl=impl))
    logits, cache = jax.jit(model.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, MAX_LEN)
    out = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    step = jax.jit(model.decode_step)
    fed = []
    for t in range(GEN):
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], -1)
        fed.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok, jnp.full((B,), S + t, jnp.int32))
        out.append((np.asarray(logits), None))
    return out, fed


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(setup, impl):
    jcfg, jparams, cfg, params, tokens = setup
    want, fed = _jax_prefill_decode(jcfg, jparams, tokens, impl)
    model = build_model(cfg)
    logits, cache = make_prefill_step(model, MAX_LEN)(
        params, {"tokens": torch.from_numpy(tokens).long()})
    close(logits, want[0][0])
    jcache = want[0][1]
    assert len(cache) == len(jcache) == 1
    for name in ("k", "v"):
        assert tuple(cache[0][name].shape) == jcache[0][name].shape
        close(cache[0][name], jcache[0][name])
    step = make_decode_step(model)
    for t in range(GEN):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = step(params, cache, torch.tensor(fed[t]).long(), pos)
        close(logits, want[t + 1][0])
    assert ops.launch_counts() == {"flash_attention_fwd": 0, "flash_decode": 0,
                                   "mamba2_scan": 0, "rwkv6_scan": 0}


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


def test_lm_head_masks_padded_vocab_like_jax():
    jcfg = replace(jget_config("tinyllama-1.1b", smoke=True), vocab_size=500)
    cfg = replace(get_config("tinyllama-1.1b", smoke=True), vocab_size=500)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(cfg.padded_vocab, cfg.d_model)).astype(np.float32)
    want = j_lm_head_logits(jcfg, {}, jnp.asarray(w), jnp.asarray(h))
    got = lm_head_logits(cfg, {}, torch.from_numpy(w), torch.from_numpy(h))
    close(got, want)
    assert (got[..., 500:] == -1e30).all()


# -- bridge ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_identical(dtype):
    jcfg = replace(jget_config("tinyllama-1.1b", smoke=True),
                   param_dtype=dtype, compute_dtype=dtype)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    params = bridge.params_from_numpy(np_tree, "cpu")
    want_names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    assert bridge.leaf_names(params) == want_names
    assert bridge.leaf_names(np_tree) == want_names
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert all(t.dtype == want_dtype for t in jax.tree.leaves(params))
    back = bridge.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_init_has_the_reference_tree():
    """Same leaf names, shapes and dtypes as the JAX tree (stacked layers)."""
    jparams = jbuild_model(jget_config("tinyllama-1.1b", smoke=True)).init(jax.random.PRNGKey(0))
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert bridge.leaf_names(params) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    pleaves = jax.tree.leaves(params)
    for (_, a), b in zip(jleaves, pleaves):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
    assert tuple(params["layers"][0]["attn"]["wq"].shape) == (2, 128, 8, 16)


# -- entry point and refusals ------------------------------------------------------
def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("[serve] generated (2, 3) tokens")
    assert out[2] == "[serve] kernel launches (warm run): " \
                     "{'flash_attention_fwd': 0, 'flash_decode': 0, 'mamba2_scan': 0, " \
                     "'rwkv6_scan': 0}"
    assert out[3].startswith("[serve] prefill ") and "ms/step" in out[3]


def test_serve_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


# Config branches on the tinyllama smoke config: the first sixteen are
# ported and held against JAX (leaf names, full logits, prefill and two
# decode steps; the MoE branch on its capacity path, with the train capacity
# in the full logits and the serve capacity in prefill and decode, as the
# reference; an attn layer followed by an MLA layer, whose head_dim
# qk_nope + qk_rope = 32 differs from the attn layer's 16; an MLA config
# beside attn blocks only, which no layer reads; the encoder-decoder, over
# 1500 frame embeddings, with prefill and decode steps and no full logits,
# which it lacks; the plain GELU MLP); the rest are settings no package
# knows, which the port must refuse by name.
BRANCHES = [
    dict(norm="layernorm"), dict(norm_unit_offset=True), dict(scale_embed=True),
    dict(logit_softcap=30.0), dict(qkv_bias=True), dict(tie_embeddings=True),
    dict(parallel_block=True), dict(rope_type="mrope", mrope_sections=(2, 3, 3)),
    dict(visual_stub=True), dict(mlp_act="gelu"),
    dict(moe=MoEConfig(num_experts=4, top_k=2, d_expert=64)), dict(remat_policy="dots"),
    dict(block_pattern=("attn", "mla"),
         mla=MLAConfig(q_lora=64, kv_lora=32, qk_nope=16, qk_rope=16, v_head=16)),
    dict(mla=MLAConfig()),
    dict(enc_dec=EncDecConfig()), dict(mlp_act="gelu_mlp"),
    dict(rope_type="yarn"),
]
N_PORTED_BRANCHES = 16


@pytest.mark.parametrize("change", BRANCHES)
def test_config_branch_matches_jax_or_raises(change):
    cfg = replace(get_config("tinyllama-1.1b", smoke=True), **change)
    if BRANCHES.index(change) >= N_PORTED_BRANCHES:
        with pytest.raises(NotImplementedError, match="not supported"):
            build_model(cfg)
        return
    jcfg = replace(jget_config("tinyllama-1.1b", smoke=True), **change)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert bridge.leaf_names(build_model(cfg).init(torch.Generator().manual_seed(0))) == \
        [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.visual_stub:
        batch["visual_embeds"] = rng.normal(size=(B, 8, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec is not None:
        batch["frames"] = rng.normal(size=(B, cfg.enc_dec.n_audio_ctx, cfg.d_model)) \
            .astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
          for k, v in batch.items()}
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    assert model.is_enc_dec == jmodel.is_enc_dec
    if model.is_enc_dec:
        assert model.logits is None
    else:
        with torch.inference_mode():
            close(model.logits(params, tb), jmodel.logits(jparams, jb))
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnums=2)(jparams, jb, MAX_LEN)
    logits, cache = make_prefill_step(model, MAX_LEN)(params, tb)
    close(logits, jlogits)
    jstep, step = jax.jit(jmodel.decode_step), make_decode_step(model)
    for t in range(2):
        tok = np.array(jnp.argmax(jlogits[:, :cfg.vocab_size], -1))
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.full((B,), S + t, jnp.int32))
        logits, cache = step(params, cache, torch.from_numpy(tok).long(),
                             torch.full((B,), S + t, dtype=torch.int32))
        close(logits, jlogits)


def test_unported_archs_raise():
    """Every arch id is ported (``UNPORTED`` is empty); whisper-tiny's full
    config is the reference's field for field; each full config builds."""
    assert PORTED == ("tinyllama_1_1b", "zamba2_1_2b", "rwkv6_7b", "gemma_2b", "gemma_7b",
                      "command_r_35b", "qwen2_vl_7b", "granite_moe_3b_a800m",
                      "deepseek_v2_236b", "whisper_tiny")
    assert sorted(PORTED) == sorted(ARCH_IDS) and UNPORTED == {}
    for smoke in (False, True):
        cfg, jcfg = get_config("whisper-tiny", smoke), jget_config("whisper-tiny", smoke)
        for f in fields(jcfg):
            want = getattr(jcfg, f.name)
            if f.name in ("attn_impl", "scan_impl"):  # the port's impl selector is "auto"
                assert getattr(cfg, f.name) == "auto" and want == "ref"
            elif f.name == "enc_dec":
                assert (cfg.enc_dec.n_enc_layers, cfg.enc_dec.n_audio_ctx) == \
                    (want.n_enc_layers, want.n_audio_ctx)
            else:
                assert getattr(cfg, f.name) == want, f.name
    cfg = get_config("whisper-tiny")
    assert (cfg.d_model, cfg.n_layers, cfg.enc_dec.n_enc_layers, cfg.n_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size, cfg.enc_dec.n_audio_ctx) == \
        (384, 4, 4, 6, 64, 1536, 51865, 1500)
    assert build_model(cfg).is_enc_dec
    cfg = get_config("deepseek-v2-236b")
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads) == (5120, 60, 128, 128)
    m = cfg.mla
    assert (m.q_lora, m.kv_lora, m.qk_nope, m.qk_rope, m.v_head) == (1536, 512, 128, 64, 128)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert, cfg.moe.num_shared,
            cfg.moe.first_dense_layers, cfg.moe.dense_d_ff) == (160, 6, 1536, 2, 1, 12288)
    build_model(cfg)  # check_supported passes MLA
    with pytest.raises(ValueError, match="cfg.mla"):
        build_model(replace(cfg, mla=None))
    cfg = get_config("granite-moe-3b-a800m")
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (1536, 32, 24, 8, 64)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert) == (40, 8, 512)
    assert (cfg.moe.capacity_factor, cfg.moe.group_tokens, cfg.remat_policy) == (1.05, 256, "dots")
    build_model(cfg)  # check_supported passes MoE and the dots policy
    assert get_config("tinyllama-1.1b").d_model == 2048
    assert get_config("zamba2-1.2b").d_model == 2048
    assert get_config("rwkv6-7b").d_model == 4096
    for arch, d, hd in (("gemma-2b", 2048, 256), ("gemma-7b", 3072, 256),
                        ("command-r-35b", 8192, 128), ("qwen2-vl-7b", 3584, 128)):
        cfg = get_config(arch)
        assert (cfg.d_model, cfg.hd) == (d, hd)
        build_model(cfg)  # check_supported passes the full config
