"""The port's DeepSeek-V2 as published (YaRN rope, group-limited routing with
scaled gates, dropless experts) against the plain reference that decides
the benchmark's ``correct``, ``chipbench/reference/deepseek_v2.py``, on the
CPU at a tiny size with seeded weights.

* YaRN's inverse frequencies against the closed form at the published
  values: the correction range (10, 23) and the softmax scale's
  m(40, 0.707)^2 = 1.58963;
* routing at the published 160 experts in 8 groups, top 3 groups, top-6:
  no expert outside a token's 3 best groups, each chosen expert among the
  6 best of the allowed, and the gates 16 x p; with the default fields the
  gates and experts of the plain top-k bit for bit (granite's);
* a tiny model's full logits, and prefill then decode steps through the
  latent cache (logits and every cache leaf) and the greedy generate loop,
  against the reference's full forward pass; with plain RoPE, renormalised
  gates or an ungrouped top-k in the program the same comparisons fail;
* the benchmark's configuration builds the preset's model at 8 layers.

Tolerances: both sides in float32 on the CPU (TF32 does not exist here),
the same weights and tokens; they differ in the order of their sums only
(the flash path's blockwise softmax, the sorted grouped products), so
logits and caches are held to atol = rtol = 1e-4, the port's fp32 parity
tolerance (tests/test_torch_moe.py); YaRN's frequencies to float32's
rounding of the float64 closed form (rtol 1e-6).
"""

import json
import math
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from chipbench.frozen import Sizes
from chipbench.reference import deepseek_v2 as ref
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_generate_loop, make_prefill_step
from repro_torch.models import attention, build_model, mlp
from repro_torch.models.common import (apply_rope, yarn_correction_range, yarn_freqs,
                                       yarn_mscale)
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

# the test workers share the machine's cores (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4
B, S, GEN = 2, 40, 4
MAX_LEN = S + GEN

#: DeepSeek-V2's layout at tiny widths: a dense first layer, then MLA and
#: routed (16 experts in 4 groups, top 2 groups, top-3, gates x 16) plus
#: shared experts, YaRN as published; qk_rope 16 puts the YaRN ramp
#: (indices 2..6 of 8) inside the tiny rope dims
MODEL = {
    "name": "deepseek-v2-tiny", "vocab_size": 300, "d_model": 64, "n_layers": 3,
    "n_heads": 4, "n_kv_heads": 4, "d_ff": 96, "head_dim": 0,
    "block_pattern": ["mla"] * 3, "mlp_act": "silu", "rope_theta": 10000.0,
    "norm_eps": 1e-06, "rope_type": "yarn", "yarn_factor": ref.YARN_FACTOR,
    "yarn_original_max_len": ref.YARN_ORIGINAL_MAX_LEN, "yarn_beta_fast": ref.YARN_BETA_FAST,
    "yarn_beta_slow": ref.YARN_BETA_SLOW, "yarn_mscale": ref.YARN_MSCALE,
    "yarn_mscale_all_dim": ref.YARN_MSCALE_ALL_DIM, "vocab_round": 256, "loss_chunk": 16,
    "remat": False, "param_dtype": "float32", "compute_dtype": "float32",
    "mla": {"q_lora": 32, "kv_lora": 16, "qk_nope": 16, "qk_rope": 16, "v_head": 16},
    "moe": {"num_experts": 16, "top_k": 3, "d_expert": 32, "num_shared": 2,
            "first_dense_layers": 1, "dense_d_ff": 96, "capacity_factor": 1.0,
            "dropless": True, "n_group": 4, "topk_group": 2, "routed_scaling": 16.0,
            "norm_topk": False},
}


def model_config(m: dict) -> ModelConfig:
    """A configuration's ``model`` block as the benchmark's harness builds it."""
    m = dict(m, block_pattern=tuple(m["block_pattern"]), moe=MoEConfig(**m["moe"]),
             mla=MLAConfig(**m["mla"]))
    return ModelConfig(**m)


def close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL, err_msg=name)


def far(got, want) -> bool:
    """Beyond the tolerance by a wide margin: 100 x it somewhere."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool((np.abs(got - want) > 100 * TOL * (1 + np.abs(want))).any())


# -- YaRN ---------------------------------------------------------------------------
def test_yarn_frequencies_and_scale_are_the_closed_form_at_the_published_values():
    cfg = get_config("deepseek-v2-236b")
    dim, theta, s = cfg.mla.qk_rope, cfg.rope_theta, cfg.yarn_factor
    assert (dim, theta, s) == (64, 10000.0, 40.0)
    assert yarn_correction_range(cfg, dim) == ref.yarn_range(dim, theta) == (10, 23)
    low, high = 10, 23
    want = []
    for i in range(dim // 2):
        f = theta ** (-2 * i / dim)
        r = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(f * (1 - r) + f / s * r)
    np.testing.assert_allclose(yarn_freqs(cfg, dim).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(ref.yarn_inv_freq(dim, theta).numpy(), want, rtol=1e-6)
    m2 = yarn_mscale(40.0, 0.707) ** 2
    assert m2 == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2, rel=1e-12)
    assert round(m2, 5) == 1.58963
    assert attention.mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m2, rel=1e-12)
    assert ref.softmax_scale(Sizes.of(
        json.loads((ROOT / "chipbench/configs/deepseek-v2-236b-l8.json").read_text())["model"])
    ) == pytest.approx(attention.mla_softmax_scale(cfg), rel=1e-12)
    # the published mscale and mscale_all_dim are equal: cos and sin unscaled
    x = torch.randn(1, 5000, 1, dim, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5000)[None]
    yarn = ref.rope(x, pos, theta)
    assert far(yarn, apply_rope(x, pos, theta))  # past 4096 positions YaRN differs


# -- routing ------------------------------------------------------------------------
def _router(E: int, D: int = 32, N: int = 512, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn(D, E, generator=g) * D ** -0.5}, torch.randn(N, D, generator=g)


def test_group_limited_routing_at_the_published_sizes():
    cfg = get_config("deepseek-v2-236b")
    m = cfg.moe
    p, x = _router(m.num_experts)
    gate_w, gate_i, _ = mlp._route(cfg, p, x)
    probs = torch.softmax(x @ p["router"], dim=-1)
    groups = probs.view(-1, m.n_group, m.num_experts // m.n_group)
    best = torch.topk(groups.amax(-1), m.topk_group, dim=-1).indices
    chosen_group = gate_i // (m.num_experts // m.n_group)
    assert (chosen_group[..., None] == best[:, None, :]).any(-1).all()
    # the 6 best of the allowed experts, and the gates 16 x p, not renormalised
    allowed = torch.zeros_like(probs, dtype=torch.bool)
    for n in range(probs.shape[0]):
        for g in best[n].tolist():
            allowed[n, g * 20:(g + 1) * 20] = True
    want = torch.topk(probs.masked_fill(~allowed, -1), m.top_k, dim=-1)
    assert torch.equal(gate_i, want.indices)
    torch.testing.assert_close(gate_w, 16.0 * probs.gather(-1, gate_i), rtol=1e-6, atol=0)
    assert (gate_w.sum(-1) < 16.0).all()
    # the reference routes the same
    rw, ri = ref.route(Sizes.of(json.loads(
        (ROOT / "chipbench/configs/deepseek-v2-236b-l8.json").read_text())["model"]).moe, probs)
    assert torch.equal(ri, gate_i)
    torch.testing.assert_close(rw, gate_w, rtol=1e-6, atol=0)
    # an ungrouped top-6 picks experts outside the best groups for many tokens
    plain = torch.topk(probs, m.top_k, dim=-1).indices
    assert not torch.equal(plain, gate_i)


def test_default_fields_route_as_the_plain_top_k_bit_for_bit():
    """granite's router: the plain top-k, gates renormalised, as before the
    group-limited fields existed."""
    cfg = get_config("granite-moe-3b-a800m")
    assert (cfg.moe.n_group, cfg.moe.topk_group, cfg.moe.routed_scaling, cfg.moe.norm_topk) \
        == (1, 1, 1.0, True)
    p, x = _router(cfg.moe.num_experts, D=48, N=64)
    x = x.view(4, 16, 48).bfloat16()
    gate_w, gate_i, aux = mlp._route(cfg, p, x)
    probs = torch.softmax(x.float() @ p["router"].to(x.dtype).float(), dim=-1)
    w, i = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    assert torch.equal(gate_i, i) and torch.equal(gate_w, w)
    ce = torch.nn.functional.one_hot(i, cfg.moe.num_experts).sum(-2).float().mean(-2)
    assert torch.equal(aux, (probs.mean(-2) * ce).sum(-1) * cfg.moe.num_experts
                       * cfg.moe.aux_loss_weight)


def test_routing_settings_that_cannot_give_top_k_are_refused():
    cfg = model_config(MODEL)
    with pytest.raises(ValueError, match="groups"):
        build_model(replace(cfg, moe=replace(cfg.moe, topk_group=1, top_k=5)))
    with pytest.raises(ValueError, match="groups"):
        build_model(replace(cfg, moe=replace(cfg.moe, n_group=5)))
    with pytest.raises(NotImplementedError, match="yarn outside MLA"):
        build_model(replace(get_config("tinyllama-1.1b", smoke=True), rope_type="yarn"))


def _expert_case(device, E=6, D=64, F=32, counts=(5, 0, 9, 1, 0, 7), seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    counts = torch.tensor(counts, device=device)
    xs = torch.randn(int(counts.sum()), D, generator=g, device=device).bfloat16()
    wi, wg = (torch.randn(E, D, F, generator=g, device=device).mul(D ** -0.5).bfloat16()
              for _ in range(2))
    wo = torch.randn(E, F, D, generator=g, device=device).mul(F ** -0.5).bfloat16()
    return counts, xs, wi, wg, wo


def test_grouped_expert_products_equal_the_loop():
    """The card's expert path (three grouped products over every expert,
    bf16) against the loop of products a run, on the same bf16 rows, with
    empty runs: the same products of the same bf16 operands, each rounded
    once to bf16, so they agree to bf16's rounding (1 / 128 of a value, one
    unit in its last place) and each row lands in its own expert's run."""
    counts, xs, wi, wg, wo = _expert_case("cpu")
    act = torch.nn.functional.silu
    grouped = mlp._expert_mlps(act, xs, counts, wi, wg, wo, grouped=True)
    loop = mlp._expert_mlps(act, xs, counts, wi, wg, wo, grouped=False)
    assert grouped.shape == loop.shape == xs.shape and grouped.dtype == torch.bfloat16
    torch.testing.assert_close(grouped.float(), loop.float(), atol=2 ** -7, rtol=2 ** -7)
    # a row read by its neighbour expert's weights is far off
    shifted = mlp._expert_mlps(act, xs, counts.roll(1), wi, wg, wo, grouped=True)
    assert (shifted.float() - loop.float()).abs().max() > 10 * 2 ** -7


# -- the tiny model against the reference --------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    cfg = model_config(MODEL)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 300, (B, MAX_LEN)))
    return cfg, model, params, tokens


def reference(cfg, params, tokens, caps=None):
    """The reference's fp32 logits at every position."""
    ms = Sizes.of(MODEL)
    tree = ref.with_layers(params)
    with torch.no_grad():
        h, aux = ref.forward(ms, tree, tokens, [], ref.Prec(), caps=caps)
        assert float(aux) == 0.0
        return ref.logits(ms, tree, h, ref.Prec())


def test_tiny_full_logits_match_the_reference(tiny):
    cfg, model, params, tokens = tiny
    ref.setup()
    want = reference(cfg, params, tokens)
    with torch.inference_mode():
        got = model.logits(params, {"tokens": tokens})[..., :cfg.vocab_size]
    close(got, want, "full logits")


def _prefill_decode(model, params, tokens):
    """Prefill S tokens, then GEN decode steps fed the given tokens: the
    logits at positions S - 1 .. S + GEN - 1 and the cache."""
    logits, cache = make_prefill_step(model, MAX_LEN)(params, {"tokens": tokens[:, :S]})
    out = [logits]
    step = make_decode_step(model)
    for t in range(GEN - 1):
        logits, cache = step(params, cache, tokens[:, S + t],
                             torch.full((B,), S + t, dtype=torch.int32))
        out.append(logits)
    return torch.stack(out, 1)[..., :model.cfg.vocab_size], cache


def test_prefill_and_decode_through_the_latent_cache_match_the_reference(tiny):
    cfg, model, params, tokens = tiny
    caps = []
    want = reference(cfg, params, tokens[:, :MAX_LEN - 1], caps)
    got, cache = _prefill_decode(model, params, tokens)
    close(got, want[:, S - 1:], "prefill + decode logits")
    layer = 0
    for run in cache:
        for i in range(run["ckv"].shape[0]):
            for k in ("ckv", "kpe"):
                close(run[k][i][:, :MAX_LEN - 1], caps[layer][k], f"cache {k} layer {layer}")
            layer += 1
    assert layer == cfg.n_layers


def test_generate_loop_tokens_are_the_references_best(tiny):
    """The loop feeds the prefill's argmax to its first decode step and
    returns the GEN tokens after it: each the reference's best at its
    position (up to the tolerance) over the sequence the loop ran."""
    cfg, model, params, tokens = tiny
    prompt = tokens[:, :S]
    out = make_generate_loop(model, GEN)(params, {"tokens": prompt}, MAX_LEN)
    first = make_prefill_step(model, MAX_LEN)(params, {"tokens": prompt})[0]
    first = first[:, :cfg.vocab_size].argmax(-1)
    seq = torch.cat([prompt, first[:, None], out[:, :-1]], 1)
    want = reference(cfg, params, seq)[:, S:]
    gap = want.max(-1).values - want.gather(-1, out[..., None])[..., 0]
    assert float(gap.max()) <= TOL * (1 + float(want.abs().max())), gap


def test_only_a_prompts_pass_opens_the_mla_and_expert_spans(tiny):
    """The prefill opens one ``attn: mla`` span a layer and one ``moe:
    experts`` span a MoE layer; the training forward and decode steps open
    neither (their spans would fill the ring with what no reader reads)."""
    from repro_torch import spans
    cfg, model, params, tokens = tiny

    def opened(run):
        spans.reset()
        with torch.inference_mode():
            run()
        return [r.name for r in spans.records() if r.name in ("attn: mla", "moe: experts")]

    step = make_decode_step(model)
    _, cache = make_prefill_step(model, MAX_LEN)(params, {"tokens": tokens[:, :S]})
    assert opened(lambda: model.logits(params, {"tokens": tokens})) == []
    assert opened(lambda: step(params, cache, tokens[:, S],
                               torch.full((B,), S, dtype=torch.int32))) == []
    names = opened(lambda: make_prefill_step(model, MAX_LEN)(params, {"tokens": tokens[:, :S]}))
    assert names.count("attn: mla") == cfg.n_layers
    assert names.count("moe: experts") == cfg.n_layers - cfg.moe.first_dense_layers
    spans.reset()


@pytest.mark.parametrize("fault", ["plain rope", "renormalised gates", "ungrouped top-k"])
def test_each_published_mechanism_left_out_fails_the_comparison(tiny, fault, monkeypatch):
    """What these tests hold the port to: with any one mechanism left out of
    the program, prefill and decode miss the reference far beyond the
    tolerance."""
    cfg, model, params, tokens = tiny
    if fault == "plain rope":
        monkeypatch.setattr(attention, "apply_rotary",
                            lambda c, x, pos: apply_rope(x, pos, c.rope_theta))
    else:
        route = mlp._route
        changed = {"renormalised gates": dict(norm_topk=True),
                   "ungrouped top-k": dict(n_group=1, topk_group=1)}[fault]
        monkeypatch.setattr(mlp, "_route", lambda c, p, x: route(
            replace(c, moe=replace(c.moe, **changed)), p, x))
    want = reference(cfg, params, tokens[:, :MAX_LEN - 1])
    got, _ = _prefill_decode(model, params, tokens)
    assert far(got, want[:, S - 1:])


# -- the benchmark's configuration is the preset ---------------------------------------
def test_benchmark_config_builds_the_presets_model_at_8_layers():
    cell = json.loads((ROOT / "chipbench/configs/deepseek-v2-236b-l8.json").read_text())
    full = get_config("deepseek-v2-236b")
    assert model_config(cell["model"]) == replace(full, n_layers=8, block_pattern=("mla",) * 8)
    rs = cell["rope_scaling"]
    assert (rs["type"], rs["factor"], rs["original_max_position_embeddings"], rs["beta_fast"],
            rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"]) == (
        full.rope_type, full.yarn_factor, full.yarn_original_max_len, full.yarn_beta_fast,
        full.yarn_beta_slow, full.yarn_mscale, full.yarn_mscale_all_dim)
    assert (cell["n_group"], cell["topk_group"], cell["routed_scaling_factor"],
            cell["norm_topk_prob"], cell["topk_method"]) == (
        full.moe.n_group, full.moe.topk_group, full.moe.routed_scaling, full.moe.norm_topk,
        "group_limited_greedy")
    assert (ref.YARN_FACTOR, ref.YARN_ORIGINAL_MAX_LEN, ref.YARN_BETA_FAST, ref.YARN_BETA_SLOW,
            ref.YARN_MSCALE, ref.YARN_MSCALE_ALL_DIM) == (
        rs["factor"], rs["original_max_position_embeddings"], rs["beta_fast"],
        rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"])
