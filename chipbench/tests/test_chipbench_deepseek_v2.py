"""The DeepSeek-V2 prefill cell's check and readers on the CPU, through
whole runs of its prefill kind at a tiny size (a model block of its own,
the cell's traffic with short prompts): a sound run passes limits set at
twice its own readings; the published mechanisms left out under the timed
path (plain RoPE for YaRN, renormalised gates, an ungrouped top-k) and the
control (the reference in float8 in the program's place) come out not
correct by the same limits; the three readers of the program's spans and
counters read a traced run, and give the arithmetic of synthetic spans."""

import copy
import sys
import time
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch

from chipbench import spec
from chipbench.harness import Ctx, judge, program_on_path, run_cell
from chipbench.reference import deepseek_v2, moe_lm

torch.set_num_threads(2)

CELL = "deepseek-v2-236b-l8.prefill-b2p8192"
READERS = ["mla_attn_ms.prefill", "moe_experts_ms.prefill", "expert_load_ratio.prefill"]

#: the cell's model block at tiny widths: a dense first layer, then MLA and
#: 16 routed experts in 4 groups (top 2 groups, top-3, gates x 16, dropless)
#: plus shared experts, YaRN as published (qk_rope 16 holds the ramp), bf16
MODEL = {
    "name": "deepseek-v2-tiny", "vocab_size": 500, "d_model": 64, "n_layers": 3,
    "n_heads": 4, "n_kv_heads": 4, "d_ff": 96, "head_dim": 0, "block_pattern": ["mla"] * 3,
    "mlp_act": "silu", "rope_theta": 10000.0, "norm_eps": 1e-06, "rope_type": "yarn",
    "yarn_factor": 40.0, "yarn_original_max_len": 4096, "yarn_beta_fast": 32.0,
    "yarn_beta_slow": 1.0, "yarn_mscale": 0.707, "yarn_mscale_all_dim": 0.707,
    "vocab_round": 256, "loss_chunk": 16, "remat": True, "remat_policy": "nothing",
    "sharding_profile": "tp", "param_dtype": "bfloat16", "compute_dtype": "bfloat16",
    "mla": {"q_lora": 32, "kv_lora": 16, "qk_nope": 16, "qk_rope": 16, "v_head": 16},
    "moe": {"num_experts": 16, "top_k": 3, "d_expert": 32, "num_shared": 2,
            "first_dense_layers": 1, "dense_d_ff": 96, "capacity_factor": 1.0,
            "serve_capacity_factor": 3.0, "aux_loss_weight": 0.001, "group_tokens": 32,
            "map_chunk_groups": 4096, "dropless": True, "n_group": 4, "topk_group": 2,
            "routed_scaling": 16.0, "norm_topk": False},
}


@pytest.fixture(scope="module", autouse=True)
def fan_in_draws():
    """The tiny model's weights drawn at 1 / sqrt(fan-in), moe_lm's rule: at
    these widths the published standard deviation (0.006, the reference's
    :func:`init_scale`) leaves the experts' outputs some 1e-4 of the
    residual, where no routing fault would show."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(deepseek_v2, "init_scale", moe_lm.init_scale)
        yield


#: the cell's own draw, before the fixture above replaces it
CELL_DRAW = deepseek_v2.init_scale


def ctx(seconds: float = 0.5, **kw) -> Ctx:
    cell = spec.workload(CELL)
    cfg = copy.deepcopy(spec.config(cell["config"]))
    cfg["model"] = copy.deepcopy(MODEL)
    tr = dict(spec.traffic(cell["traffic"]), prompt_lens=[40], max_len=48)
    return Ctx(workload=CELL, config=cfg, traffic=tr, seed=2147483711, seconds=seconds,
               trace=kw.pop("trace", False), device=torch.device("cpu"),
               t_start=time.perf_counter(), **kw)


def _limits(outcome):
    return {key: 2 * value + 1e-6 for _, value, key in outcome.checks}


@pytest.fixture(scope="module")
def sound():
    outcome, _ = run_cell(ctx(control="fp8"))
    return outcome


def test_the_cell_reads_the_deepseek_reference():
    cfg = spec.config(spec.workload(CELL)["config"])
    assert cfg["reference"] == "deepseek_v2"
    assert ctx().reference.__name__ == "chipbench.reference.deepseek_v2"


@pytest.mark.parametrize("path,want", [
    (("embed", "tok"), 0.006), (("lm_head",), 0.006), (("layers", 1, "attn", "q_up"), 0.006),
    (("layers", 1, "ffn", "wi"), 0.006), (("layers", 1, "ffn", "shared", "wo"), 0.006),
    (("layers", 1, "ffn", "router"), 0.0015), (("layers", 1, "ln2", "scale"), None)])
def test_the_cells_draw_is_the_published_one_but_for_the_router(path, want):
    assert CELL_DRAW(path, (2, 8, 4)) == want


def test_sound_run_within_limits_at_twice_its_readings(sound):
    ok, report = judge(sound, _limits(sound))
    assert ok, report
    assert {n for n, _, _ in sound.checks} == {"mean_gap", "cache_rel_err"}
    assert sound.metrics["setup_s"] > 0 and sound.metrics["ttft_p95_ms"] > 0


def test_control_fails_a_number(sound):
    limits, readings = _limits(sound), sound.control
    assert readings["control_mean_gap"] > limits["mean_gap"] or \
        readings["control_cache_rel_err"] > limits["cache_rel_err"]


def _plain_rope(monkeypatch):
    from repro_torch.models import attention
    from repro_torch.models.common import apply_rope
    monkeypatch.setattr(attention, "apply_rotary",
                        lambda cfg, x, pos: apply_rope(x, pos, cfg.rope_theta))


def _routing(**changed):
    def plant(monkeypatch):
        from repro_torch.models import mlp
        route = mlp._route
        monkeypatch.setattr(mlp, "_route", lambda cfg, p, x: route(
            replace(cfg, moe=replace(cfg.moe, **changed)), p, x))
    return plant


@pytest.mark.parametrize("plant", [_plain_rope, _routing(norm_topk=True),
                                   _routing(n_group=1, topk_group=1)],
                         ids=["plain rope", "renormalised gates", "ungrouped top-k"])
def test_a_published_mechanism_left_out_is_caught(sound, monkeypatch, plant):
    program_on_path()
    plant(monkeypatch)
    c = ctx()
    c.limits = _limits(sound)
    _, result = run_cell(c)
    assert result["correct"] is False, result["checks"]


# -- the readers ------------------------------------------------------------------
@pytest.fixture(scope="module")
def traced():
    program_on_path()
    from repro_torch import spans
    spans.reset()
    c = ctx(seconds=2.0, trace=True)
    outcome, result = run_cell(c)
    return c, outcome, result


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_run(traced, name):
    c, outcome, result = traced
    value = spec.reader(name)(outcome.obs, c)
    assert isinstance(value, float) and value > 0, (name, value)
    assert result["metrics"][name]["value"] == value
    if name == "expert_load_ratio.prefill":
        assert 1.0 <= value <= MODEL["moe"]["num_experts"]


def test_readers_give_nothing_without_the_programs_spans(traced, monkeypatch):
    c, outcome, _ = traced
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert all(spec.reader(name)(outcome.obs, c) is None for name in READERS)


class _Span(SimpleNamespace):
    pass


def _fake(monkeypatch, recs, counters):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", SimpleNamespace(
        records=lambda: recs, counters=lambda: counters))


def test_readers_arithmetic_on_synthetic_spans(monkeypatch):
    """Three batches: the median of each batch's summed device ms; a span of
    another root (a decode loop's prefill, nested in a caller's span) and a
    batch with a device time not yet known are left out."""
    recs, ids = [], iter(range(1, 1000))

    def batch(mla, experts, parent=None):
        root = _Span(name="serve: prefill", id=next(ids), parent=parent, device_ms=1.0)
        root.root = root.id if parent is None else parent.root
        recs.append(root)
        for name, times in (("attn: mla", mla), ("moe: experts", experts)):
            for ms in times:
                recs.append(_Span(name=name, id=next(ids), parent=root, root=root.root,
                                  device_ms=ms))
    batch([1.0, 2.0, 3.0], [10.0, 20.0])        # 6, 30
    batch([2.0, 2.0, 2.0], [1.0, 1.0])          # 6, 2
    batch([5.0, 5.0, 5.0], [40.0, 40.0])        # 15, 80
    batch([1.0, None, 1.0], [None, 1.0])        # unknown: left out
    outer = _Span(name="serve: generate", id=next(ids), parent=None)
    outer.root = outer.id
    batch([100.0], [100.0], parent=outer)       # not a root: left out
    _fake(monkeypatch, recs, {"moe: expert rows": 3 * 600, "moe: expert rows max": 3 * 45})
    c = ctx()
    c.config["model"]["moe"]["num_experts"] = 160
    assert spec.reader("mla_attn_ms.prefill")({}, c) == 6.0
    assert spec.reader("moe_experts_ms.prefill")({}, c) == 30.0
    assert spec.reader("expert_load_ratio.prefill")({}, c) == 160 * 45 / 600
    _fake(monkeypatch, [], {})
    assert all(spec.reader(name)({}, c) is None for name in READERS)
