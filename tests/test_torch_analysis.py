"""The port's cost counter and roofline vs the JAX reference's, twins of
tests/test_analysis.py.

``analysis/cost.py`` counts at the dispatcher what the reference's
``analyze_hlo`` parses out of compiled HLO.  Its counts of the smoke
configs' steps (B = 2, S = 256, fp32) against the reference's, measured:

* dense (tinyllama, gemma-2b): prefill equal; a train step counts one
  more LM-head product per loss chunk, 2 * B * S * D * V_padded, because
  the port's chunked loss recomputes each chunk's logits in the backward
  (``torch.utils.checkpoint``) and the reference's compiled step does not;
* MoE (granite; deepseek-v2, which adds MLA, a shared expert and a dense
  first layer): the smoke configs take the dropless path, whose
  ``jax.lax.ragged_dot`` the CPU compiles as a product against all E
  experts for every row, E times the grouped products' FLOPs; the port's
  grouped products count each row once.  So port = reference - (E - 1) *
  the grouped products (forward; and the two backward products a train
  step adds), plus the head's recompute in a train step;
* SSM (zamba2, rwkv6): the chunked scans group their (L, N, P)
  contractions differently; the counts agree within 2% (0.990 and 1.000
  for prefill, 0.995 and 0.996 for a train step less the head recompute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_twins import with_reference_rope_and_routing
from repro.analysis.hlo import analyze_hlo
from repro.analysis.roofline import HW as JHW
from repro.analysis.roofline import model_flops as jmodel_flops
from repro.analysis.roofline import roofline as jroofline
from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.launch.specs import input_specs as jinput_specs
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.steps import train_state_shape as jtrain_state_shape
from repro.models import build_model as jbuild_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.analysis.cost import trace_costs
from repro_torch.analysis.roofline import HW, model_flops, roofline, roofline_from_report
from repro_torch.configs import SHAPES, ShapeSpec, cells, get_config
from repro_torch.launch.dryrun import make_cell, trace_cell

# the test workers share the machine's cores (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

B, S = 2, 256


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def _compiled_text(fn, *sds):
    return jax.jit(fn).lower(*sds).compile().as_text()


def test_loop_flops_counted_per_iteration():
    """A 10-iteration loop of matmuls counts 10x one matmul, as the
    reference's trip-weighted count of a 10-trip scan does."""
    def unrolled(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x.sum()

    _, s = trace_costs(unrolled, _meta(256, 256), _meta(256, 256))
    one = 2 * 256 ** 3
    assert s.dot_flops == 10 * one
    assert s.unweighted_dot_flops == s.dot_flops and s.while_loops == 0 and s.max_trip == 1

    def scanned(x, w):
        y, _ = jax.lax.scan(lambda x, _: (jnp.tanh(x @ w), None), x, jnp.arange(10))
        return y.sum()

    sds = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    assert s.dot_flops == pytest.approx(analyze_hlo(_compiled_text(scanned, sds, sds)).dot_flops,
                                        rel=0.05)


def test_grad_counts_both_passes():
    def loss(x, w):
        for _ in range(6):
            x = torch.tanh(x @ w)
        return (x ** 2).sum()

    x, w = _meta(128, 128, grad=True), _meta(128, 128, grad=True)
    _, s = trace_costs(lambda: torch.autograd.grad(loss(x, w), (x, w)))
    one = 2 * 128 ** 3
    # fwd (6) + bwd dx (6) + bwd dw (6) = 18 matmuls minimum
    assert s.dot_flops >= 17 * one
    assert s.dot_bytes > 0 and s.peak_bytes > 0


def test_no_collectives_on_single_process():
    _, s = trace_costs(lambda x: (x @ x).sum(), _meta(64, 64))
    d = s.to_dict()
    assert d["collective_bytes"] is None and d["collective_count"] is None
    assert d["collectives"] is None and "single process" in d["collective_reason"]
    t = roofline_from_report({"hlo": d})
    assert t.collective_s is None and t.dominant in ("compute", "memory")


def test_roofline_dominance():
    """The reference's fields in both packages' ``roofline``."""
    jhw = JHW()
    hw = HW(**dataclasses.asdict(jhw))
    cases = [((jhw.peak_flops, 0.0, 0.0), "compute", 1.0),
             ((1.0, jhw.hbm_bw * 2, jhw.link_bw), "memory", 2.0),
             ((1.0, 1.0, jhw.link_bw * 3), "collective", 3.0)]
    for args, dom, bound in cases:
        t, jt = roofline(*args, hw), jroofline(*args, jhw)
        assert t.dominant == dom and t.bound_s == pytest.approx(bound)
        assert t.to_dict() == jt.to_dict()
    t = roofline(1.0, jhw.hbm_bw * 2, None, hw)  # collectives not counted: no term
    assert t.dominant == "memory" and t.collective_s is None


def test_h100_record():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) == (989e12, 3.35e12, 80e9)


@pytest.mark.parametrize("arch,shape", jcells(include_skipped=True))
def test_model_flops_equal_reference(arch, shape):
    assert [(a, s) for a, s in cells(include_skipped=True)] == jcells(include_skipped=True)
    kind = SHAPES[shape].kind
    assert model_flops(with_reference_rope_and_routing(get_config(arch)), SHAPES[shape], kind) == \
        jmodel_flops(jget_config(arch), JSHAPES[shape], kind)


def test_model_flops_scales_with_tokens():
    cfg = get_config("tinyllama_1_1b")
    f_train = model_flops(cfg, SHAPES["train_4k"], "train")
    f_prefill = model_flops(cfg, SHAPES["prefill_32k"], "prefill")
    f_decode = model_flops(cfg, SHAPES["decode_32k"], "decode")
    assert f_train > f_prefill > f_decode > 0
    assert 6e15 < f_train < 2e16


def _reference_dot_flops(arch, shape):
    cfg = jget_config(arch, smoke=True)
    model = jbuild_model(cfg)
    batch = jinput_specs(cfg, shape)
    if shape.kind == "train":
        txt = _compiled_text(jmake_train_step(model, JAdamWConfig()),
                             jtrain_state_shape(model, JAdamWConfig()), batch)
    else:
        txt = _compiled_text(jmake_prefill_step(model, shape.seq_len),
                             jax.eval_shape(model.init, jax.random.PRNGKey(0)), batch)
    return analyze_hlo(txt).dot_flops


def _head_recompute(cfg, shape):
    """The chunked loss's logits recomputed in the backward of a train step."""
    return 2 * B * S * cfg.d_model * cfg.padded_vocab if shape.kind == "train" else 0


def _ragged_excess(cfg, shape):
    """What the reference's dropless ``ragged_dot``s count beyond the grouped
    products: (E - 1) x the three products of every MoE layer, B * S * top_k
    rows each (forward; x 3 with the backward's two)."""
    m = cfg.moe
    layers = sum(1 for i, k in enumerate(cfg.blocks) if i >= m.first_dense_layers)
    grouped = layers * 3 * 2 * B * S * m.top_k * cfg.d_model * m.d_expert
    return (m.num_experts - 1) * grouped * (3 if shape.kind == "train" else 1)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma_2b", "granite_moe_3b_a800m",
                                  "deepseek_v2_236b"])
def test_dot_flops_match_analyze_hlo(arch, kind):
    """Dense archs: equal, but for the loss's recomputed head in a train
    step; MoE (and MLA): equal after the dropless products' excess."""
    shape = ShapeSpec(kind, S, B, kind)
    cfg = get_config(arch, smoke=True)
    got = trace_cell(make_cell(arch, shape, smoke=True)).cost.dot_flops
    want = _reference_dot_flops(arch, shape) + _head_recompute(cfg, shape)
    if cfg.moe is not None:
        assert cfg.moe.dropless
        want -= _ragged_excess(cfg, shape)
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["zamba2_1_2b", "rwkv6_7b"])
def test_ssm_dot_flops_near_analyze_hlo(arch, kind):
    """The chunked scans contract in other groupings: within 2%."""
    shape = ShapeSpec(kind, S, B, kind)
    cfg = get_config(arch, smoke=True)
    got = trace_cell(make_cell(arch, shape, smoke=True)).cost.dot_flops
    want = _reference_dot_flops(arch, shape)
    assert got - _head_recompute(cfg, shape) == pytest.approx(want, rel=0.02)
