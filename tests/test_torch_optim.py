"""The port's AdamW and int8 gradient codec against the JAX package's, on
the same trees.

Twins of tests/test_optim.py's AdamW and codec tests, plus parity with the
reference's ``adamw_init``/``adamw_update``/``cosine_schedule`` on a
random tree of fp32 and bf16 leaves with clipping active: fp32 leaves and
metrics at 1e-6, bf16 leaves to one unit in the last place.  The codec's
deterministic path equals the reference's bit for bit (``quantize_int8``,
``int8_codec_roundtrip`` with and without an error state,
``compress_grads`` over a whisper-smoke gradient tree); its stochastic
path (a ``torch.Generator``) lands on the two integers around each value
and is unbiased within five standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import cosine_schedule as jcosine_schedule
from repro.optim.compress import compress_grads as jcompress_grads
from repro.optim.compress import int8_codec_roundtrip as jint8_codec_roundtrip
from repro.optim.compress import quantize_int8 as jquantize_int8
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, compress_grads,
                               cosine_schedule, dequantize_int8, global_norm,
                               int8_codec_roundtrip, quantize_int8)
from repro_torch.tree import tree_leaves, tree_unflatten

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

TOL = 1e-6


def test_adamw_reduces_quadratic_loss():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    st = adamw_init(cfg, params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw of w^2
        params, st, _ = adamw_update(cfg, params, grads, st)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_master_is_distinct_buffer(dtype):
    cfg = AdamWConfig()
    params = {"w": torch.ones(8, dtype=dtype)}
    st = adamw_init(cfg, params)
    # the update writes master and params separately: they must not alias
    assert st["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert st["master"]["w"].dtype == torch.float32
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 100)]
    assert lrs[0] == 0.0 and abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6 and abs(lrs[3] - 0.1) < 1e-6


def test_schedule_matches_jax():
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_ratio=0.05)
    steps = np.arange(0, 60, dtype=np.int32)
    got = np.array([float(cosine_schedule(AdamWConfig(**kw), torch.tensor(s)))
                    for s in steps])
    want = np.array([float(jcosine_schedule(JAdamWConfig(**kw), jnp.asarray(s)))
                     for s in steps])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _tree(rng):
    """A nested tree of fp32 and bf16 leaves, as numpy (bf16 via JAX)."""
    def leaf(shape, dtype, scale):
        return np.asarray(jnp.asarray(rng.normal(size=shape) * scale, dtype))
    return {"dense": {"w": leaf((16, 24), jnp.bfloat16, 0.5), "b": leaf((24,), jnp.float32, 0.1)},
            "layers": [{"scale": leaf((3, 8), jnp.float32, 1.0)},
                       {"k": leaf((3, 8, 8), jnp.bfloat16, 0.2)}],
            "emb": leaf((32, 8), jnp.float32, 0.02)}


def _assert_leaf(name, got, want):
    got = bridge.params_to_numpy(got)
    if want.dtype.name == "bfloat16":
        g, w = got.astype(np.float32), np.asarray(want, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        bad = np.abs(g - w) > ulp
        assert not bad.any(), f"{name}: {bad.sum()} bf16 elements more than 1 ulp apart"
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("keep_master", [True, False])
def test_adamw_update_matches_jax(keep_master):
    """Three updates from the same tree and grads, with global-norm
    clipping active (the grads' norm is above ``grad_clip``)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=0.5,
              keep_master=keep_master)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(jnp.asarray, _tree(rng))
    jst = jadamw_init(JAdamWConfig(**kw), jparams)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    st = adamw_init(AdamWConfig(**kw), params)
    assert bridge.leaf_names(st) == [jax.tree_util.keystr(p) for p, _ in
                                     jax.tree_util.tree_leaves_with_path(jst)]
    for _ in range(3):
        g = _tree(rng)
        jparams, jst, jmet = jadamw_update(JAdamWConfig(**kw), jparams,
                                           jax.tree.map(jnp.asarray, g), jst)
        params, st, met = adamw_update(AdamWConfig(**kw), params,
                                       bridge.params_from_numpy(g, "cpu"), st)
        assert float(jmet["grad_norm"]) > kw["grad_clip"]
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), atol=TOL, rtol=TOL)
        assert int(st["step"]) == int(jst["step"])
        for name, got, want in zip(bridge.leaf_names({"params": params, "opt": st}),
                                   tree_leaves({"params": params, "opt": st}),
                                   jax.tree.leaves({"params": jparams, "opt": jst})):
            _assert_leaf(name, got, want)


def test_adamw_update_writes_the_given_buffers():
    """The update is the counterpart of donation: new values land in the
    buffers the caller passed, and the returned trees hold those tensors."""
    cfg = AdamWConfig(lr=0.1, warmup_steps=1)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(cfg, params)
    before = {n: t.data_ptr() for n, t in zip(bridge.leaf_names(st), tree_leaves(st))}
    new_p, new_st, _ = adamw_update(cfg, params, {"w": torch.ones(4)}, st)
    assert new_p["w"] is params["w"] and float(new_p["w"][0]) < 1.0
    assert {n: t.data_ptr() for n, t in zip(bridge.leaf_names(new_st),
                                           tree_leaves(new_st))} == before
    assert int(new_st["step"]) == 1


def test_global_norm_matches_definition():
    tree = {"a": torch.tensor([3.0]), "b": [torch.tensor([4.0], dtype=torch.bfloat16)]}
    assert float(global_norm(tree)) == 5.0


# -- the int8 gradient codec ------------------------------------------------------
def test_int8_quantize_bounds():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)) * 5).float()
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6  # half-ulp of the scale


def test_int8_error_feedback_preserves_sum():
    """x_hat + err == x + err_in: no gradient mass is lost across steps."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(128,))).float()
    err = torch.from_numpy(rng.normal(size=(128,)) * 0.01).float()
    xhat, new_err = int8_codec_roundtrip(x, err)
    np.testing.assert_allclose((xhat + new_err).numpy(), (x + err).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_int8_error_feedback_converges_on_repeated_grads():
    """Accumulated quantized steps track the true sum (EF property)."""
    g = torch.tensor([0.003, -1.0, 0.5, 2e-4])
    err = None
    acc = torch.zeros_like(g)
    for _ in range(100):
        xhat, err = int8_codec_roundtrip(g, err)
        acc = acc + xhat
    np.testing.assert_allclose(acc.numpy(), (100 * g).numpy(), rtol=0.02, atol=0.02)


def _codec_inputs():
    """name -> numpy input: normals of several scales, an exact tie at every
    half step (round half to even), signed zeros, all zeros (the 1e-12
    floor of the scale), a bf16 tensor."""
    rng = np.random.default_rng(5)
    ties = (np.arange(-254, 255) / 2).astype(np.float32)  # scale 127 / 127: y = x, k + 1/2
    zeros = np.zeros(7, np.float32)
    zeros[::2] = -0.0
    return {"normal x5": (rng.normal(size=(64, 48)) * 5).astype(np.float32),
            "normal x1e-6": (rng.normal(size=(300,)) * 1e-6).astype(np.float32),
            "half steps": ties, "signed zeros": zeros, "all zeros": np.zeros((3, 4), np.float32),
            "bf16": np.asarray(jnp.asarray(rng.normal(size=(40, 8)), jnp.bfloat16))}


def _same_bits(name, got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8), err_msg=name)


@pytest.mark.parametrize("case", list(_codec_inputs()))
def test_int8_codec_equals_jax_bit_for_bit(case):
    """The deterministic path on the same numpy inputs: q, the scale, x_hat
    and the error, with no error state and with one."""
    x = _codec_inputs()[case]
    tx = bridge.params_from_numpy(x, "cpu")
    q, s = quantize_int8(tx)
    jq, js = jquantize_int8(jnp.asarray(x))
    _same_bits(f"{case} q", q, jq)
    _same_bits(f"{case} scale", s, js)
    e0 = (np.random.default_rng(6).normal(size=x.shape) * 0.01).astype(np.float32)
    for err in (None, e0):
        got = int8_codec_roundtrip(tx, None if err is None else torch.from_numpy(err))
        want = jint8_codec_roundtrip(jnp.asarray(x), None if err is None else jnp.asarray(err))
        for part, g, w in zip(("x_hat", "error"), got, want):
            _same_bits(f"{case} {part} (error state {err is not None})", g, w)


def test_compress_grads_equals_jax_over_a_whisper_gradient_tree():
    """``compress_grads`` over the gradients of a whisper-smoke loss (lists
    of layers, the zero gradient of every unused ``wg``), twice with the
    error state carried: every leaf of both trees bit for bit, the leaf
    names the reference's."""
    cfg = get_config("whisper-tiny", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))),
             "frames": torch.from_numpy(rng.normal(size=(2, 64, 64)).astype(np.float32))}
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = build_model(cfg).loss(params, batch)
    grads = bridge.params_to_numpy(
        [g for g in torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)])
    tgrads = tree_unflatten(params, [torch.from_numpy(g) for g in grads])
    jgrads = jax.tree.unflatten(jax.tree.structure(bridge.params_to_numpy(params)),
                                [jnp.asarray(g) for g in grads])
    terr = jerr = None
    for step in range(2):
        (txhat, terr), (jxhat, jerr) = compress_grads(tgrads, terr), jcompress_grads(jgrads, jerr)
        names = bridge.leaf_names(txhat)
        assert names == bridge.leaf_names(terr) == [
            jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jxhat)]
        for n, a, b in zip(names, tree_leaves(txhat), jax.tree.leaves(jxhat)):
            _same_bits(f"step {step} x_hat {n}", a, b)
        for n, a, b in zip(names, tree_leaves(terr), jax.tree.leaves(jerr)):
            _same_bits(f"step {step} error {n}", a, b)
    wg = [t for n, t in zip(names, tree_leaves(txhat)) if n.endswith("['wg']")]
    assert wg and not any(t.any() for t in wg)


def test_int8_stochastic_rounding_is_bracketed_and_unbiased():
    """With a generator, each y = x / scale goes to floor(y) or floor(y) + 1,
    and over N draws the mean of x_hat is x within five standard errors:
    one draw's rounding error has variance f (1 - f) <= 1/4 (f the
    fractional part), so the mean's is at most scale^2 / (4 N)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(256,)) * 3).float()
    gen = torch.Generator().manual_seed(0)
    N = 2000
    s = quantize_int8(x)[1]
    y = x / s
    acc = torch.zeros_like(x, dtype=torch.float64)
    for _ in range(N):
        q, s2 = quantize_int8(x, gen)
        assert torch.equal(s2, s)
        assert ((q.float() == y.floor()) | (q.float() == y.floor() + 1)).all()
        acc += dequantize_int8(q, s2).double()
    bias = (acc / N - x.double()).abs()
    limit = 5 * float(s) * 0.5 / np.sqrt(N)
    print(f"[parity] stochastic int8 rounding over {N} draws: largest |mean - x| "
          f"{float(bias.max()):.3e}, limit {limit:.3e}")
    assert float(bias.max()) <= limit
    assert not torch.equal(quantize_int8(x, torch.Generator().manual_seed(1))[0],
                           quantize_int8(x, torch.Generator().manual_seed(2))[0])
