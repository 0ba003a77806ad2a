"""The port's AdamW against the JAX package's, on the same trees.

Twins of tests/test_optim.py's AdamW tests, plus parity with the
reference's ``adamw_init``/``adamw_update``/``cosine_schedule`` on a
random tree of fp32 and bf16 leaves with clipping active: fp32 leaves and
metrics at 1e-6, bf16 leaves to one unit in the last place.
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
from repro_torch import bridge
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                               global_norm)
from repro_torch.tree import tree_leaves

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
