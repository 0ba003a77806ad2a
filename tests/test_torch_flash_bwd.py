"""The attention backward's kernel route, on the CPU.

The two backward kernels (``csrc/flash_attention.cu``) run only on the
card, where ``chip_smoke.py`` holds them against their plain version.
Here: that plain version (``flash_attention_bwd_plain``) and the forward's
plain log-sum-exp against autograd through ``ref.attention_naive`` in fp32;
the choice of route as a function of device type, dtype and head_dim; and
the autograd Function on the kernel route (forced on CPU tensors, where
its wrappers run the plain versions) against the plain route, alone and in
a smoke LM under the ``dots`` selective checkpoint.
"""

import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores (tests/test_system.py times
# wall clocks)
torch.set_num_threads(2)

TOL = 1e-5

# (causal, B, H, KV, S, T, D)
SHAPES = {
    "causal-mha": (True, 2, 3, 3, 64, 64, 64),
    "full-gqa": (False, 2, 6, 2, 48, 48, 64),
    "causal-gqa-s<t": (True, 1, 6, 2, 40, 72, 64),
    "causal-gqa-s>t": (True, 1, 6, 2, 70, 40, 64),
    "causal-ragged-d128": (True, 2, 6, 2, 37, 37, 128),
    "full-cross-d128": (False, 1, 3, 3, 37, 91, 128),
}


def _inputs(B, H, KV, S, T, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((B, H, S, D), (B, KV, T, D), (B, KV, T, D)))
    do = torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32))
    return q, k, v, do


def _sees_a_key(S, T, causal):
    """(S,) rows that see at least one key."""
    return torch.arange(S) + (T - S) >= 0 if causal else torch.ones(S, dtype=torch.bool)


def _naive_grads(q, k, v, do, causal):
    """Autograd through the naive oracle; the rows that see no key (where
    the oracle attends uniformly and the kernels return zeros) take no
    output gradient."""
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ref.attention_naive(*xs, causal)
    do = do * _sees_a_key(q.shape[2], k.shape[2], causal)[:, None]
    return torch.autograd.grad(out, xs, do)


def _close(got, want, name):
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL, msg=name)


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_plain_backward_matches_autograd_through_naive(shape):
    causal, B, H, KV, S, T, D = SHAPES[shape]
    q, k, v, do = _inputs(B, H, KV, S, T, D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, with_lse=True)
    do = do * _sees_a_key(S, T, causal)[:, None]
    got = fa.flash_attention_bwd_plain(q, k, v, lse, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, _naive_grads(q, k, v, do, causal)):
        _close(g, w, f"{shape} {name}")


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_forward_lse_is_the_rows_logsumexp(shape):
    causal, B, H, KV, S, T, D = SHAPES[shape]
    q, k, v, _ = _inputs(B, H, KV, S, T, D, seed=1)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, with_lse=True)
    assert torch.equal(o, fa.flash_attention_fwd(q, k, v, causal))
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    kr = k.repeat_interleave(H // KV, 1)
    s = q @ kr.transpose(-1, -2) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.arange(T)[None, :] > torch.arange(S)[:, None] + T - S, -math.inf)
    seen = _sees_a_key(S, T, causal)
    _close(lse[..., seen], torch.logsumexp(s, -1)[..., seen], f"{shape} lse")
    assert torch.all(lse[..., ~seen] == math.inf)
    # with the LSE, the backward's P is the forward's softmax
    p = torch.exp(s - lse[..., None])
    _close((p @ v.repeat_interleave(H // KV, 1))[..., seen, :], o[..., seen, :], f"{shape} o")


def test_rows_without_a_key_get_zero_gradients_not_nan():
    """Causal with S > T: the first S - T rows see no key.  Their forward
    output is zeros, so whatever their output gradient, their dq is exactly
    zero and they add nothing to dk and dv."""
    causal, B, H, KV, S, T, D = SHAPES["causal-gqa-s>t"]
    q, k, v, do = _inputs(B, H, KV, S, T, D, seed=2)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, with_lse=True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, lse, do, causal)
    blind = ~_sees_a_key(S, T, causal)
    assert blind.sum() == S - T
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert torch.all(dq[..., blind, :] == 0) and torch.all(o[..., blind, :] == 0)
    _, dk0, dv0 = fa.flash_attention_bwd(q, k, v, lse, do * ~blind[:, None], causal)
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


@pytest.mark.parametrize("v_common", [0.0, 3.0])
def test_plain_backward_in_bf16_stays_within_its_rounding(v_common):
    """In bf16 (P and dS rounded as the products' operands, the outputs
    rounded) the plain version's gradients stay within 1% of autograd in
    fp32 on the same values, also where V has a large common part, as a
    bias gives it: delta is the backward's own rowsum(P o dP), which that
    part cancels out of dP - delta, where rowsum(dO o O) with O rounded to
    bf16 leaves a bias of dS (dq and dk 10-30% off)."""
    causal, B, H, KV, S, T, D = SHAPES["causal-gqa-s<t"]
    q, k, v, do = (t.bfloat16() for t in _inputs(B, H, KV, S, T, D, seed=3))
    v = (v.float() * 0.05 + v_common).bfloat16() if v_common else v
    lse = fa.attention_lse_plain(q, k, causal)
    got = fa.flash_attention_bwd_plain(q, k, v, lse, do, causal)
    want = _naive_grads(*(t.float() for t in (q, k, v, do)), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - w).norm() / w.norm()) < 1e-2, name


@pytest.mark.parametrize("device,dtype,head_dim,route", [
    ("cuda", torch.bfloat16, 64, "flash"),
    ("cuda", torch.bfloat16, 128, "flash"),
    ("cuda", torch.float32, 64, "plain"),
    ("cuda", torch.bfloat16, 192, "plain"),
    ("cuda", torch.bfloat16, 256, "plain"),
    ("cpu", torch.bfloat16, 64, "plain"),
    ("cpu", torch.float32, 128, "plain"),
])
def test_route_is_a_function_of_device_dtype_and_head_dim(device, dtype, head_dim, route):
    assert ops.attention_backward_route(device, dtype, head_dim) == route


def _function_grads(q, k, v, do, causal, impl):
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.attention(*xs, causal, impl=impl)
    return torch.autograd.grad(out, xs, do)


def _names(recs):
    return {r.name for r in recs if r.name.endswith("backward: attention")}


@pytest.mark.parametrize("shape", ["causal-gqa-s<t", "full-cross-d128"])
def test_function_on_the_kernel_route_matches_the_plain_route(monkeypatch, shape):
    """The Function's kernel route (the forward's LSE saved with its output,
    the backward in a ``flash backward: attention`` span) gives the plain
    route's gradients; on CPU tensors the route is the plain one."""
    causal, B, H, KV, S, T, D = SHAPES[shape]
    q, k, v, do = _inputs(B, H, KV, S, T, D, seed=4)
    spans.reset()
    want = _function_grads(q, k, v, do, causal, "cuda")
    assert _names(spans.records()) == {"plain backward: attention"}
    monkeypatch.setattr(ops, "attention_backward_route", lambda *a: "flash")
    spans.reset()
    # a strided output gradient, as autograd may hand one in
    got = _function_grads(q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2), causal,
                          "cuda")
    assert _names(spans.records()) == {"flash backward: attention"}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, f"{shape} {name}")
    assert "flash_attention_bwd" not in ops.launch_counts()  # no kernel on the CPU


def test_kernel_route_needs_a_gradient(monkeypatch):
    """Under no_grad the forward takes the kernel without the LSE (the
    serving paths' instance), whatever the route."""
    calls = []
    real = fa.flash_attention_fwd

    def spy(*a, **kw):
        calls.append(kw.get("with_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "attention_backward_route", lambda *a: "flash")
    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    q, k, v, _ = _inputs(1, 2, 2, 16, 16, 64, seed=5)
    qg = q.requires_grad_()
    with torch.no_grad():
        ops.attention(qg, k, v, impl="cuda")
    ops.attention(q.detach(), k, v, impl="cuda")
    ops.attention(qg, k, v, impl="cuda")
    assert calls == [False, False, True]


def test_smoke_lm_under_dots_remat_matches_on_both_routes(monkeypatch):
    """granite's smoke config under the ``dots`` selective checkpoint, whose
    recompute runs the Function's forward again: loss and every gradient
    leaf on the kernel route equal the plain route's at 1e-5."""
    cfg = replace(get_config("granite-moe-3b-a800m", smoke=True), remat=True,
                  remat_policy="dots", attn_impl="cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run():
        tree = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = model.loss(tree, batch)
        return loss, torch.autograd.grad(loss, tree_leaves(tree))

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        spans.reset()
        loss_p, grads_p = run()
        assert "flash backward: attention" not in _names(spans.records())
        monkeypatch.setattr(ops, "attention_backward_route", lambda *a: "flash")
        spans.reset()
        loss_f, grads_f = run()
        assert _names(spans.records()) == {"flash backward: attention"}
    finally:
        torch.use_deterministic_algorithms(prev)
    _close(loss_f, loss_p, "loss")
    for i, (g, w) in enumerate(zip(grads_f, grads_p)):
        _close(g, w, f"leaf {i}")


@pytest.mark.cuda
def test_kernel_route_on_the_card_matches_the_plain_version():
    """On the card, bf16: the Function takes the backward kernels (two
    launches, a ``flash backward: attention`` span), whose gradients lie
    within 2e-2 of the plain version's (each gradient's rms, and rtol) and
    repeat bit for bit; fp32 keeps the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(7)
    for causal, S, T in ((True, 130, 130), (True, 100, 300), (False, 77, 200)):
        q = torch.randn(2, S, 6, 64, generator=g, device="cuda").bfloat16().transpose(1, 2)
        k, v = (torch.randn(2, T, 2, 64, generator=g, device="cuda").bfloat16().transpose(1, 2)
                for _ in range(2))
        do = torch.randn(2, 6, S, 64, generator=g, device="cuda").bfloat16()
        spans.reset()
        before = fa.launches_bwd
        got = _function_grads(q, k, v, do, causal, "cuda")
        assert fa.launches_bwd == before + 2
        assert _names(spans.records()) == {"flash backward: attention"}
        assert all(torch.equal(a, b) for a, b in
                   zip(got, _function_grads(q, k, v, do, causal, "cuda")))
        lse = fa.attention_lse_plain(q, k, causal)
        for name, a, w in zip(("dq", "dk", "dv"), got,
                              fa.flash_attention_bwd_plain(q, k, v, lse, do, causal)):
            tol = 2e-2 * float(w.float().pow(2).mean().sqrt())
            torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=2e-2,
                                       msg=f"{causal} {S} {T} {name}")
    before = fa.launches_bwd
    _function_grads(q.float(), k.float(), v.float(), do.float(), causal, "cuda")
    assert fa.launches_bwd == before
