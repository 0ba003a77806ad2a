"""State-space blocks: Mamba2 (Zamba2's mixer) and RWKV6 (Finch).

Twins of the reference's ``models/ssm.py``.  Each block has a
full-sequence pass (chunked scan through :mod:`repro_torch.kernels.ops`,
the hand-written kernels on the card) and an O(1)-state single-token
``decode``, plus ``init_state`` for serving.  Parameter leaves keep the
reference's names, shapes and dtypes, float32 leaves inside bf16 models
included (``A_log``, ``D_skip``, ``dt_bias``, ``mix_x``, ``w0``, ``u``,
``cm_mix``).

One difference from the reference: its Mamba2 prefill runs the
projection, conv and scan twice (once for the output, once for the final
state); :func:`mamba2_prefill` runs them once and takes both from one scan.
The decode functions return new state dicts; the caller writes them into
its cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .common import constrain_dims, dense_init, init_device, unflatten_last, zero_pad
from .config import ModelConfig

Tensors = Dict[str, torch.Tensor]


def _randn(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=init_device(gen))
    return (w * scale).to(dtype)


def _shift(x: torch.Tensor, x_prev_last: Optional[torch.Tensor]) -> torch.Tensor:
    """x moved one position later along S; position 0 is ``x_prev_last``
    (zeros when None)."""
    shift = zero_pad(x, (0, 0, 1, 0))[:, :-1]
    if x_prev_last is not None:
        shift[:, 0] = x_prev_last
    return shift


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
def mamba2_init(cfg: ModelConfig, gen: torch.Generator) -> Tensors:
    mc = cfg.mamba
    D = cfg.d_model
    Din = mc.d_inner(D)
    H = mc.n_heads(D)
    G, N = mc.ngroups, mc.d_state
    # in_proj -> [z (Din), x (Din), B (G*N), C (G*N), dt (H)]
    proj_out = 2 * Din + 2 * G * N + H
    dt = cfg.param_tdtype()
    dev = init_device(gen)
    # S4D-real A init, A = -exp(U(log 1, log 16)); stored as log(-A)
    A_log = torch.empty(H, dtype=torch.float32, device=dev).uniform_(
        math.log(1.0), math.log(16.0), generator=gen)
    return {
        "in_proj": dense_init(gen, D, (proj_out,), dt),
        "conv_w": _randn(gen, (mc.d_conv, Din + 2 * G * N), 0.1, dt),
        "A_log": A_log,
        "D_skip": torch.ones(H, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(H, dtype=torch.float32, device=dev),
        "norm_w": torch.ones(Din, dtype=dt, device=dev),  # gated RMSNorm before out_proj
        "out_proj": dense_init(gen, Din, (D,), dt),
    }


def _mamba2_split(cfg: ModelConfig, proj: torch.Tensor):
    mc = cfg.mamba
    Din = mc.d_inner(cfg.d_model)
    H = mc.n_heads(cfg.d_model)
    G, N = mc.ngroups, mc.d_state
    z, xbc, dt_raw = torch.split(proj, [Din, Din + 2 * G * N, H], dim=-1)
    return z, xbc, dt_raw, (Din, H, G, N)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    y = yf * torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(z.dtype)


def _mamba2_forward(cfg: ModelConfig, p: Tensors, x: torch.Tensor):
    """x: (B,S,D) -> (out (B,S,D), final SSM state, conv history): the
    history is the last d_conv - 1 rows of pre-conv xbc, zeros in front
    when S < d_conv - 1."""
    mc = cfg.mamba
    B, S, _ = x.shape
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw, (Din, H, G, N) = _mamba2_split(cfg, proj)
    # causal depthwise conv over (x, B, C), summed in the reference's order
    w = p["conv_w"].to(x.dtype)  # (d_conv, Din+2GN)
    pad = zero_pad(xbc, (0, 0, mc.d_conv - 1, 0))
    conv = sum(w[i] * pad[:, i:i + S] for i in range(mc.d_conv))
    conv = F.silu(conv.float()).to(x.dtype)
    xs, Bm, Cm = torch.split(conv, [Din, G * N, G * N], dim=-1)
    xs = constrain_dims(xs.reshape(B, S, H, mc.headdim),  # strided views of conv, no copies
                        {0: "dp", 2: "model"})
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, hfin = ops.mamba2(xs, dtv, A, Bm, Cm, impl=cfg.scan_impl)
    y = y + xs * p["D_skip"][None, None, :, None].to(x.dtype)
    y = _gated_rmsnorm(y.reshape(B, S, Din), z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), hfin, pad[:, S:]


def mamba2_apply(cfg: ModelConfig, p: Tensors, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D); full-sequence chunked SSD scan."""
    return _mamba2_forward(cfg, p, x)[0]


def mamba2_prefill(cfg: ModelConfig, p: Tensors,
                   x: torch.Tensor) -> Tuple[torch.Tensor, Tensors]:
    """Output and the final SSM + conv state (for decode), from one scan.
    A prompt shorter than d_conv - 1 leaves zeros in front of the conv
    state, as if it had been decoded from :func:`mamba2_init_state`."""
    out, hfin, hist = _mamba2_forward(cfg, p, x)
    return out, {"ssm": hfin, "conv": hist}


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device: torch.device) -> Tensors:
    mc = cfg.mamba
    D = cfg.d_model
    Din = mc.d_inner(D)
    H, G, N = mc.n_heads(D), mc.ngroups, mc.d_state
    return {
        "ssm": torch.zeros((batch, H, mc.headdim, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, mc.d_conv - 1, Din + 2 * G * N), dtype=dtype,
                            device=device),
    }


def mamba2_decode(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                  state: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """x: (B,1,D) single token -> (out, new state)."""
    mc = cfg.mamba
    B = x.shape[0]
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw, (Din, H, G, N) = _mamba2_split(cfg, proj)
    hist = torch.cat([state["conv"], xbc], dim=1)  # (B, d_conv, C)
    conv = torch.einsum("btc,tc->bc", hist, p["conv_w"].to(x.dtype))
    conv = F.silu(conv.float()).to(x.dtype)
    xs, Bm, Cm = torch.split(conv, [Din, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, mc.headdim)
    dtv = F.softplus(dt_raw[:, 0].float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    y, ssm = ops.mamba2_decode(xs, dtv, A, Bm.reshape(B, G, N), Cm.reshape(B, G, N),
                               state["ssm"])
    y = y + xs * p["D_skip"][None, :, None].to(x.dtype)
    y = _gated_rmsnorm(y.reshape(B, 1, Din), z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), {"ssm": ssm, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
def rwkv6_init(cfg: ModelConfig, gen: torch.Generator) -> Tensors:
    rc = cfg.rwkv
    D = cfg.d_model
    H = D // rc.head_dim
    dt = cfg.param_tdtype()
    dev = init_device(gen)
    f32 = torch.float32
    return {
        # token mix
        "mix_x": torch.full((5, D), 0.5, dtype=f32, device=dev),
        "mix_w1": dense_init(gen, D, (5 * rc.mix_lora,), dt),
        "mix_w2": _randn(gen, (5, rc.mix_lora, D), 0.02, dt),
        "w0": torch.full((D,), -3.0, dtype=f32, device=dev),  # decay bias
        "w1": dense_init(gen, D, (rc.decay_lora,), dt),
        "w2": _randn(gen, (rc.decay_lora, D), 0.02, dt),
        "wr": dense_init(gen, D, (D,), dt),
        "wk": dense_init(gen, D, (D,), dt),
        "wv": dense_init(gen, D, (D,), dt),
        "wg": dense_init(gen, D, (D,), dt),
        "u": _randn(gen, (H, rc.head_dim), 0.1, f32),
        "ln_w": torch.ones(D, dtype=dt, device=dev),  # per-head group norm
        "wo": dense_init(gen, D, (D,), dt),
        # channel mix
        "cm_mix": torch.full((2, D), 0.5, dtype=f32, device=dev),
        "cm_k": dense_init(gen, D, (cfg.d_ff,), dt),
        "cm_v": dense_init(gen, cfg.d_ff, (D,), dt),
        "cm_r": dense_init(gen, D, (D,), dt),
    }


def _rwkv6_mix(p: Tensors, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift mixing -> (xr, xk, xv, xw, xg)."""
    dt = x.dtype
    sx = x_prev - x
    base = x + sx * p["mix_x"][0].to(dt)
    lora = torch.tanh((base @ p["mix_w1"].to(dt)).float()).to(dt)
    lora = unflatten_last(lora, (5, -1))
    adj = torch.einsum("bsnk,nkd->bsnd", lora, p["mix_w2"].to(dt))
    return [x + sx * (p["mix_x"][i].to(dt) + adj[:, :, i]) for i in range(5)]


def _rwkv6_rkvwg(cfg: ModelConfig, p: Tensors, x: torch.Tensor, x_prev: torch.Tensor):
    rc = cfg.rwkv
    H = cfg.d_model // rc.head_dim
    dt = x.dtype
    xr, xk, xv, xw, xg = _rwkv6_mix(p, x, x_prev)
    r = constrain_dims(xr @ p["wr"].to(dt), {0: "dp", 2: "model"})
    k = constrain_dims(xk @ p["wk"].to(dt), {0: "dp", 2: "model"})
    v = constrain_dims(xv @ p["wv"].to(dt), {0: "dp", 2: "model"})
    g = xg @ p["wg"].to(dt)
    dw = torch.tanh((xw @ p["w1"].to(dt)).float()).to(dt) @ p["w2"].to(dt)
    # per-channel log decay, always negative: w = -exp(w0 + dw)
    w = -torch.exp(p["w0"] + dw.float())
    shp = (*x.shape[:2], H, rc.head_dim)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), g


def _rwkv6_out(cfg: ModelConfig, p: Tensors, y: torch.Tensor, g: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    B, S = y.shape[:2]
    # per-head group norm
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).pow(2).mean(-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    yn = yf.reshape(B, S, cfg.d_model) * p["ln_w"].float()
    yn = yn.to(dtype) * F.silu(g.float()).to(dtype)
    return yn @ p["wo"].to(dtype)


def rwkv6_time_mix(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                   x_prev_last: Optional[torch.Tensor] = None,
                   s0: Optional[torch.Tensor] = None):
    """Full-sequence token mix.  Returns (out, (last_x, s_final))."""
    r, k, v, w, g = _rwkv6_rkvwg(cfg, p, x, _shift(x, x_prev_last))
    y, sfin = ops.rwkv6(r, k, v, w, p["u"], s0=s0, impl=cfg.scan_impl)
    return _rwkv6_out(cfg, p, y, g, x.dtype), (x[:, -1], sfin)


def rwkv6_channel_mix(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                      x_prev_last: Optional[torch.Tensor] = None):
    dt = x.dtype
    sx = _shift(x, x_prev_last) - x
    xk = x + sx * p["cm_mix"][0].to(dt)
    xr = x + sx * p["cm_mix"][1].to(dt)
    kk = constrain_dims(xk @ p["cm_k"].to(dt), {0: "dp", 2: "model"})
    kk = torch.relu(kk.float()).square().to(dt)
    vv = kk @ p["cm_v"].to(dt)
    rr = torch.sigmoid((xr @ p["cm_r"].to(dt)).float())
    return rr.to(dt) * vv, x[:, -1]


def rwkv6_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Tensors:
    rc = cfg.rwkv
    D = cfg.d_model
    H = D // rc.head_dim
    return {
        "tm_x": torch.zeros((batch, D), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, rc.head_dim, rc.head_dim), dtype=torch.float32,
                           device=device),
        "cm_x": torch.zeros((batch, D), dtype=dtype, device=device),
    }


def rwkv6_decode(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                 state: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """One-token time mix.  x: (B,1,D)."""
    r, k, v, w, g = _rwkv6_rkvwg(cfg, p, x, state["tm_x"][:, None])
    y, s = ops.rwkv6_decode(r[:, 0], k[:, 0], v[:, 0], w[:, 0], p["u"], state["wkv"])
    out = _rwkv6_out(cfg, p, y[:, None], g, x.dtype)
    return out, {**state, "tm_x": x[:, 0], "wkv": s}


def rwkv6_channel_decode(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                         state: Tensors) -> Tuple[torch.Tensor, Tensors]:
    out, last = rwkv6_channel_mix(cfg, p, x, state["cm_x"])
    return out, {**state, "cm_x": last}
