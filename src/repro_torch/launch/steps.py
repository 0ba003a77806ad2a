"""Train, prefill and decode steps and the greedy generate loop
(PyTorch port), twins of the reference's ``launch/steps.py``."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.api import Model
from repro_torch.models.common import active_mesh, is_dtensor
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.spans import span
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_train_state(model: Model, opt_cfg: AdamWConfig, gen: torch.Generator) -> Dict[str, Any]:
    """``{"params", "opt": {"m", "v", "step", "master"}}``, the reference's
    nesting, with random weights from ``gen`` on its device."""
    params = model.init(gen)
    return {"params": params, "opt": adamw_init(opt_cfg, params)}


def train_state_shape(model: Model, opt_cfg: AdamWConfig) -> Dict[str, Any]:
    """The train state on the meta device: every leaf's shape and dtype,
    no storage (the initialisers' draws from a CPU generator land on meta
    tensors, ``models.common.init_device``)."""
    with torch.device("meta"):
        return make_train_state(model, opt_cfg, torch.Generator())


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``.

    The loss is differentiated with respect to fresh leaves that share the
    stored params' buffers, so the stored state carries no autograd flags;
    AdamW then writes the new values into the state's buffers.  A leaf the
    loss never reads (the plain GELU MLP's ``wg``) gets a zero gradient, as
    in the reference.  The metrics are 0-d tensors on the params' device;
    nothing waits for the device.  The three phases are the spans
    ``train: forward``, ``train: backward`` (the parent of every span the
    backward opens, on any thread) and ``train: optimizer``, each also on
    the device's clock.

    Over a mesh (DTensor params, inside ``mesh_context``) each gradient is
    brought to its param's placements before the update: a replicated
    param's gradient, a partial sum over the ranks that split the batch, is
    all-reduced once, so every rank applies the same update.
    """
    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        dev = tree_leaves(state["params"])[0].device
        with span("train: forward", device=dev):
            params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
            with torch.enable_grad():
                loss = model.loss(params, batch)
        with span("train: backward", device=dev, home=True):
            with torch.enable_grad():
                grads = tree_unflatten(params, torch.autograd.grad(
                    loss, tree_leaves(params), allow_unused=True, materialize_grads=True))
            grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                             if is_dtensor(g) else g, grads, params)
        with span("train: optimizer", device=dev):
            new_params, new_opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                                        state["opt"])
        metrics = dict(metrics, loss=loss.detach())
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _serving_mode():
    """``inference_mode``; over a mesh ``no_grad``, since DTensor views
    cannot be made inside ``inference_mode``."""
    return torch.no_grad() if active_mesh() is not None else torch.inference_mode()


def make_prefill_step(model: Model, max_len: int):
    """``prefill_step(params, batch) -> (logits, cache)``, in a
    ``serve: prefill`` span."""
    def prefill_step(params, batch):
        with span("serve: prefill", device=batch["tokens"].device), _serving_mode():
            return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, token, pos):
        with _serving_mode():
            return model.decode_step(params, cache, token, pos)

    return decode_step


def make_generate_loop(model: Model, steps: int):
    """Greedy generation: prefill, then ``steps`` decode steps.

    ``generate(params, batch, max_len)`` returns the (B, steps) tokens.
    ``argmax`` takes the first maximum, as the reference's does.  The
    prefill with its first token is a ``serve: prefill`` span, the decode
    steps together a ``serve: decode`` span, both also on the device's
    clock, and each decode step a ``serve: decode step`` span (attribute
    ``step``) on the host's; the caller's span around the call groups them.
    """
    V = model.cfg.vocab_size

    def generate(params, batch, max_len):
        dev = batch["tokens"].device
        with _serving_mode():
            with span("serve: prefill", device=dev):
                logits, cache = model.prefill(params, batch, max_len)
                B, S = batch["tokens"].shape
                tok = logits[:, :V].argmax(-1)
            toks = []
            with span("serve: decode", device=dev, steps=steps):
                for t in range(steps):
                    with span("serve: decode step", step=t):
                        pos = torch.full((B,), S + t, dtype=torch.int32, device=tok.device)
                        logits, cache = model.decode_step(params, cache, tok, pos)
                        tok = logits[:, :V].argmax(-1)
                    toks.append(tok)
            return torch.stack(toks, dim=1)

    return generate
