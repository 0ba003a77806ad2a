"""AdamW with mixed-precision master weights and global-norm clipping.

Twin of the reference package's ``optim/adamw.py``: the same config, the
same state layout and the same order of operations.  State:

  master: fp32 copy of the params (optional: ``keep_master=False`` updates
          the params directly)
  m, v:   fp32 moments
  step:   int32 0-d tensor

The trees are nested dicts and lists of tensors, as the parameters are.
:func:`adamw_update` writes the new values into the state's and the
params' buffers and returns the same tensors: the counterpart of the
reference trainer's donation.  The old state is consumed by the call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    keep_master: bool = True
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(cfg: AdamWConfig, params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_leaves(params)[0]
    st = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if cfg.keep_master:
        # a copy also for fp32 params: the update writes master and params
        # separately, so the two must not share a buffer
        st["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return st


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: Dict[str, Any]) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params [param dtype], new_state, metrics).

    The new values are written into the buffers of ``params`` and
    ``state``, which the returned trees hold.
    """
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    src = state.get("master", params)

    def upd(p, g, m, v, out):
        g = g.to(torch.float32) * clip
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        pf = p.to(torch.float32)
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf)
        m.copy_(m_new)
        v.copy_(v_new)
        if p is not out:
            p.copy_(pf)  # the master
        out.copy_(pf)    # cast to the param's dtype

    # leaf by leaf, so that one leaf's temporaries are alive at a time
    tree_map(upd, src, grads, state["m"], state["v"], params)
    state["step"].copy_(step)
    new_state = {"m": state["m"], "v": state["v"], "step": state["step"]}
    if cfg.keep_master:
        new_state["master"] = state["master"]
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
