"""Dense gated MLP (SwiGLU or GeGLU), twin of the reference's
``mlp_init``/``mlp_apply``.

Mixture-of-experts and the plain two-layer GELU MLP are not ported yet
(``config.check_supported`` refuses them).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .common import act_fn, dense_init
from .config import ModelConfig


def mlp_init(cfg: ModelConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.param_tdtype()
    return {
        "wi": dense_init(gen, cfg.d_model, (d_ff,), dt),   # gate proj
        "wg": dense_init(gen, cfg.d_model, (d_ff,), dt),   # up proj
        "wo": dense_init(gen, d_ff, (cfg.d_model,), dt),
    }


def mlp_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.mlp_act)
    h = act(x @ p["wi"].to(x.dtype)) * (x @ p["wg"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
