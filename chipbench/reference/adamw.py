"""Plain AdamW as the training traffic states it: the gradients clipped by
their global norm, bias-corrected moments, decoupled weight decay on every
leaf, a linear warmup then a cosine decay of the rate; float32 state."""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def rate(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


class AdamW:
    def __init__(self, opt: Dict, params: List[torch.Tensor]):
        self.opt = opt
        self.params = params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.step = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One step; returns the clipped gradients the moments took in."""
        o = self.opt
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        clip = min(o["grad_clip"] / max(gnorm, 1e-9), 1.0)
        self.step += 1
        lr = rate(o, self.step)
        b1c, b2c = 1 - o["b1"] ** self.step, 1 - o["b2"] ** self.step
        clipped = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g * clip
            clipped.append(g)
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            p.sub_(lr * ((m / b1c) / ((v / b2c).sqrt() + o["eps"]) + o["weight_decay"] * p))
        return clipped
