"""Prefill / decode step builders and the greedy generate loop (PyTorch port).

Training steps wait for the training slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.models.api import Model


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, token, pos):
        with torch.inference_mode():
            return model.decode_step(params, cache, token, pos)

    return decode_step


def make_generate_loop(model: Model, steps: int):
    """Greedy generation: prefill, then ``steps`` decode steps.

    ``generate(params, batch, max_len)`` returns the (B, steps) tokens.
    ``argmax`` takes the first maximum, as the reference's does.
    """
    V = model.cfg.vocab_size

    def generate(params, batch, max_len):
        with torch.inference_mode():
            logits, cache = model.prefill(params, batch, max_len)
            B, S = batch["tokens"].shape
            tok = logits[:, :V].argmax(-1)
            toks = []
            for t in range(steps):
                pos = torch.full((B,), S + t, dtype=torch.int32, device=tok.device)
                logits, cache = model.decode_step(params, cache, tok, pos)
                tok = logits[:, :V].argmax(-1)
                toks.append(tok)
            return torch.stack(toks, dim=1)

    return generate
