"""Meta-tensor stand-ins for every model input (PyTorch port), the
dry-run's fuel; twin of the reference's ``launch/specs.py``.

``input_specs(cfg, shape)`` returns the batch tree of a train or prefill
step, ``decode_specs`` the (token, pos) pair, as tensors on the ``meta``
device: shapes and dtypes, no storage.  Cache shapes come from the port's
own constructors on the meta device (``cache_shape``), the counterpart of
the reference's ``jax.eval_shape``, so they cannot drift from the real
functions.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models.config import ModelConfig

#: number of stubbed visual patches for the VLM backbone
N_VISUAL = 256

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Batch spec for train (tokens+labels) or prefill (tokens)."""
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.visual_stub:
        batch["visual_embeds"] = _meta((B, N_VISUAL, cfg.d_model), torch.bfloat16)
        batch["positions"] = _meta((3, B, S), torch.int32)
    if cfg.enc_dec is not None:
        batch["frames"] = _meta((B, cfg.enc_dec.n_audio_ctx, cfg.d_model), torch.bfloat16)
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    B = shape.global_batch
    return _meta((B,), torch.int32), _meta((B,), torch.int32)


def cache_shape(model, shape: ShapeSpec, params: Any) -> Any:
    """The serve-time cache of a decode cell on the meta device, the tree
    that prefill would produce: ``lm.init_cache`` for the decoder LM; for
    the encoder-decoder a prefill of 8 tokens over the audio frames (its
    cross K/V come from the encoder), as the reference's dry-run does.
    ``params`` is the meta parameter tree."""
    cfg, B = model.cfg, shape.global_batch
    if model.is_enc_dec:
        batch = {"tokens": _meta((B, 8), torch.int32),
                 "frames": _meta((B, cfg.enc_dec.n_audio_ctx, cfg.d_model), torch.bfloat16)}
        with torch.no_grad():
            return model.prefill(params, batch, shape.seq_len)[1]
    from repro_torch.models import lm

    return lm.init_cache(cfg, B, shape.seq_len, META)


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec, rng=None) -> Dict[str, torch.Tensor]:
    """A real (host) batch matching ``input_specs``, drawn from a numpy
    generator in the reference's order, so its values equal the
    reference's: int32 tokens below the vocab size, zero positions, fp32
    normal embeddings."""
    rng = np.random.default_rng(0) if rng is None else rng
    spec = input_specs(cfg, shape)

    def mk(s):
        if s.dtype == torch.int32:
            if s.dim() == 3:  # positions
                return np.zeros(tuple(s.shape), np.int32)
            return rng.integers(0, cfg.vocab_size, tuple(s.shape)).astype(np.int32)
        return rng.normal(size=tuple(s.shape)).astype(np.float32)

    # the reference maps over the dict's leaves in sorted key order
    out = {k: torch.from_numpy(mk(spec[k])) for k in sorted(spec)}
    return {k: out[k] for k in spec}
