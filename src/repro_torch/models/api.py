"""Model front door: ``build_model(cfg)`` returns a Model facade with
init / loss / prefill / decode_step bound to the right family: the
encoder-decoder (``whisper``) for ``enc_dec`` configs, else the decoder LM
(``lm``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from . import lm, whisper
from .config import ModelConfig, check_supported


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    logits: Optional[Callable] = None

    @property
    def is_enc_dec(self) -> bool:
        return self.cfg.enc_dec is not None


def build_model(cfg: ModelConfig) -> Model:
    check_supported(cfg)
    if cfg.enc_dec is not None:
        return Model(
            cfg=cfg,
            init=lambda gen: whisper.init(cfg, gen),
            loss=lambda params, batch: whisper.loss(cfg, params, batch),
            prefill=lambda params, batch, max_len: whisper.prefill(cfg, params, batch, max_len),
            decode_step=lambda params, cache, token, pos: whisper.decode_step(
                cfg, params, cache, token, pos),
        )
    return Model(
        cfg=cfg,
        init=lambda gen: lm.init(cfg, gen),
        loss=lambda params, batch: lm.loss(cfg, params, batch),
        prefill=lambda params, batch, max_len: lm.prefill(cfg, params, batch, max_len),
        decode_step=lambda params, cache, token, pos: lm.decode_step(cfg, params, cache, token, pos),
        logits=lambda params, batch: lm.logits_fn(cfg, params, batch),
    )
