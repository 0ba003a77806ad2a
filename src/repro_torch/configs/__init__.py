"""Architecture registry: ``--arch <id>`` resolution (PyTorch port).

The ids and aliases are the reference package's.  Each module defines
``full()`` (the published configuration) and ``smoke()`` (a reduced
same-family config that runs on the CPU).  Every id is in ``PORTED``;
``get_config`` would refuse an id in ``UNPORTED`` (none is left), naming
what it lacks.

Shapes: every arch pairs with the LM shape set ``SHAPES`` (the dry-run's
cells, ``cells()``); ``decode_*``/``long_*`` run one decode step against a
``seq_len`` cache.  ``long_500k`` needs sub-quadratic sequence mixing and
runs only for the SSM/hybrid archs (``SKIP_CELLS``).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2_vl_7b",
    "deepseek_v2_236b",
    "granite_moe_3b_a800m",
    "tinyllama_1_1b",
    "gemma_2b",
    "command_r_35b",
    "gemma_7b",
    "whisper_tiny",
    "zamba2_1_2b",
    "rwkv6_7b",
]

ALIASES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma-2b": "gemma_2b",
    "command-r-35b": "command_r_35b",
    "gemma-7b": "gemma_7b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-1.2b": "zamba2_1_2b",
    "rwkv6-7b": "rwkv6_7b",
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: archs whose sequence mixing is sub-quadratic end-to-end (long_500k runs)
LONG_CONTEXT_OK = {"zamba2_1_2b", "rwkv6_7b"}

#: (arch, shape) cells skipped, with the reason
SKIP_CELLS: Dict[Tuple[str, str], str] = {
    (a, "long_500k"): "pure full-attention arch: O(S^2) prefill / O(S) KV "
                      "cache at 524k is out of scope per assignment"
    for a in ARCH_IDS if a not in LONG_CONTEXT_OK
}

PORTED = ("tinyllama_1_1b", "zamba2_1_2b", "rwkv6_7b", "gemma_2b", "gemma_7b",
          "command_r_35b", "qwen2_vl_7b", "granite_moe_3b_a800m", "deepseek_v2_236b",
          "whisper_tiny")
# arch id -> what the port still lacks for it: none is left
UNPORTED: dict = {}


def resolve(arch: str) -> str:
    return ALIASES.get(arch, arch)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    name = resolve(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}")
    if name not in PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet: {UNPORTED[name]}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.full()


def cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if not include_skipped and (a, s) in SKIP_CELLS:
                continue
            out.append((a, s))
    return out
