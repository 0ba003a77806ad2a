"""Architecture registry: ``--arch <id>`` resolution (PyTorch port).

The ids and aliases are the reference package's.  Each module defines
``full()`` (the published configuration) and ``smoke()`` (a reduced
same-family config that runs on the CPU).  Every id is in ``PORTED``;
``get_config`` would refuse an id in ``UNPORTED`` (none is left), naming
what it lacks.
"""

from __future__ import annotations

import importlib

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
