"""Architecture registry: one module per assigned architecture.

Each ``src/repro_torch/configs/<arch>.py`` defines ``FULL`` (the exact published
config) and ``SMOKE`` (a reduced same-family config for CPU tests). The
registry resolves ``--arch <id>`` for the launcher, dry-run and benchmarks.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "mixtral_8x7b",
    "mixtral_8x22b",
    "llava_next_34b",
    "whisper_medium",
    "tinyllama_1_1b",
    "command_r_plus_104b",
    "granite_3_2b",
    "qwen2_5_3b",
    "mamba2_780m",
    "recurrentgemma_9b",
]

# Accept the public dashed ids too.
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "mixtral-8x7b": "mixtral_8x7b", "mixtral-8x22b": "mixtral_8x22b",
    "llava-next-34b": "llava_next_34b", "whisper-medium": "whisper_medium",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "command-r-plus-104b": "command_r_plus_104b",
    "granite-3-2b": "granite_3_2b", "qwen2.5-3b": "qwen2_5_3b",
    "mamba2-780m": "mamba2_780m", "recurrentgemma-9b": "recurrentgemma_9b",
})


def resolve(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
    return mod.SMOKE if smoke else mod.FULL


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
