"""Architecture configs of the LM substrate.

Port of `repro/configs/__init__.py`: each module exposes CONFIG (the
published configuration) and smoke_config() (a reduced same-family config
for CPU tests). `get_config(name)` / `get_smoke_config(name)` /
`list_archs()` are the registry, with the reference's aliases, over all
ten of the reference's architectures.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHS = [
    "qwen2_1_5b",
    "deepseek_coder_33b",
    "yi_6b",
    "internlm2_20b",
    "qwen2_moe_a2_7b",
    "mixtral_8x7b",
    "jamba_1_5_large",
    "mamba2_130m",
    "internvl2_26b",
    "musicgen_large",
]

_ALIASES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-6b": "yi_6b",
    "internlm2-20b": "internlm2_20b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "mamba2-130m": "mamba2_130m",
    "internvl2-26b": "internvl2_26b",
    "musicgen-large": "musicgen_large",
}


def _module(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; the port has "
                         f"{ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs() -> List[str]:
    return list(ARCHS)
