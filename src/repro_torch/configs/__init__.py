"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

Each module defines ``CONFIG`` with the exact assigned full-scale
configuration (citation in ``source``), exercised via the dry-run only.
Smoke tests use ``CONFIG.reduced()``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_ARCHS = [
    "stablelm_12b",
    "phi3_vision_4_2b",
    "deepseek_coder_33b",
    "qwen3_8b",
    "musicgen_large",
    "arctic_480b",
    "zamba2_7b",
    "phi3_5_moe_42b",
    "mistral_nemo_12b",
    "xlstm_125m",
    "opt_13b",  # the paper's own serving model
]

_ALIASES = {
    "stablelm-12b": "stablelm_12b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-8b": "qwen3_8b",
    "musicgen-large": "musicgen_large",
    "arctic-480b": "arctic_480b",
    "zamba2-7b": "zamba2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "xlstm-125m": "xlstm_125m",
    "opt-13b": "opt_13b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def list_archs(include_paper_model: bool = True) -> List[str]:
    archs = list(_ARCHS)
    if not include_paper_model:
        archs.remove("opt_13b")
    return archs


def all_configs(include_paper_model: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in list_archs(include_paper_model)}
