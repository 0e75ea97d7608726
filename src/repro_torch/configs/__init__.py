"""Published model configs the port serves (copies of ``repro.configs``).

``ARCH_IDS`` lists every arch of the JAX package, and the port has them all:
the dense and MoE decoders (MLA, routed experts, leading dense layers), the
selective SSM (``falcon-mamba-7b``), the RG-LRU hybrid with local attention
(``recurrentgemma-2b``) and the encoder-decoder (``seamless-m4t-medium``).
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "seamless-m4t-medium",
    "falcon-mamba-7b",
    "llama3.2-1b",
    "minicpm-2b",
    "tinyllama-1.1b",
    "nemotron-4-15b",
    "chameleon-34b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
    "recurrentgemma-2b",
]


def _modname(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_modname(arch_id)}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str):
    """Reduced config of the same family for CPU smoke tests."""
    return _module(arch_id).SMOKE
