"""Architecture registry: ``--arch <id>`` resolution for the launchers and
tests (counterpart of ``repro/configs/registry.py``).

``ARCH_IDS`` lists every architecture of the reference, in its order;
every family (dense, moe, vlm, encdec, ssm, hybrid) is ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_MODULES: dict[str, str] = {
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
}

ARCH_IDS = list(ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    return importlib.import_module(ARCH_MODULES[arch_id]).get_config()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
