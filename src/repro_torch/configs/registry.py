"""Architecture registry: ``--arch <id>`` resolution for the launchers and
tests (counterpart of ``repro/configs/registry.py``).

``ARCH_IDS`` lists every architecture of the reference, in its order;
the transformer family (dense, moe, vlm) is ported.  The other three
(the encdec, ssm and hybrid families) raise ``NotImplementedError``: they
are queued in ROADMAP.md section 1.
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
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
}
# architecture -> its family, for the ones whose model is not ported yet
NOT_PORTED: dict[str, str] = {
    "whisper-tiny": "encdec",
    "mamba2-130m": "ssm",
    "zamba2-2.7b": "hybrid",
}

ARCH_IDS = ["llama3-405b", "internlm2-20b", "qwen2-7b", "qwen3-14b",
            "granite-moe-1b-a400m", "grok-1-314b", "whisper-tiny", "qwen2-vl-7b",
            "mamba2-130m", "zamba2-2.7b"]
PORTED_ARCH_IDS = [a for a in ARCH_IDS if a in ARCH_MODULES]


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} ({NOT_PORTED[arch_id]} family) is not ported to PyTorch yet; "
            "see ROADMAP.md section 1")
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    return importlib.import_module(ARCH_MODULES[arch_id]).get_config()


def all_configs() -> dict[str, ArchConfig]:
    """Every ported architecture's config."""
    return {a: get_config(a) for a in PORTED_ARCH_IDS}
