"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen3-14b",
        family="dense",
        model=TransformerConfig(
            name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
            n_kv_heads=8, d_ff=17408, vocab=151936, qk_norm=True,
            rope_theta=1000000.0, q_chunk=512,
            act_dtype=torch.bfloat16,
        ),
        smoke_model=TransformerConfig(
            name="qwen3-14b-smoke", n_layers=2, d_model=40, n_heads=5,
            n_kv_heads=1, d_ff=96, vocab=256, qk_norm=True, q_chunk=16,
        ),
        microbatches={"train_4k": 2},
        parallelism="fsdp",
        source="hf:Qwen/Qwen3-14B",
    )
