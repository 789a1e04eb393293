"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import MoESpec, TransformerConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="grok-1-314b",
        family="moe",
        model=TransformerConfig(
            name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
            n_kv_heads=8, d_ff=32768, vocab=131072,
            moe=MoESpec(n_experts=8, top_k=2, capacity_factor=1.25),
            rope_theta=10000.0, q_chunk=512,
            param_dtype=torch.bfloat16, act_dtype=torch.bfloat16,
        ),
        smoke_model=TransformerConfig(
            name="grok-1-smoke", n_layers=2, d_model=48, n_heads=6,
            n_kv_heads=2, d_ff=96, vocab=256,
            moe=MoESpec(n_experts=4, top_k=2, capacity_factor=1.5),
            q_chunk=16,
        ),
        microbatches={"train_4k": 4},
        source="hf:xai-org/grok-1",
        notes="8 experts < 16-way model axis: experts replicated, each "
              "expert's d_ff TP-sharded (DESIGN.md §4 MoE strategies).",
    )
