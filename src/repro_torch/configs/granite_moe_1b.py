"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import MoESpec, TransformerConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="granite-moe-1b-a400m",
        family="moe",
        model=TransformerConfig(
            name="granite-moe-1b-a400m", n_layers=24, d_model=1024,
            n_heads=16, n_kv_heads=8, d_ff=512, vocab=49168,  # padded 49155
            moe=MoESpec(n_experts=32, top_k=8, capacity_factor=1.25),
            rope_theta=10000.0, q_chunk=512, act_dtype=torch.bfloat16,
        ),
        smoke_model=TransformerConfig(
            name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=32, vocab=256,
            moe=MoESpec(n_experts=8, top_k=2, capacity_factor=1.5),
            q_chunk=16,
        ),
        parallelism="ep_dp",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        notes="vocab padded 49155 -> 49168 for 16-way TP divisibility; "
              "32 experts shard EP-16 (2 experts/device) over `model`.",
    )
