"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.hybrid import HybridConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="zamba2-2.7b",
        family="hybrid",
        model=HybridConfig(
            name="zamba2-2.7b", n_layers=54, d_model=2560, n_heads=32,
            n_kv_heads=32, d_ff=10240, vocab=32000, attn_every=18,
            d_state=64, ssm_head_dim=64, expand=2, chunk=128, q_chunk=512,
        ),
        smoke_model=HybridConfig(
            name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=128, vocab=256, attn_every=2, d_state=16,
            ssm_head_dim=16, expand=2, chunk=16, q_chunk=16,
        ),
        sub_quadratic=True,
        microbatches={"train_4k": 2},
        parallelism="fsdp_tp",
        source="arXiv:2411.15242",
        notes="ONE shared MHA+MLP block applied every 18 Mamba2 layers (3 "
              "applications; released ckpt interleaves with LoRA deltas — "
              "simplification recorded in DESIGN.md). long_500k decode cost "
              "= 54 O(1) SSM steps + 3 attention reads over the 500k cache.",
    )
