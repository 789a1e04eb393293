"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias.  [arXiv:2407.10671; hf]"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen2-7b",
        family="dense",
        model=TransformerConfig(
            name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28,
            n_kv_heads=4, d_ff=18944, vocab=152064, qkv_bias=True,
            rope_theta=1000000.0, q_chunk=512,
            act_dtype=torch.bfloat16,
        ),
        smoke_model=TransformerConfig(
            name="qwen2-7b-smoke", n_layers=2, d_model=56, n_heads=7,
            n_kv_heads=1, d_ff=144, vocab=256, qkv_bias=True, q_chunk=16,
        ),
        microbatches={"train_4k": 2},
        parallelism="fsdp",
        source="arXiv:2407.10671",
        notes="28 q-heads are not divisible by the 16-way model axis; the "
              "dry-run shards the flattened qkv projection dims and lets "
              "GSPMD replicate the per-head einsum grouping (see DESIGN.md).",
    )
