"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab.  [arXiv:2407.21783; unverified]"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="llama3-405b",
        family="dense",
        model=TransformerConfig(
            name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
            n_kv_heads=8, d_ff=53248, vocab=128256, rope_theta=500000.0,
            q_chunk=512,
            param_dtype=torch.bfloat16, act_dtype=torch.bfloat16,
        ),
        smoke_model=TransformerConfig(
            name="llama3-405b-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_ff=160, vocab=256, rope_theta=500000.0, q_chunk=16,
        ),
        microbatches={"train_4k": 8, "prefill_32k": 1},
        source="arXiv:2407.21783",
        notes="GQA 16:1; tied unembedding used in-framework (the released "
              "model unties; FLOP-equivalent for the dry-run).",
    )
