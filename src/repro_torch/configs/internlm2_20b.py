"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA.  [arXiv:2403.17297; hf]"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="internlm2-20b",
        family="dense",
        model=TransformerConfig(
            name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
            n_kv_heads=8, d_ff=16384, vocab=92544, rope_theta=1000000.0,
            q_chunk=512,
            act_dtype=torch.bfloat16,
        ),
        smoke_model=TransformerConfig(
            name="internlm2-20b-smoke", n_layers=2, d_model=48, n_heads=6,
            n_kv_heads=2, d_ff=128, vocab=256, rope_theta=1000000.0,
            q_chunk=16,
        ),
        microbatches={"train_4k": 2},
        parallelism="fsdp",
        source="arXiv:2403.17297",
    )
