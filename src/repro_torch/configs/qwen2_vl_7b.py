"""qwen2-vl-7b [vlm]: qwen2-7b backbone + M-RoPE; vision tower STUB
(input_specs provides M-RoPE position ids).  [arXiv:2409.12191; hf]"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen2-vl-7b",
        family="vlm",
        model=TransformerConfig(
            name="qwen2-vl-7b", n_layers=28, d_model=3584, n_heads=28,
            n_kv_heads=4, d_ff=18944, vocab=152064, qkv_bias=True,
            mrope_sections=(16, 24, 24),  # t/h/w splits of hd/2 = 64
            rope_theta=1000000.0, q_chunk=512, act_dtype=torch.bfloat16,
        ),
        smoke_model=TransformerConfig(
            name="qwen2-vl-smoke", n_layers=2, d_model=56, n_heads=7,
            n_kv_heads=1, d_ff=144, vocab=256, qkv_bias=True,
            mrope_sections=(2, 1, 1), q_chunk=16,  # hd/2 = 4
        ),
        microbatches={"train_4k": 2},
        parallelism="fsdp",
        source="arXiv:2409.12191",
        notes="M-RoPE exercised with stub 3D position ids; patch tokens flow "
              "through the ordinary embedding table (frontend stubbed).",
    )
