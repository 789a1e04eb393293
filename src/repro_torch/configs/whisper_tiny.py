"""whisper-tiny [audio enc-dec]: 4L d_model=384 6H d_ff=1536 vocab=51865 —
conv frontend STUB (input_specs provides frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="whisper-tiny",
        family="encdec",
        model=EncDecConfig(
            name="whisper-tiny", n_layers=4, d_model=384, n_heads=6,
            n_kv_heads=6, d_ff=1536, vocab=51872,  # padded 51865
            q_chunk=512,
        ),
        smoke_model=EncDecConfig(
            name="whisper-smoke", n_layers=2, d_model=48, n_heads=3,
            n_kv_heads=3, d_ff=96, vocab=256, q_chunk=16,
        ),
        parallelism="fsdp",
        source="arXiv:2212.04356",
        notes="enc-dec: encoder runs over seq_len STUB frame embeddings; "
              "decoder is causal w/ cross-attention. vocab padded 51865->51872. "
              "6 heads replicated across TP (tiny model; MLP/vocab sharded).",
    )
