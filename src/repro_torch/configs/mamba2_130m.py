"""mamba2-130m [ssm]: 24L d_model=768 attn-free vocab=50280 ssm_state=128 —
SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.ssm_lm import SSMConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        arch_id="mamba2-130m",
        family="ssm",
        model=SSMConfig(
            name="mamba2-130m", n_layers=24, d_model=768, vocab=50288,
            d_state=128, head_dim=64, expand=2, chunk=128,  # vocab padded
        ),
        smoke_model=SSMConfig(
            name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
            d_state=16, head_dim=16, expand=2, chunk=16,
        ),
        sub_quadratic=True,
        parallelism="fsdp_tp",
        source="arXiv:2405.21060",
        notes="vocab padded 50280 -> 50288; decode state is O(1) in context "
              "so decode_32k/long_500k lower with constant-size SSM state.",
    )
