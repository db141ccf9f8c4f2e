"""mamba2-130m — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060]
"""
from repro_torch.config.base import ModelConfig, register


@register("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        d_ff=0,                  # mamba2 block has no separate FFN
        vocab_size=50_280,
        ssm_state=128,           # N (SSD state size)
        ssm_expand=2,            # d_inner = 1536 -> 24 heads of 64
        ssm_chunk=128,
        conv_width=4,
        norm="rms",
        source="arXiv:2405.21060",
    )
