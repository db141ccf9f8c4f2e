"""yi-6b — llama-architecture dense GQA.  [arXiv:2403.04652]"""
from repro_torch.config.base import ModelConfig, register


@register("yi-6b")
def yi_6b() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,          # GQA kv=4
        d_ff=11_008,
        vocab_size=64_000,
        activation="silu",
        norm="rms",
        ffn="gated",
        rope_theta=5_000_000.0,
        source="arXiv:2403.04652",
    )
