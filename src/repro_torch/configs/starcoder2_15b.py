"""starcoder2-15b — dense, GQA + RoPE, LayerNorm/GELU MLP.  [arXiv:2402.19173]"""
from repro_torch.config.base import ModelConfig, register


@register("starcoder2-15b")
def starcoder2_15b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,          # GQA kv=4
        d_ff=24_576,
        vocab_size=49_152,
        activation="gelu",
        norm="ln",
        ffn="mlp",
        qkv_bias=True,           # starcoder2 uses bias
        rope_theta=100_000.0,
        source="arXiv:2402.19173",
    )
