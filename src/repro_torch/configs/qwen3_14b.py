"""qwen3-14b — dense, qk_norm + GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.config.base import ModelConfig, register


@register("qwen3-14b")
def qwen3_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,          # GQA kv=8
        d_ff=17_408,
        vocab_size=151_936,
        qk_norm=True,            # qwen3 q/k RMSNorm
        activation="silu",
        norm="rms",
        ffn="gated",
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B",
    )
