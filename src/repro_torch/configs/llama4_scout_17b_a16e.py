"""llama4-scout-17b-a16e — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.config.base import ModelConfig, register


@register("llama4-scout-17b-a16e")
def llama4_scout() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,          # GQA kv=8
        d_ff=8192,
        vocab_size=202_048,
        num_experts=16,          # MoE 16e top-1
        num_experts_per_tok=1,
        activation="silu",
        norm="rms",
        ffn="gated",
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
