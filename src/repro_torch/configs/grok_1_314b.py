"""grok-1-314b — MoE, 8 experts top-2.  [hf:xai-org/grok-1]"""
from repro_torch.config.base import ModelConfig, register


@register("grok-1-314b")
def grok_1() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,          # GQA kv=8
        d_ff=32_768,
        vocab_size=131_072,
        num_experts=8,           # 8 experts, top-2
        num_experts_per_tok=2,
        activation="gelu",
        norm="rms",
        ffn="gated",
        optimizer="adafactor",
        param_dtype="bfloat16",  # 314B: fp32 master does not fit 256x16GB
        source="hf:xai-org/grok-1",
    )
