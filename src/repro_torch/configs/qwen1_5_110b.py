"""qwen1.5-110b — dense, QKV bias.  [hf:Qwen/Qwen1.5-0.5B (family card)]"""
from repro_torch.config.base import ModelConfig, register


@register("qwen1.5-110b")
def qwen1_5_110b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,          # GQA kv=8
        d_ff=49_152,
        vocab_size=152_064,
        qkv_bias=True,           # qwen1.5 QKV bias
        activation="silu",
        norm="rms",
        ffn="gated",
        rope_theta=1_000_000.0,
        optimizer="adafactor",
        param_dtype="bfloat16",
        source="hf:Qwen/Qwen1.5-0.5B",
    )
