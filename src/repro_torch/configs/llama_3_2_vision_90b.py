"""llama-3.2-vision-90b — VLM with cross-attention image layers every 5th
layer; the ViT encoder + projector is a stub (``input_specs`` provides
patch embeddings).  [hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.config.base import ModelConfig, register


@register("llama-3.2-vision-90b")
def llama32_vision_90b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,          # 80 self-attn + 20 cross-attn
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,          # GQA kv=8
        d_ff=28_672,
        vocab_size=128_256,
        cross_attn_every=5,      # cross-attn image layer every 5th
        num_image_tokens=1600,   # stubbed ViT patch embeddings
        activation="silu",
        norm="rms",
        ffn="gated",
        rope_theta=500_000.0,
        optimizer="adafactor",
        param_dtype="bfloat16",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
