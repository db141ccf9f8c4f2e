"""recurrentgemma-9b — hybrid RG-LRU + local attention, 2 recurrent : 1
attention (Griffin pattern).  [arXiv:2402.19427]
"""
from repro_torch.config.base import ModelConfig, register


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,           # 12x(rec,rec,attn) + (rec,rec)
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,          # MQA (kv=1)
        d_ff=12_288,
        vocab_size=256_000,
        block_pattern=("rec", "rec", "attn"),
        local_window=2048,       # local attention window
        activation="gelu",
        norm="rms",
        ffn="gated",
        source="arXiv:2402.19427",
    )
