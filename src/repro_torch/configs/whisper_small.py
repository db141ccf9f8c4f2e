"""whisper-small — enc-dec audio; conv/mel frontend is a stub
(``input_specs`` provides precomputed frame embeddings).  [arXiv:2212.04356]
"""
from repro_torch.config.base import ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,           # decoder layers (self+cross every layer)
        d_model=768,
        num_heads=12,
        num_kv_heads=12,         # MHA (kv=12)
        d_ff=3072,
        vocab_size=51_865,
        encoder_layers=12,
        encoder_seq=1500,        # 30 s of 10 ms mel frames after conv stride 2
        activation="gelu",
        norm="ln",
        ffn="mlp",
        source="arXiv:2212.04356",
    )
