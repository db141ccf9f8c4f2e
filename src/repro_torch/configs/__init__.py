"""Architecture registry — importing this package registers every config
the port serves: the assigned pool (10 archs, 6 families) and the
paper's own models.
"""
from repro_torch.configs import (  # noqa: F401
    grok_1_314b,
    llama4_scout_17b_a16e,
    llama_3_2_vision_90b,
    mamba2_130m,
    paper_models,
    qwen1_5_110b,
    qwen3_14b,
    recurrentgemma_9b,
    starcoder2_15b,
    whisper_small,
    yi_6b,
)

ASSIGNED = (
    "llama4-scout-17b-a16e",
    "qwen3-14b",
    "whisper-small",
    "starcoder2-15b",
    "qwen1.5-110b",
    "recurrentgemma-9b",
    "grok-1-314b",
    "yi-6b",
    "mamba2-130m",
    "llama-3.2-vision-90b",
)
PAPER = ("mnist-cnn", "cifar10-resnet18", "cifar100-resnet32")
