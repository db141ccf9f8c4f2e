from repro_torch.models.model import (
    ModelOutput,
    build_memory,
    decode_step,
    derive_student,
    forward,
    init_cache,
    init_params,
    param_bytes,
    param_count,
    params_from_numpy,
    prefill,
)

__all__ = [
    "ModelOutput", "build_memory", "decode_step", "derive_student",
    "forward", "init_cache", "init_params", "param_bytes", "param_count",
    "params_from_numpy", "prefill",
]
