from repro_torch.models.model import (
    ModelOutput,
    derive_student,
    forward,
    init_params,
    params_from_numpy,
)

__all__ = ["ModelOutput", "derive_student", "forward", "init_params",
           "params_from_numpy"]
