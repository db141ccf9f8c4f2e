"""The port's microbatched ProFe train program against the JAX package's on
the CPU for whisper-small (audio) at 1, 2 and 4 microbatches.

The helpers and the tolerances, with their reasons, are in
``tests/torch_programs_helpers.py``.
"""
import pytest
import torch

from torch_programs_helpers import ARCHS, MICRO, check_train_program

torch.set_num_threads(2)

# this file's architectures, in ARCHS's order
FILE_ARCHS = tuple(a for a in ARCHS if a in ("whisper-small",))


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("arch", FILE_ARCHS)
def test_train_program_matches_jax(arch, m):
    """One step of the port's program against JAX's: the losses, α, the
    teacher, the student and both optimizer states."""
    check_train_program(arch, m)
