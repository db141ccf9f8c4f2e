"""The port's microbatched ProFe train program against the JAX package's on
the CPU for grok-1 (MoE, bf16 parameters: the router term and bf16
accumulation) at 1, 2 and 4 microbatches.

The helpers and the tolerances, with their reasons, are in
``tests/torch_programs_helpers.py``.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.tree import tree_leaves

from torch_programs_helpers import (ARCHS, MICRO, _initial, _port_step,
                                    check_train_program)

torch.set_num_threads(2)

# this file's architectures, in ARCHS's order
FILE_ARCHS = tuple(a for a in ARCHS if a in ("grok-1-314b",))


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("arch", FILE_ARCHS)
def test_train_program_matches_jax(arch, m):
    """One step of the port's program against JAX's: the losses, α, the
    teacher, the student and both optimizer states."""
    check_train_program(arch, m)


def test_grok_accumulates_in_bf16():
    """grok-1's parameters are bf16: the program's gradient sums stay
    in bf16, as the JAX package's do."""
    _, st, _ = _initial("grok-1-314b")
    assert any(x.dtype == jnp.bfloat16
               for x in jax.tree_util.tree_leaves(st.teacher))
    state, _ = _port_step("grok-1-314b", 2)
    assert any(x.dtype == torch.bfloat16 for x in tree_leaves(state.teacher))
