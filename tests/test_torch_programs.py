"""The port's microbatched ProFe train program against the JAX package's on
the CPU, for yi-6b (dense) and mamba2-130m (SSM) at 1, 2 and 4
microbatches; microbatches against one batch, an indivisible batch,
and ``chip_smoke.py``'s programs phase on the CPU.

The helpers and the tolerances, with their reasons, are in
``tests/torch_programs_helpers.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.tree import tree_leaves

from torch_programs_helpers import (ARCHS, MICRO, _a, _params_close,
                                    _port_step, check_train_program)

torch.set_num_threads(2)

# this file's architectures, in ARCHS's order
FILE_ARCHS = tuple(a for a in ARCHS if a in ("yi-6b", "mamba2-130m"))


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("arch", FILE_ARCHS)
def test_train_program_matches_jax(arch, m):
    """One step of the port's program against JAX's: the losses, α, the
    teacher, the student and both optimizer states."""
    check_train_program(arch, m)


def test_microbatches_match_one_batch():
    """yi-6b, every prototype class present: m = 4 against m = 1 on the
    same batch (see the module docstring)."""
    one_state, one = _port_step("yi-6b", 1, full=True)
    four_state, four = _port_step("yi-6b", 4, full=True)
    for key in ("loss_s", "loss_t", "grad_norm_s"):
        np.testing.assert_allclose(float(four[key]), float(one[key]),
                                   rtol=1e-5, err_msg=key)
    for which in ("teacher", "student"):
        ref = [_a(x) for x in tree_leaves(getattr(one_state, which))]
        _params_close(ref, ref, getattr(four_state, which))


@pytest.mark.parametrize("m", [3, 8])
def test_indivisible_batch_raises(m):
    """A batch of 4 that m does not divide raises ``ValueError``."""
    with pytest.raises(ValueError, match="does not divide"):
        _port_step("yi-6b", m)


def test_chip_smoke_programs_phase_on_cpu(capsys):
    """``chip_smoke.py``'s programs phase on the CPU at smoke size: the
    4-microbatch step against the 1-microbatch one, then the (batch,
    microbatches) runs and their ``programs {...}`` line."""
    import importlib.util
    import json
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.run_programs(torch, "cpu", device="cpu", full_smoke=True)
    out = capsys.readouterr().out
    line = json.loads(out.split("programs ")[-1])
    assert [(r["batch"], r["microbatches"]) for r in line["runs"]] == \
        list(smoke.PROGRAM_RUNS)
    assert all(np.isfinite(r["losses"]).all() for r in line["runs"])
