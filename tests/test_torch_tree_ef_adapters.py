"""Whole runs of the adapter wire with error feedback (``adapters8+ef`` and
``adapters8+grams+ef``) in the port against the JAX package on the CPU,
on both engines.

The helpers and the tolerances, with their reasons, are in
``tests/torch_tree_ef_helpers.py``.
"""
import pytest
import torch

from torch_tree_ef_helpers import RUNS, check_run

torch.set_num_threads(2)

RUN_NAMES = tuple(k for k in RUNS if "per-leaf" not in k)


@pytest.mark.parametrize("engine", ["stacked", "loop"])
@pytest.mark.parametrize("name", list(RUN_NAMES))
def test_run_matches_jax(name, engine, monkeypatch):
    check_run(name, engine, monkeypatch)
