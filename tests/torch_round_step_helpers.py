"""The shared helpers of the round-step microbenchmark tests
(tests/test_torch_round_step*.py).

The port of the round-step microbenchmark
(``benchmarks/torch_round_step.py``) held against the JAX script
(``benchmarks/round_step.py``) on the CPU.

* ``legacy_round``, the seed's per-node loop, one round at N = 2 against
  the JAX script's own ``legacy_round``, both from the JAX script's
  seeded states (carried with ``core/profe.node_state_from_numpy``) on
  the JAX script's data (equal bytes) and its reduced mnist-cnn, in
  float32 (the scripts' bfloat16 activations round at other places in
  the two frameworks).  Students to ``atol=2e-5`` but for at most
  ``MAX_EPS_ELEMENTS`` parameters in Adam's eps regime, each within
  ``atol + 2·lr`` (``tests/test_torch_loop_engine.py``); the Eq. 4
  prototypes to ``1e-4`` (JAX sums Eq. 3 as a one-hot einsum, the port
  as ``proto_accum`` batches: fp32 sums in other orders); the masks
  exactly.
* The stacked round as the script wires it (the plane, the fused sweep,
  the packed codec) against the port's own ``legacy_round`` after one
  round from the same seeded states: the tolerances above (the stacked
  mix sums its senders in one tensordot, the loop one after another),
  Adam's moments ``1e-6`` / ``1e-8``, step counters exactly.
* ``main`` at N = 2 with ``--phases`` writes exactly the JAX script's
  keys, read from its source (``measure``'s and ``measure_phases``'
  dicts), and ``local_steps_per_round`` is the JAX ``_setup``'s count.
* One spawn of 4 gloo ranks for ``--wire`` at ``16``, ``4/16+ef`` and
  ``4+adapters8``: the ``ppermute``, ``packed`` and full-gather bytes
  equal the JAX package's (``repro.launch.wire.measure_exchange_bytes``,
  as ``tests/test_torch_dryrun.py`` obtains them), and every exchange
  has a ``round_ms``.
* Every flag of the JAX parser with its default (read from the JAX
  script's source), ``--out`` excepted (the port's own report name); the
  JAX report names refused; no card and no ``--device cpu`` raises.
"""
import ast
import sys
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import torch_round_step as S  # noqa: E402
from repro.optim import plane as jplane  # noqa: E402
from repro_torch.core import profe as tprofe  # noqa: E402

torch.set_num_threads(2)

N = 2
SAMPLES, BATCH = 32, 8          # the JAX script's defaults
ATOL = 2e-5
PROTO_ATOL = 1e-4
MAX_EPS_ELEMENTS = 2
LR = 1e-3                       # the script's TrainConfig learning rate
JAX_SRC = (ROOT / "benchmarks" / "round_step.py").read_text()


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _f32(cfg):
    return cfg.replace(dtype="float32")


def _carry(st):
    return tprofe.stack_states([tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), plane=False, device="cpu")])


def _assert_students_close(got, want, atol=ATOL):
    """``got`` / ``want``: per node, the student's leaves as numpy."""
    beyond, gap = 0, 0.0
    for t_leaves, j_leaves in zip(got, want):
        assert len(t_leaves) == len(j_leaves) > 0
        for a, b in zip(t_leaves, j_leaves):
            d = np.abs(a.reshape(b.shape) - b)
            beyond += int(np.count_nonzero(d > atol))
            gap = max(gap, float(d.max(initial=0.0)))
    assert beyond <= MAX_EPS_ELEMENTS and gap <= atol + 2 * LR, (beyond, gap)


def _port_setup():
    cfg, fed, train, node_data = S._setup(N, SAMPLES, BATCH)
    return _f32(cfg), fed, train, node_data


def _dict_keys(func: str) -> set:
    """The string keys of every dict literal in the JAX script's
    ``func``."""
    fn = next(n for n in ast.walk(ast.parse(JAX_SRC))
              if isinstance(n, ast.FunctionDef) and n.name == func)
    return {k.value for d in ast.walk(fn) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}


def _jax_flags() -> dict:
    fn = next(n for n in ast.walk(ast.parse(JAX_SRC))
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for call in ast.walk(fn):
        if isinstance(call, ast.Call) and getattr(
                call.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in call.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw \
                else (False if "action" in kw else None)
            flags[call.args[0].value] = default
    return flags
