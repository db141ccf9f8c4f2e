"""The port's microbatched ProFe train program
(``repro_torch.launch.programs.make_profe_train_fn``) held against the
JAX package's (``repro.launch.programs.make_profe_train_fn``, jitted, on
the CPU) on the smoke configs of yi-6b (dense), grok-1 (MoE, bf16
parameters: the router term and bf16 accumulation), mamba2-130m (SSM)
and whisper-small (audio), ``dtype="float32"``, at ``microbatches`` 1, 2
and 4, one step from carried weights on a batch of 4 sequences.

Tolerances, those of ``tests/test_torch_lm_train.py`` and for its
reasons: losses within ``rtol=1e-5``; the state after the step with fp32
parameters to ``ATOL`` but for at most ``MAX_EPS_ELEMENTS`` elements in
Adam's eps regime (each within ``ATOL + 2·lr``), bf16 parameters within
``2^-7 · (|x| + |Δx|)``; moments to 1e-6 (first) and 1e-8 (second),
adafactor's factors within ``2^-6`` of their largest, step counters
exactly.  The accumulated gradient sums the same microbatch gradients
in the same order on both sides, so the bounds of one step hold.

In the port alone, m = 4 against m = 1 on yi-6b with every prototype
class present (each microbatch's loss is then the mean over its rows,
and the mean of the four means is the batch's): the losses and the
gradient norm within ``rtol=1e-5``, the parameters as above — the two
differ only by reassociation (four fp32 partial sums added in turn
against one reduction over the batch).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.config import get_config as jget
from repro.core import profe as JP
from repro.launch.programs import make_profe_train_fn as jmake
from repro.models import model as jm
from repro_torch.config import base as tbase
from repro_torch.core import profe as tprofe
from repro_torch.data import make_token_dataset
from repro_torch.launch.programs import make_profe_train_fn
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(2)

ARCHS = ("yi-6b", "grok-1-314b", "mamba2-130m", "whisper-small")
MICRO = (1, 2, 4)
B, S = 4, 16
LR = 1e-3
ATOL = 2e-5
MAX_EPS_ELEMENTS = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _a(x):
    if isinstance(x, torch.Tensor):
        return np.array(x.detach().float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jcfg(arch):
    return jget(arch).smoke().replace(dtype="float32")


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _batch(cfg):
    out = make_token_dataset(0, B, S, cfg.vocab_size, cfg.n_proto_classes)
    rng = np.random.default_rng(1)
    if cfg.family == "audio":
        out["audio_embed"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _protos(cfg, full: bool):
    """Random global prototypes: classes 0-4 of 8 set, or all."""
    rng = np.random.default_rng(7)
    mask = np.ones(cfg.n_proto_classes, np.float32) if full else \
        (np.arange(cfg.n_proto_classes) < 5).astype(np.float32)
    protos = rng.standard_normal((cfg.n_proto_classes, cfg.proto_dim)) \
        .astype(np.float32) * mask[:, None]
    return protos, mask


def _train(m, optimizer, package):
    cls = jbase.TrainConfig if package == "jax" else tbase.TrainConfig
    # JAX's remat recomputes the same math; its compile is longer
    return cls(learning_rate=LR, optimizer=optimizer, microbatches=m,
               remat=package != "jax")


@functools.lru_cache(maxsize=None)
def _initial(arch: str, full: bool = False):
    jcfg = _jcfg(arch)
    scfg = jm.derive_student(jcfg)
    _, (opt_s, opt_t) = jmake(jcfg, scfg, jbase.FederationConfig(),
                              _train(1, jcfg.optimizer, "jax"))
    st = JP.init_node_state(jcfg, scfg, jax.random.PRNGKey(0), opt_s, opt_t,
                            jcfg.n_proto_classes)
    protos, mask = _protos(jcfg, full)
    return jcfg, st._replace(global_protos=jnp.asarray(protos),
                             proto_mask=jnp.asarray(mask)), _batch(jcfg)


@functools.lru_cache(maxsize=None)
def _jax_step(arch: str, m: int):
    jcfg, st, batch = _initial(arch)
    step, _ = jmake(jcfg, jm.derive_student(jcfg), jbase.FederationConfig(),
                    _train(m, jcfg.optimizer, "jax"))
    new, metrics = jax.jit(step)(st, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    return _np(new), {k: float(v) for k, v in metrics.items()}


def _port_step(arch: str, m: int, full: bool = False):
    jcfg, st, batch = _initial(arch, full)
    state = tprofe.node_state_from_numpy(
        _np(st.student), _np(st.teacher), _np(st.opt_s), _np(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask), 0,
        plane=False, device="cpu")
    step, _ = make_profe_train_fn(_tcfg(jcfg), _tcfg(jm.derive_student(jcfg)),
                                  tbase.FederationConfig(),
                                  _train(m, jcfg.optimizer, "torch"))
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    return step(state, tb)


def _params_close(jtree, jbefore, ttree):
    """fp32 leaves to ATOL but for MAX_EPS_ELEMENTS (within ATOL +
    2·lr); bf16 leaves within ``2^-7 · (|x| + |Δx|)``."""
    beyond, gap = 0, 0.0
    for j, j0, (_, t) in zip(jax.tree_util.tree_leaves(jtree),
                             jax.tree_util.tree_leaves(jbefore),
                             tree_paths(ttree)):
        want, got = _a(j), _a(t)
        assert want.shape == got.shape
        err = np.abs(want - got)
        if t.dtype == torch.bfloat16:
            ulp = (np.abs(want) + np.abs(want - _a(j0))) * 2.0 ** -7
            assert np.all(err <= ulp), float(np.max(err - ulp))
            continue
        over = err[err > ATOL]
        beyond += over.size
        gap = max(gap, float(over.max(initial=0.0)))
    assert beyond <= MAX_EPS_ELEMENTS and gap <= ATOL + 2 * LR, (beyond, gap)


def _moments_close(jopt, topt):
    assert set(jopt) == set(topt)
    assert int(np.asarray(jopt["step"])) == int(topt["step"])
    for key in sorted(set(jopt) - {"step"}):
        jl = jax.tree_util.tree_leaves(jopt[key])
        tl = tree_leaves(topt[key])
        assert len(jl) == len(tl), key
        for j, t in zip(jl, tl):
            want, got = _a(j), _a(t)
            if key == "v":
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-6 if key == "mu" else 1e-8)


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_program_matches_jax(arch, m):
    """One step of the port's program against JAX's: the losses, α, the
    teacher, the student and both optimizer states."""
    jnew, jmet = _jax_step(arch, m)
    state, met = _port_step(arch, m)
    for key in ("loss_s", "loss_t"):
        np.testing.assert_allclose(float(met[key]), jmet[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(float(met["grad_norm_s"]),
                               jmet["grad_norm_s"], rtol=1e-4)
    assert float(met["alpha"]) == jmet["alpha"]
    before = _initial(arch)[1]
    _params_close(jnew.teacher, _np(before.teacher), state.teacher)
    _params_close(jnew.student, _np(before.student), state.student)
    _moments_close(jnew.opt_t, state.opt_t)
    _moments_close(jnew.opt_s, state.opt_s)


def test_grok_accumulates_in_bf16():
    """grok-1's parameters are bf16: the program's gradient sums stay
    in bf16, as the JAX package's do."""
    _, st, _ = _initial("grok-1-314b")
    assert any(x.dtype == jnp.bfloat16
               for x in jax.tree_util.tree_leaves(st.teacher))
    state, _ = _port_step("grok-1-314b", 2)
    assert any(x.dtype == torch.bfloat16 for x in tree_leaves(state.teacher))


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
