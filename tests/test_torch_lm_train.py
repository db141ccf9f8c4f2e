"""The port's LM training step held against the JAX package on the CPU,
for each of the ten assigned architectures at ``.smoke()`` size with
``dtype="float32"`` (grok-1, qwen1.5-110b and llama-3.2-vision keep
their bf16 parameters), from carried weights: one ProFe step (teacher,
then student distilling from the teacher's pre-update forward; a
partial prototype mask over the batch's domain tags) of the port's
``make_profe_step`` on a stack of one node against JAX's
``teacher_loss`` / ``student_loss`` (``remat=False``) under
``jax.value_and_grad``, ``clip_by_global_norm`` and the config's own
optimizer.  Also: the empty subtrees of every smoke teacher and student
(an LM stack's ``"rem": []``) through the plane and the tree codec,
``remat`` on and off bit for bit, and ``repro_torch.launch.train``.

Tolerances, each with its reason:

* losses within ``rtol=1e-5`` (summation order);
* gradients per leaf within ``1e-5 · max|g|`` of the leaf; a bf16 leaf
  within ``2^-7 · max|g|`` (each side rounds its fp32 gradient to bf16,
  one bf16 ulp, 2^-8 of the element, apart at most); an fp32 MoE router
  within ``5e-5 · max|g|``: its gradient is the difference of the
  softmax Jacobian's terms, some hundred times its size (measured: 1.6e-5
  on llama4-scout's, every other fp32 leaf of the ten configs within
  3.1e-6);
* the state after the step: fp32 parameters to ``atol=2e-5`` but for at
  most ``MAX_EPS_ELEMENTS`` elements a state in Adam's eps regime, each
  within ``atol + 2·lr`` (``tests/test_torch_baselines.py``); bf16
  parameters within ``2^-7 · (|x| + |Δx|)``, ``Δx`` the element's step
  in JAX: one bf16 ulp for the update's rounding, and one of the step,
  which moves by as much where the two packages' bf16 gradients round
  one ulp apart (adafactor normalizes the step, so a gradient ulp is a
  step ulp); an attention key bias within ``2·lr``: the softmax is
  invariant to it (every score moves by ``q·b``), so its exact gradient
  is 0 and both packages' are rounding noise, which adafactor scales up
  to a step of order lr (qwen1.5-110b: 8 of 128 elements 3.2e-5 apart);
  the moments to ``1e-6`` (first) and ``1e-8`` (second), adafactor's
  factors (of bf16 gradients in all three adafactor configs) within
  ``2^-6`` of the factor's largest (the squares of gradients within
  ``2^-7 · max|g|`` of each other), the step counters exactly.
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
from repro.core import distillation as JD
from repro.core import profe as JP
from repro.models import model as jm
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.checkpoint import load_checkpoint
from repro_torch.config import base as tbase
from repro_torch.configs import ASSIGNED
from repro_torch.core import profe as tprofe
from repro_torch.core.round_ops import quantize_dequantize_per_node
from repro_torch.data import make_token_dataset
from repro_torch.kernels.quantize import ops as Q
from repro_torch.launch import train as ttrain
from repro_torch.models import derive_student, init_params
from repro_torch.models import model as tm
from repro_torch.optim import make_optimizer
from repro_torch.optim.plane import as_tree, plane_from_tree
from repro_torch.tree import (tree_empties, tree_from_paths, tree_leaves,
                              tree_map, tree_paths)
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

B, S = 2, 16
LR = 1e-3
F32_GRAD = 1e-5
ROUTER_GRAD = 5e-5
BF16_GRAD = 2.0 ** -7
ATOL = 2e-5
# Adam's eps regime (tests/test_torch_baselines.py): where a clipped
# gradient element is itself near eps, the packages' gradient gap shifts
# its first step lr·g/(|g| + 1e-8).  llama4-scout's teacher has three
# such elements (pre-clip gradients 6e-8 to 1.2e-7 against leaf maxima
# of 0.5 and 1.1), each under 3e-5 apart
MAX_EPS_ELEMENTS = 4
MOE = ("grok-1-314b", "llama4-scout-17b-a16e")


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _a(x):
    if isinstance(x, torch.Tensor):
        # a copy: the port's states update in place
        return np.array(x.detach().float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(cfg, seed=0):
    """numpy ``{tokens, labels, domains[, image_embed | audio_embed]}``."""
    out = make_token_dataset(seed, B, S, cfg.vocab_size, cfg.n_proto_classes)
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "vlm":
        out["image_embed"] = (rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embed"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _protos(cfg):
    """Random global prototypes, classes 0-4 of 8 set."""
    rng = np.random.default_rng(7)
    mask = (np.arange(cfg.n_proto_classes) < 5).astype(np.float32)
    protos = rng.standard_normal((cfg.n_proto_classes, cfg.proto_dim)) \
        .astype(np.float32) * mask[:, None]
    return protos, mask


@functools.lru_cache(maxsize=None)
def _jax_step(arch: str):
    """JAX's step, spelled out from its own functions: the teacher's
    loss, gradients, clip and update, then the student's."""
    jcfg = jget(arch).smoke().replace(dtype="float32")
    scfg = jm.derive_student(jcfg)
    opt = jmake_optimizer(jcfg.optimizer, LR)
    st = JP.init_node_state(jcfg, scfg, jax.random.PRNGKey(0), opt, opt,
                            jcfg.n_proto_classes)
    protos, mask = _protos(jcfg)
    st = st._replace(global_protos=jnp.asarray(protos),
                     proto_mask=jnp.asarray(mask))
    fed = jbase.FederationConfig()
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def t_loss(tp):
        return JP.teacher_loss(jcfg, tp, jb, st.global_protos, st.proto_mask,
                               fed.beta_t, remat=False)
    (lt, tout), gt = jax.jit(jax.value_and_grad(t_loss, has_aux=True))(
        st.teacher)
    tout = jax.tree_util.tree_map(jax.lax.stop_gradient, tout)
    alpha = JD.alpha_at_round(fed.alpha_s, fed.alpha_limit, st.round_idx)

    def s_loss(sp):
        return JP.student_loss(scfg, sp, jb, st.global_protos,
                               st.proto_mask, alpha, fed.beta_s,
                               fed.kd_temperature, tout, remat=False)
    (ls, _), gs = jax.jit(jax.value_and_grad(s_loss, has_aux=True))(
        st.student)
    teacher, opt_t = opt.update(jclip(gt, 1.0)[0], st.opt_t, st.teacher)
    student, opt_s = opt.update(jclip(gs, 1.0)[0], st.opt_s, st.student)
    return {"jcfg": jcfg, "state": st, "batch": batch,
            "loss_t": float(lt), "loss_s": float(ls),
            "aux_t": float(tout.aux),
            "grad_t": _np(gt), "grad_s": _np(gs),
            "after": {"teacher": _np(teacher), "student": _np(student),
                      "opt_t": _np(opt_t), "opt_s": _np(opt_s)}}


def _carried(run):
    """JAX's initial node state as the port's, stacked as N = 1."""
    st = run["state"]
    return tprofe.stack_states([tprofe.node_state_from_numpy(
        _np(st.student), _np(st.teacher), _np(st.opt_s), _np(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask), 0,
        plane=False, device="cpu")])


def _port_step(arch: str, remat: bool = True):
    run = _jax_step(arch)
    jcfg = run["jcfg"]
    opt = make_optimizer(jcfg.optimizer, LR)
    step = tprofe.make_profe_step(_tcfg(jcfg), _tcfg(jm.derive_student(jcfg)),
                                  tbase.FederationConfig(), opt, opt,
                                  remat=remat)
    state = _carried(run)
    batch = {k: v[None] for k, v in _torch_batch(run["batch"]).items()}
    return step(state, batch, True)


@functools.lru_cache(maxsize=None)
def _port_run(arch: str):
    state, metrics = _port_step(arch)
    return {"state": state, "metrics": metrics}


def _port_grads(arch: str, which: str):
    """The port's gradients of one loss on the carried per-leaf trees."""
    run = _jax_step(arch)
    jcfg = run["jcfg"]
    st = run["state"]
    fed = tbase.FederationConfig()
    batch = _torch_batch(run["batch"])
    protos = torch.from_numpy(np.asarray(st.global_protos))
    mask = torch.from_numpy(np.asarray(st.proto_mask))
    teacher = tree_map(lambda x: x.requires_grad_(True),
                       tm.params_from_numpy(_np(st.teacher)))
    lt, tout = tprofe.teacher_loss(_tcfg(jcfg), teacher, batch, protos, mask,
                                   fed.beta_t, remat=True)
    if which == "teacher":
        return lt, teacher, torch.autograd.grad(lt, tree_leaves(teacher))
    student = tree_map(lambda x: x.requires_grad_(True),
                       tm.params_from_numpy(_np(st.student)))
    tout = tm.ModelOutput(tout.logits.detach(), tout.f1.detach(), tout.aux)
    ls, _ = tprofe.student_loss(
        _tcfg(jm.derive_student(jcfg)), student, batch, protos, mask,
        torch.tensor(float(JD.alpha_at_round(fed.alpha_s, fed.alpha_limit,
                                             0))),
        fed.beta_s, fed.kd_temperature, tout, remat=True)
    return ls, student, torch.autograd.grad(ls, tree_leaves(student),
                                            allow_unused=True)


# -- one ProFe step against JAX -----------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_profe_step_losses_match_jax(arch):
    """``loss_t`` and ``loss_s`` of the port's step (N = 1) against JAX's
    ``teacher_loss`` / ``student_loss``; for the MoE configs the router
    term ``aux · router_aux_weight`` is part of both."""
    run = _jax_step(arch)
    m = _port_run(arch)["metrics"]
    assert tuple(m["loss_t"].shape) == tuple(m["loss_s"].shape) == (1,)
    np.testing.assert_allclose(float(m["loss_t"][0]), run["loss_t"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["loss_s"][0]), run["loss_s"],
                               rtol=1e-5)
    if arch in MOE:
        assert run["aux_t"] > 0.0


@pytest.mark.parametrize("arch", MOE)
def test_moe_losses_carry_the_router_term(arch):
    """The MoE teacher's loss is Eq. 9 plus ``aux · router_aux_weight``,
    and that term moves the loss by more than the tolerance."""
    run = _jax_step(arch)
    lt, _, _ = _port_grads(arch, "teacher")
    term = run["aux_t"] * run["jcfg"].router_aux_weight
    assert term > 1e-4 * abs(run["loss_t"])
    np.testing.assert_allclose(float(lt), run["loss_t"], rtol=1e-5)


def _close_grads(jgrads, ttree, tgrads):
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(tgrads) == len(tree_leaves(ttree))
    for j, (path, p), g in zip(jl, tree_paths(ttree), tgrads):
        want = _a(j)
        got = np.zeros_like(want) if g is None else _a(g)
        assert want.shape == got.shape
        tol = BF16_GRAD if p.dtype == torch.bfloat16 else \
            ROUTER_GRAD if "router" in path else F32_GRAD
        scale = float(np.abs(want).max())
        err = float(np.abs(want - got).max())
        assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("which", ["teacher", "student"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_profe_gradients_match_jax(arch, which):
    """Every leaf's gradient of Eq. 9 (teacher) and Eq. 8 (student,
    distilling from the teacher's forward) against ``jax.value_and_grad``
    of JAX's losses; the port's with ``remat`` on."""
    run = _jax_step(arch)
    loss, tree, grads = _port_grads(arch, which)
    np.testing.assert_allclose(float(loss), run[f"loss_{which[0]}"],
                               rtol=1e-5)
    _close_grads(run[f"grad_{which[0]}"], tree, grads)


def _params_close(jtree, jbefore, ttree):
    """fp32 leaves to ATOL, but for MAX_EPS_ELEMENTS in Adam's eps regime
    (within ATOL + 2·lr); bf16 leaves within ``2^-7 · (|x| + |Δx|)``
    (``Δx`` JAX's step of the element), an attention key bias within
    2·lr."""
    beyond, gap = 0, 0.0
    for j, j0, (path, t) in zip(jax.tree_util.tree_leaves(jtree),
                                jax.tree_util.tree_leaves(jbefore),
                                tree_paths(ttree)):
        want, got = _a(j), _a(t[0])
        assert want.shape == got.shape
        err = np.abs(want - got)
        if path[-2:] == ("wk", "bias"):
            assert np.all(err <= 2 * LR), float(err.max())
            continue
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
    assert int(np.asarray(jopt["step"])) == int(topt["step"][0])
    for key in sorted(set(jopt) - {"step"}):
        jl = jax.tree_util.tree_leaves(jopt[key])
        tl = tree_leaves(topt[key])
        assert len(jl) == len(tl), key
        for j, t in zip(jl, tl):
            want, got = _a(j), _a(t[0])
            assert want.shape == got.shape
            if key == "v":           # adafactor's factored second moment
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-6 if key == "mu" else 1e-8)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_profe_step_state_matches_jax(arch):
    """The teacher, the student and both optimizer states after the
    port's step against JAX's clip and update of its own gradients."""
    run = _jax_step(arch)
    st = _port_run(arch)["state"]
    after = run["after"]
    _params_close(after["teacher"], run["state"].teacher, st.teacher)
    _params_close(after["student"], run["state"].student, st.student)
    _moments_close(after["opt_t"], st.opt_t)
    _moments_close(after["opt_s"], st.opt_s)
    assert st.student["stack"]["rem"] == after["student"]["stack"]["rem"]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_remat_is_bit_identical(arch):
    """``remat`` recomputes each period in the backward: the step's
    losses, parameters and moments are the same bits either way."""
    on_state, on_m = _port_step(arch, remat=True)
    off_state, off_m = _port_step(arch, remat=False)
    for key in ("loss_s", "loss_t", "grad_norm_s", "f1"):
        assert torch.equal(on_m[key], off_m[key]), key
    for a, b in zip(tree_leaves(on_state), tree_leaves(off_state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


# -- empty subtrees -----------------------------------------------------------

@pytest.mark.parametrize("tree", [
    {"a": torch.ones(2), "rem": []},
    {"scan": {"b0": {"w": torch.ones(3)}}, "rem": [], "z": {}},
    {"x": [[], torch.ones(1), {}]},
    [torch.ones(1), []],
    {}], ids=["rem", "nested", "in-list", "trailing", "root"])
def test_tree_from_paths_keeps_empty_subtrees(tree):
    """``tree_from_paths(tree_paths(t), tree_empties(t))`` is ``t``: its
    empty dicts and lists come back where they were, dict keys in
    flatten order."""
    back = tree_from_paths(tree_paths(tree), tree_empties(tree))
    assert _structure(back) == _structure(tree)
    assert tree_empties(back) == tree_empties(tree)


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", [(k, _structure(tree[k])) for k in sorted(tree)])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_structure(x) for x in tree])
    return "leaf" if tree is not None else None


def _smoke_tree(arch, which):
    cfg = tm.derive_student(_tcfg(jget(arch).smoke())) if which == "student" \
        else _tcfg(jget(arch).smoke())
    return init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("which", ["student", "teacher"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_plane_keeps_lm_structure(arch, which):
    """Every smoke model through the plane: ``as_tree`` gives the tree
    back whole (an LM stack's ``"rem": []`` included), each leaf's
    values as they were (fp32)."""
    tree = _smoke_tree(arch, which)
    assert tree["stack"]["rem"] == []
    back = as_tree(plane_from_tree(tree))
    assert _structure(back) == _structure(tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert torch.equal(a.float(), b)


@pytest.mark.parametrize("which", ["student", "teacher"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_tree_codec_keeps_lm_structure(arch, which):
    """Every smoke model through the tree codec: ``pack_tree`` /
    ``unpack_tree`` (bit for bit), ``pack_tree_nodes`` /
    ``unpack_tree_nodes`` on a stack of two, and the per-leaf wire's
    ``quantize_dequantize_per_node`` keep the tree whole."""
    tree = _smoke_tree(arch, which)
    buf, _, meta = Q.pack_tree(tree)
    back = Q.unpack_tree(buf, meta)
    assert _structure(back) == _structure(tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert torch.equal(a.float(), b)
    stacked = tree_map(lambda x: torch.stack([x, x]), tree)
    nbuf, _, nmeta = Q.pack_tree_nodes(stacked)
    assert _structure(Q.unpack_tree_nodes(nbuf, nmeta)) == \
        _structure(stacked)
    cfg = _tcfg(jget(arch).smoke())
    payload = {"protos": torch.zeros((2, 8, cfg.proto_dim)),
               "student": stacked}
    recv = quantize_dequantize_per_node(payload, spec=WireSpec.from_bits(16))
    assert _structure(recv["student"]) == _structure(stacked)


# -- the launcher -------------------------------------------------------------

def test_launch_train_runs_and_saves_a_loadable_student(tmp_path, capsys):
    """``main`` on the CPU: two steps of mamba2-130m's smoke config, the
    losses printed and finite, the student saved and loaded back into a
    fresh state's student bit for bit."""
    path = str(tmp_path / "student.npz")
    out = ttrain.main(["--arch", "mamba2-130m", "--steps", "2", "--batch",
                       "2", "--seq", "16", "--device", "cpu", "--checkpoint",
                       path])
    text = capsys.readouterr().out
    assert "step 0: loss_s=" in text and "step 1: loss_s=" in text
    assert "saved student" in text
    assert all(np.isfinite(out["loss_s"])) and all(np.isfinite(out["loss_t"]))
    like = ttrain.train_state(out["cfg"], seed=1, device="cpu").student
    back = load_checkpoint(path, like)
    assert _structure(back) == _structure(out["state"].student)
    for a, b in zip(tree_leaves(back), tree_leaves(out["state"].student)):
        assert torch.equal(a, b.detach())


def test_launch_train_layers_cut_and_student_moves():
    """``--layers`` cuts the teacher's depth (the student derives from
    the cut teacher); one step changes the student."""
    cfg = tbase.get_config("yi-6b").smoke().replace(num_layers=1)
    state = ttrain.train_state(cfg, device="cpu")
    assert tree_leaves(state.teacher["stack"]["scan"])[0].shape[:2] == (1, 1)
    before = [x.detach().clone() for x in tree_leaves(state.student)]
    out = ttrain.train(cfg, state, steps=1, batch=2, seq=8, verbose=False)
    after = tree_leaves(out["state"].student)
    assert any(not torch.equal(a, b.detach()) for a, b in zip(before, after))
    assert np.isnan(out["step_ms"]) and out["peak_bytes"] is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_launch_train_needs_a_card_unless_told():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "yi-6b", "--steps", "1"])
    with pytest.raises(SystemExit):
        ttrain.parse_args(["--arch", "yi-6b", "--steps", "0"])
