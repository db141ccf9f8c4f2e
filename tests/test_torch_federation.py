"""The port's slice against the JAX package on the CPU: 2-round
``run_federation`` runs of the ResNet pair from carried states, the plane
mode's resolution, the full-width byte accounting, the options outside
the slice, the entry points' device rule, the import rule and
``chip_smoke.py``'s refusals.

The helpers and the tolerances, with their reasons, are in
``tests/torch_federation_helpers.py``.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import comm as jcomm
from repro.core import federation as JF
from repro.core import quantization as jquant
from repro.core import topology as jtopo
from repro.core import wire_state as jwire_state
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.models import init_params
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim.plane import plane_from_tree
from repro_torch.tree import tree_leaves
from repro_torch.wirespec import WireSpec

from torch_federation_helpers import (N_NODES, RESNET_RUN_ATOL, ROOT, _carry,
                                      _chip_smoke_module, _imports,
                                      _jax_states, _recording, _resnet_setup,
                                      _setup)

torch.set_num_threads(2)


@pytest.mark.parametrize("optimizer", ["sgd", "adafactor"])
def test_run_federation_resnet_matches_jax_from_carried_states(optimizer,
                                                               monkeypatch):
    """A tiny ResNet federation under the sgd / adafactor plane and
    per-leaf optimizers: ``run_federation`` of both packages from the
    same carried states (JAX's own ``_init_states``, carried through
    numpy).  Bytes exactly; every round's staged inputs byte-identical;
    after each round the state to ``RESNET_RUN_ATOL``, prototypes to
    ``atol=1e-4``, masks and counters exactly; F1 and accuracy exactly."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = \
        _resnet_setup(optimizer)
    jcalls, tcalls = [], []
    monkeypatch.setattr(JF, "_make_round_fn", _recording(
        JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_make_round_fn", _recording(
        TF._make_round_fn, tcalls, tree_leaves))
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
    assert jres.extras["param_plane"] is True
    scfg = jmodel.derive_student(jcfg)
    opt_s = jplane.make_plane_optimizer(optimizer, jtrain.learning_rate,
                                        weight_decay=jtrain.weight_decay,
                                        momentum=jtrain.momentum,
                                        grad_clip=jtrain.grad_clip)
    opt_t = jmake_optimizer(optimizer, jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay,
                            momentum=jtrain.momentum)
    jstates = JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                              plane=True)
    tres = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             initial_states=[_carry(s) for s in jstates],
                             device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    assert tres.comm.summary() == jres.comm.summary()
    assert len(tcalls) == len(jcalls) == 2
    s_atol, t_atol, m_atol = RESNET_RUN_ATOL[optimizer]
    for t, j in zip(tcalls, jcalls):
        assert t["flags"] == j["flags"]
        for a, b in zip(t["inputs"], j["inputs"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        t, j = t["state"], j["state"]
        np.testing.assert_allclose(t["student"], j["student"], rtol=0,
                                   atol=s_atol)
        assert len(t["teacher"]) == len(j["teacher"]) == 32
        for a, b in zip(t["teacher"], j["teacher"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=t_atol)
        for key in ("opt_s", "opt_t"):
            assert len(t[key]) == len(j[key]) > 0
            for a, b in zip(t[key], j[key]):
                np.testing.assert_allclose(a, b, rtol=0, atol=m_atol)
        np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                                   rtol=0, atol=1e-4)
        assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
        assert t["round_idx"] == j["round_idx"]
        assert t["steps"] == j["steps"]
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round


@pytest.mark.parametrize("optimizer", ["sgd", "adamw", "adafactor", "lion"])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_param_plane_resolves_like_jax(mode, optimizer, param_dtype):
    """``param_plane`` resolves as ``repro``'s ``_plane_mode``: the plane
    for the profe student under sgd / adamw / adafactor with fp32
    parameters; ``"on"`` raises ValueError otherwise."""
    jcfg = jmodel.derive_student(jbase.get_config("mnist-cnn").replace(
        param_dtype=param_dtype))
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    out = []
    for pkg, cfg, fed, train in (
            (JF, jcfg, jbase.FederationConfig(param_plane=mode),
             jbase.TrainConfig(optimizer=optimizer)),
            (TF, tcfg, tbase.FederationConfig(param_plane=mode),
             tbase.TrainConfig(optimizer=optimizer))):
        try:
            out.append(pkg._plane_mode(fed, train, "profe", cfg))
        except ValueError as e:
            out.append(type(e))
    assert out[0] == out[1]


@pytest.mark.parametrize("wire,rounds", [
    ("16", 2), ("4/16+ef", 2), ("4/16", 1), ("cifar10/sgd", 2),
    ("cifar10/adafactor", 1), ("adapters8", 2), ("adapters8+grams", 1)])
def test_run_federation_full_width_bytes_match_jax_accounting(wire, rounds):
    """The 20-node wire numbers chip_smoke.py holds the card runs to, for
    each of its paths (``wire`` names the path): the port's accountants
    and the JAX package's, from the same payload template shapes of the
    path's full-width student, equal each other and the script's
    constants — for the mnist-cnn 16-bit main path, the 4/16 wire (whose
    bytes +ef leaves unchanged), the cifar10-resnet18 paths (the ResNet8
    student on the 16-bit wire), and the adapter-rank wire at rank 8 on
    the int4 wire, naive and with grams (conv2, fc1 and fc2 travel as
    factors), over each path's rounds."""
    smoke = _chip_smoke_module()
    n = smoke.N_NODES
    model, _, wire_arg, smoke_rounds, want = smoke.PATHS[wire]
    assert smoke_rounds == rounds
    jspec, tspec = JWireSpec.parse(wire_arg), WireSpec.parse(wire_arg)
    # the script's FederationConfig fields make the spec it names
    extra = smoke.PATH_FED.get(wire, {})
    fed = tbase.FederationConfig(**smoke.wire_fields(tspec), **extra)
    assert WireSpec(student_bits=fed.quantize_bits,
                    proto_bits=fed.proto_quantize_bits,
                    error_feedback=fed.error_feedback) == tspec
    assert tspec.describe() == jspec.describe() == {
        "16": "int16", "4": "int4", "4/16": "student=int4,protos=int16",
        "4/16+ef": "student=int4,protos=int16+ef"}[wire_arg]
    cfg = tbase.get_config(model)
    student = plane_from_tree(init_params(TF.derive_student(cfg),
                                          torch.Generator().manual_seed(0)))
    state = tprofe.NodeState(student, None, None, None, None, None, None)
    ncls, pdim = cfg.num_classes, cfg.proto_dim
    tpay = TF._payload_template("student", True, state, ncls, pdim,
                                adapter_rank=fed.adapter_rank,
                                adapter_grams=fed.adapter_grams)
    tmeter = TF.ScheduleCommAccountant(ttopo.make_schedule(n, "full",
                                                           rounds=rounds))
    for r in range(rounds):
        tmeter.record_round(tpay, "profe", r, tspec)

    jscfg = jmodel.derive_student(jbase.get_config(model))
    jpay = {"model": jax.eval_shape(lambda: jmodel.init_params(
        jscfg, jax.random.PRNGKey(0))),
        "protos": jax.ShapeDtypeStruct((ncls, pdim), np.dtype(np.float32)),
        "counts": jax.ShapeDtypeStruct((ncls,), np.dtype(np.float32))}
    if fed.adapter_rank:
        # the matrix leaves leave "model" and meter as their factors
        from repro.core import adapters as jadapters
        layout = jadapters.adapter_layout(jpay["model"], fed.adapter_rank)
        jpay.update(jadapters.adapter_payload_template(
            layout, grams=fed.adapter_grams))
        jpay["model"] = jadapters.split_student(layout, jpay["model"])[1]
        assert layout.mat_names == ("['conv2']['kernel']",
                                    "['fc1']['kernel']", "['fc2']['kernel']")
    assert [tuple(x.shape) for x in tree_leaves(tpay)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jpay)]
    jmeter = jcomm.ScheduleCommAccountant(jtopo.make_schedule(
        n, "full", rounds=rounds))
    for r in range(rounds):
        jmeter.record_round(jpay, "profe", r, jspec)

    assert tmeter.avg_sent_gb() == jmeter.avg_sent_gb() == want[0]
    assert TF.packed_copy_bytes(tpay, tspec) == \
        jcomm.packed_copy_bytes(jpay, jspec) == want[1]
    assert TF.tree_wire_bytes(tpay, tspec) == \
        jquant.tree_wire_bytes(jpay, jspec) == want[2]
    if wire_arg.startswith("4/16"):
        # the residual never travels: +ef costs no byte
        assert TF.packed_copy_bytes(tpay, tspec.stateless()) == want[1]
        assert want == ({1: 0.002015254, 2: 0.004030508}[rounds], 108876,
                        106066)
    if fed.adapter_rank:
        # the same student's dense int4 copy: the naive adapter wire
        # sends 0.095x its logical and 0.116x its packed bytes
        dense = TF._payload_template("student", True, state, ncls, pdim)
        assert TF.tree_wire_bytes(dense, tspec) == 104146
        assert TF.packed_copy_bytes(dense, tspec) == 106572
        if not fed.adapter_grams:
            assert (round(want[2] / 104146, 3),
                    round(want[1] / 106572, 3)) == (0.095, 0.116)
    if model == "cifar10-resnet18":
        # the ResNet8 student: 27 leaves, a [208, 512] plane, its lists
        # of stages kept in the template
        assert tuple(student.buf.shape) == (208, 512)
        assert len(tpay["model"]["stages"]) == 3
        assert want[1:] == (221336, 198076)


@pytest.mark.parametrize("fed_kw,train_kw,run_kw", [
    (dict(adapter_rank=4, quantize_bits=0), {}, {}),
])
def test_options_outside_the_slice_raise(fed_kw, train_kw, run_kw):
    """No option of ``run_federation`` is left outside the port (the
    adapter wire with ``+ef`` runs since it took the tree payload's error
    feedback); what ``repro`` refuses, the port refuses alike: the
    adapter wire without a quantized codec."""
    _, tcfg, node_data, test_d, _, _, _, _ = _setup(per_node=16)
    fed = tbase.FederationConfig(num_nodes=N_NODES, rounds=1, **fed_kw)
    with pytest.raises(ValueError, match="quantized wire"):
        TF.run_federation(tcfg, fed, tbase.TrainConfig(**train_kw),
                          node_data, test_d, device="cpu", **run_kw)


def test_run_federation_refuses_a_residual_without_error_feedback():
    """Initial states that carry an error-feedback residual on a wire
    without ``+ef`` are a mismatch, not a state to ignore."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        rounds=1, per_node=16, quantize_bits=4, proto_quantize_bits=16)
    scfg, _, _, jstates = _jax_states(jcfg, jfed, jtrain)
    states = [_carry(s, jwire_state.init_codec_state(
        {"protos": jnp.zeros((10, scfg.proto_dim), jnp.float32),
         "student": s.student})) for s in jstates]
    with pytest.raises(ValueError, match="no error feedback"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                          initial_states=states, device="cpu")


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup(per_node=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprofe.init_node_state(tcfg, TF.derive_student(tcfg),
                               torch.Generator(), make_plane_optimizer(
                                   "adamw", 1e-3), make_optimizer(
                                   "adamw", 1e-3), 10)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    # the port's user scripts
    files += sorted((ROOT / "benchmarks").glob("torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(alone)], capture_output=True,
                           text=True, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")],
            capture_output=True, text=True, timeout=120, cwd=ROOT))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
