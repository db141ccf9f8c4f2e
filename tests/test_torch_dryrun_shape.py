"""The port's compile-report mode (``python -m repro_torch.launch.dryrun
--shape``) and the rest of ``launch/programs.py`` against the JAX
package's.

* ``batch_struct``, ``decode_struct`` and ``node_state_struct``: the
  shapes and dtypes of JAX's ``eval_shape`` for every assigned arch and
  shape (the meta tensors against the ``ShapeDtypeStruct`` leaves);
* ``make_prefill_fn`` and ``make_serve_fn`` (the rolling window of
  ``long_500k`` included) against JAX's from carried weights in fp32,
  within ``tests/test_torch_lm_serve.py``'s ``F32_TOL`` (1e-5 of the
  largest magnitude);
* the trip-count fit (``launch/dryrun.count_combo``) against a full
  trace of the same program at small sizes, for every family: FLOPs,
  bytes, calls and argument, output and alias bytes exactly; the memory
  peak exactly where attention runs at the program's own blocks and in
  prefill and decode; a training step whose attention blocks are
  fitted within ``TRAIN_PEAK_RTOL`` (the peak is a maximum over moments,
  and a moment that the small traces' larger attention blocks hide is
  extrapolated, not seen);
* ``lower_combo`` at full width on three combos, its keys JAX's as the
  docstring of ``launch/roofline.py`` amends them, ``model_flops_6nd``
  JAX's ``model_flops``, ``pod2``'s ``federate`` equal to
  ``launch/wire.exchange_predictions`` and FedAvg's rule
  (``fedavg_round_bytes``) equal to what ``make_fedavg_round`` hands gloo
  on one rank; the microbatches by JAX's
  ``layout="auto"`` rule; the CLI (exit 2 on ``--layout``/``--no-fsdp``);
* ``chip_smoke.py``'s roofline phase on the CPU (one combo, runs timed
  as given): its lines, and its failure when a term exceeds the time.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget
from repro.config import get_shape as jshape
from repro.config.base import ShapeConfig as JShape
from repro.config.base import TrainConfig as JTrain
from repro.launch import programs as JPR
from repro.launch import roofline as JR
from repro.models import derive_student as jderive
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.config import base as tbase
from repro_torch.configs import ASSIGNED
from repro_torch.launch import dryrun as DR
from repro_torch.launch import programs as PR
from repro_torch.launch.op_analysis import count_ops
from repro_torch.models import derive_student, params_from_numpy
from repro_torch.tree import tree_map

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
F32_TOL = 1e-5
TRAIN_PEAK_RTOL = 0.15


# -- the stand-ins ------------------------------------------------------------

def _same(jtree, ttree, where="") -> None:
    if hasattr(jtree, "_fields"):
        for f in jtree._fields:
            _same(getattr(jtree, f), getattr(ttree, f), f"{where}.{f}")
    elif isinstance(jtree, dict):
        assert set(jtree) == set(ttree), where
        for k in jtree:
            _same(jtree[k], ttree[k], f"{where}/{k}")
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), where
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            _same(a, b, f"{where}[{i}]")
    elif jtree is None:
        assert ttree is None, where
    else:
        assert isinstance(ttree, torch.Tensor) and ttree.is_meta, where
        assert tuple(jtree.shape) == tuple(ttree.shape), where
        assert jnp.dtype(jtree.dtype).name == \
            str(ttree.dtype).replace("torch.", ""), where


@pytest.mark.parametrize("arch", ASSIGNED)
def test_structs_match_jax_eval_shape(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    for name in SHAPES:
        js, ts = jshape(name), tbase.SHAPES[name]
        if ts.kind == "decode":
            _same(JPR.decode_struct(jcfg, js), PR.decode_struct(tcfg, ts))
            assert PR.decode_cache_len(tcfg, ts) == \
                JPR.decode_cache_len(jcfg, js)
            assert PR.decode_rolling(tcfg, ts) == JPR.decode_rolling(jcfg, js)
        else:
            _same(JPR.input_specs(jcfg, js), PR.input_specs(tcfg, ts))
    train = JTrain(optimizer=jcfg.optimizer)
    want = JPR.node_state_struct(jcfg, jderive(jcfg), train,
                                 jcfg.n_proto_classes)
    got = PR.node_state_struct(tcfg, derive_student(tcfg),
                               TrainConfig(optimizer=tcfg.optimizer),
                               tcfg.n_proto_classes)
    _same(want, got)


# -- the prefill and serve programs from carried weights ----------------------

def _close(want, got):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert want.shape == got.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(want - got))) <= F32_TOL * scale


def _close_trees(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [t for t in jax.tree_util.tree_leaves(
        ttree, is_leaf=lambda x: isinstance(x, torch.Tensor))
        if isinstance(t, torch.Tensor)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(a, b)


def _to_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)),
                    jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("arch,shape", [("yi-6b", "long_500k")])
def test_prefill_and_serve_match_jax(arch, shape):
    jcfg = jget(arch).smoke().replace(dtype="float32")
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax.jit(lambda k: jinit(jcfg, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(0)
    b, s = 2, 8
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s))
             .astype(np.int32)}
    if jcfg.family == "audio":
        batch["audio_embed"] = (rng.standard_normal(
            (b, jcfg.encoder_seq, jcfg.d_model)) * 0.02).astype(np.float32)
    jl, jc = jax.jit(JPR.make_prefill_fn(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, tc = PR.make_prefill_fn(tcfg)(tp, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    _close(jl, tl)
    _close_trees(jc, tc)

    # one step against a cache drawn at random, past the window's end on
    # the rolling path
    js = JShape(shape, 64, b, "decode")
    ts = tbase.ShapeConfig(shape, 64, b, "decode")
    length = JPR.decode_cache_len(jcfg, js)
    cache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype),
        jax.eval_shape(lambda: jinit_cache(jcfg, b, length, jnp.float32)))
    index = length + 6 if JPR.decode_rolling(jcfg, js) else length - 3
    token = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    memory = []
    if jcfg.family == "audio":
        memory = [(rng.standard_normal((b, jcfg.encoder_seq, jcfg.d_model))
                   * 0.02).astype(np.float32)]
    tcache = _to_torch(cache)
    jl, jc = jax.jit(JPR.make_serve_fn(jcfg, js))(
        jp, jnp.asarray(token), jnp.int32(index), cache,
        *[jnp.asarray(m) for m in memory])
    with torch.no_grad():
        tl, tc = PR.make_serve_fn(tcfg, ts)(
            tp, torch.from_numpy(token), index, tcache,
            *[torch.from_numpy(m) for m in memory])
    _close(jl, tl)
    _close_trees(jc, tc)


# -- the trip-count fit against a full trace ----------------------------------

FAMILIES = ("yi-6b", "grok-1-314b", "mamba2-130m", "recurrentgemma-9b",
            "whisper-small", "llama-3.2-vision-90b")


def _small(arch):
    cfg = get_config(arch).smoke().replace(q_block=64, kv_block=64)
    return cfg, derive_student(cfg)


def _fit_and_direct(arch, shape, m=1):
    cfg, student = _small(arch)
    train = TrainConfig(optimizer=cfg.optimizer, remat=True, microbatches=m)
    fit = DR.count_combo(cfg, student, shape, FederationConfig(), train)
    point = {k: v for k, v in fit.real[""].items() if k != "j"}
    real_m = DR.traced_microbatches
    DR.traced_microbatches = lambda n: n       # the program as it is
    try:
        fn, args, parts = DR._program(cfg, student, shape,
                                      FederationConfig(), train, point)
    finally:
        DR.traced_microbatches = real_m
    return fit, count_ops(fn, *args, arg_parts=parts)


def _counts_equal(fit, direct):
    f = fit.count
    assert f.flops == {k: float(v) for k, v in direct.flops.items()}
    for field in ("bytes", "calls", "argument_bytes", "output_bytes",
                  "alias_bytes"):
        assert getattr(f, field) == getattr(direct, field), field
    assert fit.as_dict()["held_out_check"] == "exact"


@pytest.mark.parametrize("arch", FAMILIES)
def test_fit_equals_a_full_trace_prefill_and_decode(arch):
    for shape in (tbase.ShapeConfig("p", 512, 2, "prefill"),
                  tbase.ShapeConfig("d", 64, 2, "decode")):
        fit, direct = _fit_and_direct(arch, shape)
        _counts_equal(fit, direct)
        assert fit.count.temp_peak_bytes == direct.temp_peak_bytes
        if shape.kind == "prefill" and arch != "mamba2-130m":
            assert fit.real[""]["j"] == 8 and len(fit.samples) > 2


def test_fit_equals_a_full_trace_at_full_width():
    """whisper-small's prefill_32k at full width (two periods, two encoder
    layers, blocks of 2048: 16 a side): the fitted counts and peak equal
    a trace of the program at its own blocks, the encoder's attention and
    the decoder's each in their attention moments."""
    cfg = DR._cut(get_config("whisper-small"), 2, 2).replace(
        q_block=2048, kv_block=2048)
    student = derive_student(cfg)
    shape = tbase.ShapeConfig("p", 32768, 1, "prefill")
    fit = DR.count_combo(cfg, student, shape, FederationConfig(),
                         TrainConfig())
    assert fit.real[""] == {"X": 2, "E": 2, "j": 16}
    fn, args, parts = DR._program(cfg, student, shape, FederationConfig(),
                                  TrainConfig(), {"X": 2, "E": 2})
    direct = count_ops(fn, *args, arg_parts=parts)
    _counts_equal(fit, direct)
    assert fit.count.temp_peak_bytes == direct.temp_peak_bytes


@pytest.mark.parametrize("arch,m", [("mamba2-130m", 3), ("yi-6b", 2)])
def test_fit_equals_a_full_trace_train(arch, m):
    fit, direct = _fit_and_direct(arch, tbase.ShapeConfig("t", 320, 3,
                                                          "train"), m)
    _counts_equal(fit, direct)
    if "j" in fit.real[""]:
        assert fit.real[""]["j"] == 5
        assert abs(fit.count.temp_peak_bytes - direct.temp_peak_bytes) <= \
            TRAIN_PEAK_RTOL * direct.temp_peak_bytes
    else:
        assert fit.count.temp_peak_bytes == direct.temp_peak_bytes


# -- lower_combo at full width ------------------------------------------------

def test_microbatches_follow_jaxs_auto_layout():
    for arch in ASSIGNED:
        jc, tc = jget(arch), get_config(arch)
        for name in SHAPES:
            js = jshape(name)
            fsdp = js.kind == "train" and JR.approx_params(jc) < 1e10 \
                and jc.vocab_size <= 100_000
            want = 1 if js.kind != "train" else (1 if fsdp else 16)
            assert DR.resolve_microbatches(tc, tbase.SHAPES[name]) == want
            assert DR.resolve_microbatches(tc, tbase.SHAPES[name],
                                           microbatches=8) == \
                (8 if js.kind == "train" else 1)


JAX_KEYS = {"chips", "flops_per_device", "flops_total", "bytes_per_device",
            "collective_bytes_per_device", "collective_by_kind",
            "collective_counts", "terms_s", "dominant", "model_flops_6nd",
            "useful_flops_ratio", "memory_analysis"}


@pytest.mark.parametrize("arch,shape,mesh", [
    ("mamba2-130m", "decode_32k", "pod1"), ("yi-6b", "prefill_32k", "pod1"),
    ("yi-6b", "train_4k", "pod2")])
def test_lower_combo_full_width(arch, shape, mesh):
    from repro_torch.launch.wire import exchange_predictions
    rep = DR.lower_combo(arch, shape, mesh)
    assert JAX_KEYS <= set(rep)
    assert (rep["arch"], rep["shape"], rep["mesh"], rep["layout"]) == \
        (arch, shape, mesh, "one card")
    assert rep["n_devices"] == rep["chips"] == DR.MESHES[mesh]
    assert rep["model_flops_6nd"] == JR.model_flops(jget(arch),
                                                    jshape(shape))
    assert rep["flops_total"] == rep["flops_per_device"] * rep["chips"]
    assert rep["flops_per_device"] == sum(rep["flops_by_dtype"].values())
    assert rep["terms_s"]["memory_s"] == rep["bytes_per_device"] / 3.35e12
    assert rep["collective_bytes_per_device"] == 0.0
    mem = rep["memory_analysis"]
    assert mem["peak_bytes_estimate"] == mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"]
    assert mem["fits_80gb_hbm"] == (mem["peak_bytes_estimate"] <= 80e9)
    assert rep["trip_count_fit"]["held_out_check"] == "exact"
    if shape == "train_4k":
        pred = exchange_predictions(arch, 2, "full", bits=16, full=True)
        fed = rep["federate"]
        assert fed["profe_collective_bytes"]["total"] == \
            pred["packed_pred_bytes_per_node"]
        assert fed["profe_collective_bytes_gather"]["total"] == \
            pred["logical_bytes_per_node"]
        assert fed["wire_reduction_vs_fedavg"] == \
            1 - fed["profe_collective_bytes"]["total"] / \
            fed["fedavg_collective_bytes"]["total"]
    else:
        assert "federate" not in rep


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_fedavg_bytes_are_what_the_round_hands_gloo(one_rank_group):
    from repro_torch.core import mesh_federation as M
    from repro_torch.models import init_params
    cfg = get_config("yi-6b").smoke()
    teacher = init_params(cfg, torch.Generator().manual_seed(0))
    stacked = tree_map(lambda x: x[None], teacher)
    M.COLLECTIVE_BYTES.count = 0
    M.make_fedavg_round(one_rank_group, exchange="packed")(
        stacked, torch.ones(1))
    assert DR.fedavg_round_bytes(teacher, n_nodes=2) == \
        M.COLLECTIVE_BYTES.count > 0


@pytest.mark.parametrize("argv", [["--layout", "tp"], ["--layout", "fsdp"],
                                  ["--no-fsdp"], []])
def test_cli_refuses_what_the_port_does_not_shard(argv, capsys):
    assert DR.main(["--arch", "yi-6b"] + (argv + ["--shape", "train_4k"]
                                          if argv else argv)) == 2
    assert "repro_torch.launch.dryrun" in capsys.readouterr().err


def test_cli_writes_the_report(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert DR.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                    "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["status"] == "ok" and rep["dominant"] in ("compute", "memory")
    assert json.loads(capsys.readouterr().out) == rep


# -- chip_smoke.py's roofline phase on the CPU --------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_roofline_phase_on_cpu(tmp_path, capsys):
    smoke = _chip_smoke()
    timed = {"programs/yi-6b/4x2": {
        "smoke": True, "layers": 2, "batch": 4, "microbatches": 2,
        "seq": 16, "step_ms": 1e4, "peak_bytes": 1}}
    line = smoke.run_roofline(torch, "cpu", counted=tuple(timed),
                              timed=timed, out_dir=str(tmp_path),
                              archs=["mamba2-130m"], shapes=("decode_32k",))
    assert [c["mesh"] for c in line["combos"]] == ["pod1", "pod2"]
    assert json.loads((tmp_path / "mamba2-130m_decode_32k_pod2.json")
                      .read_text())["n_devices"] == 2
    (row,) = line["counted"]
    assert row["share"] < 1 and row["compute_ms"] > 0
    out = capsys.readouterr().out
    assert "[OK] mamba2-130m" in out and "roofline count " in out
    timed["programs/yi-6b/4x2"]["step_ms"] = row["memory_ms"] / 2
    with pytest.raises(RuntimeError, match="above the measured"):
        smoke.run_roofline(torch, "cpu", archs=[], counted=tuple(timed),
                           timed=timed, out_dir=str(tmp_path))
