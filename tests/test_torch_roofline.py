"""The port's roofline (``repro_torch.launch.roofline``) and op counter
(``repro_torch.launch.op_analysis``) against the JAX package's
``launch/roofline.py`` and ``launch/hlo_analysis.py``.

* ``approx_params`` and ``model_flops`` equal to JAX's for the ten
  assigned archs at every assigned shape (and the paper models);
* ``roofline_report``'s keys are JAX's but for the stated exceptions
  (``fits_80gb_hbm``, no ``xla_cost_analysis_flops``, ``flops_by_dtype``,
  ``peaks``, ``card``), its terms at the H100's published peaks;
* the counter's FLOPs against ``analyze_hlo`` of JAX's jitted program
  compiled on one CPU device, at the smoke configs (batch 2, 16 tokens):
  ``prefill`` and ``decode_step`` of a dense, an MoE, an SSM, a hybrid
  and an audio arch exactly plus ``2·B·d·proto_dim`` — the prototype
  projection ``f1``, which ``_head`` computes and the program drops: XLA
  removes it as dead code, eager PyTorch runs it; the ProFe train
  program of yi-6b exactly, and of mamba2-130m exactly less 98,304 — the
  backward of the SSD's three-operand einsums, which torch
  differentiates through its chain of pairwise products and JAX through
  one einsum per operand;
* the counter's bytes, views and in-place rules on hand-made programs;
  its memo gives the counts of a cold run;
* ``benchmarks/torch_roofline_table.py`` on reports it is given.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.config import get_config as jget
from repro.config import get_shape as jshape
from repro.config.base import FederationConfig as JFed
from repro.config.base import ShapeConfig as JShape
from repro.config.base import TrainConfig as JTrain
from repro.launch import programs as JPR
from repro.launch import roofline as JR
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import derive_student as jderive
from repro.models import init_params as jinit
from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.config import base as tbase
from repro_torch.configs import ASSIGNED, PAPER
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import programs as PR
from repro_torch.launch import roofline as R
from repro_torch.models import derive_student, init_params

torch.set_num_threads(2)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# dense, MoE, SSM, hybrid, audio
HLO_ARCHS = ("yi-6b", "llama4-scout-17b-a16e", "mamba2-130m",
             "recurrentgemma-9b", "whisper-small")
TRAIN_ARCHS = {"yi-6b": 0, "mamba2-130m": -98304}
B, S = 2, 16


# -- approx_params / model_flops ----------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED + PAPER)
def test_model_flops_match_jax(arch):
    jc, tc = jget(arch), get_config(arch)
    for active in (False, True):
        assert R.approx_params(tc, active_only=active) == \
            JR.approx_params(jc, active_only=active)
    for name in SHAPES:
        js = jshape(name)
        ts = tbase.SHAPES[name]
        assert R.model_flops(tc, ts) == JR.model_flops(jc, js)


# -- the report ---------------------------------------------------------------

class _Mem:
    argument_size_in_bytes = 10
    output_size_in_bytes = 4
    temp_size_in_bytes = 6
    alias_size_in_bytes = 4
    generated_code_size_in_bytes = 1


class _Mesh:
    class devices:
        size = 1


def test_report_keys_are_jaxs_but_the_stated_ones():
    cfg, shape = get_config("yi-6b"), tbase.SHAPES["decode_32k"]
    count = OA.OpCount(flops={"bf16": 989e12, "fp32": 67e12}, bytes=3.35e12,
                       argument_bytes=60e9, temp_peak_bytes=21e9,
                       output_bytes=1e9, alias_bytes=1e9)
    rep = R.roofline_report(cfg, shape, count)
    want = JR.roofline_report(jget("yi-6b"), jshape("decode_32k"), _Mesh,
                              _Mem(), {"flops": 1.0, "bytes accessed": 1.0},
                              {"total": 0.0, "by_kind": {}, "counts": {}})
    assert set(rep) == (set(want) - {"xla_cost_analysis_flops"}) | {
        "flops_by_dtype", "peaks", "card"}
    assert set(rep["memory_analysis"]) == (
        set(want["memory_analysis"]) - {"generated_code_size_in_bytes",
                                        "fits_16gb_hbm"}) | {"fits_80gb_hbm"}
    # one second of bf16 and one of fp32 at the data sheet's dense peaks
    assert rep["terms_s"] == {"compute_s": 2.0, "memory_s": 1.0,
                              "collective_s": 0.0}
    assert rep["dominant"] == "compute"
    mem = rep["memory_analysis"]
    assert mem["peak_bytes_estimate"] == 81e9 and not mem["fits_80gb_hbm"]
    assert rep["model_flops_6nd"] == JR.model_flops(jget("yi-6b"),
                                                    jshape("decode_32k"))
    assert R.PEAK_FLOPS == {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}
    assert (R.HBM_BW, R.HBM_BYTES) == (3.35e12, 80e9)


# -- the counter against XLA's HLO --------------------------------------------

def _jax_structs(jcfg):
    return jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0)))


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _hlo_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _meta_params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), device="meta")


@pytest.mark.parametrize("arch", HLO_ARCHS)
def test_prefill_and_decode_flops_match_xla(arch):
    jcfg = jget(arch).smoke()
    tcfg = _tcfg(jcfg)
    dead = 2 * B * tcfg.d_model * tcfg.proto_dim     # prefill's unused f1
    jp = _jax_structs(jcfg)
    params = _meta_params(tcfg)

    shape = JShape("prefill", S, B, "prefill")
    want = _hlo_flops(JPR.make_prefill_fn(jcfg), jp,
                      JPR.batch_struct(jcfg, shape))
    got = OA.count_ops(torch.no_grad()(PR.make_prefill_fn(tcfg)), params,
                       PR.batch_struct(tcfg, tbase.ShapeConfig(
                           "prefill", S, B, "prefill")))
    assert got.total_flops == want + dead

    shape = JShape("decode", S, B, "decode")
    d = JPR.decode_struct(jcfg, shape)
    want = _hlo_flops(JPR.make_serve_fn(jcfg, shape), jp, d["token"],
                      d["index"], d["cache"], *(
                          [d["memory"]] if "memory" in d else []))
    tshape = tbase.ShapeConfig("decode", S, B, "decode")
    td = PR.decode_struct(tcfg, tshape)
    got = OA.count_ops(torch.no_grad()(PR.make_serve_fn(tcfg, tshape)),
                       params, td["token"], S - 1, td["cache"],
                       *([td["memory"]] if "memory" in td else []))
    assert got.total_flops == want + dead


@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_train_program_flops_match_xla(arch):
    jcfg = jget(arch).smoke()
    tcfg = _tcfg(jcfg)
    jtrain = JTrain(optimizer=jcfg.optimizer, remat=True)
    step, _ = JPR.make_profe_train_fn(jcfg, jderive(jcfg), JFed(), jtrain)
    shape = JShape("train", S, B, "train")
    want = _hlo_flops(step, JPR.node_state_struct(
        jcfg, jderive(jcfg), jtrain, jcfg.n_proto_classes),
        JPR.batch_struct(jcfg, shape))
    train = TrainConfig(optimizer=tcfg.optimizer, remat=True)
    tstep, _ = PR.make_profe_train_fn(tcfg, derive_student(tcfg),
                                      FederationConfig(), train)
    got = OA.count_ops(tstep, PR.node_state_struct(
        tcfg, derive_student(tcfg), train, tcfg.n_proto_classes),
        PR.batch_struct(tcfg, tbase.ShapeConfig("train", S, B, "train")))
    assert got.total_flops - want == TRAIN_ARCHS[arch]
    # the two parts hold the whole count between them
    assert set(got.parts) == {"", "teacher", "student"}
    assert sum(p.total_flops for p in got.parts.values()) == got.total_flops


# -- the counter's rules ------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_bytes_flops_and_dtypes_of_one_program():
    a, b = _meta(8, 16), _meta(16, 4, dtype=torch.bfloat16)
    buf = _meta(8, 4)

    def fn(a, b, buf):
        y = a.to(torch.bfloat16) @ b            # _to_copy, then a bf16 mm
        z = a @ a.t()                           # a view, then an fp32 mm
        v = y.view(32)                          # a view: no bytes
        buf.copy_(y)                            # buf written, not read
        buf.add_(1.0)                           # read and written
        return z, v

    c = OA.count_ops(fn, a, b, buf)
    assert c.flops == {"bf16": 2 * 8 * 16 * 4, "fp32": 2 * 8 * 16 * 8}
    f4, h2 = 4, 2
    want = {"_to_copy": 8 * 16 * (f4 + h2),
            "mm": 8 * 16 * h2 + 16 * 4 * h2 + 8 * 4 * h2
            + 8 * 16 * f4 + 16 * 8 * f4 + 8 * 8 * f4,   # a and a.t() apart
            "copy_": 8 * 4 * (h2 + f4), "add_": 8 * 4 * f4 * 2}
    assert {k: v["bytes"] for k, v in c.by_op.items() if v["bytes"]} == want
    assert c.by_op["view"]["bytes"] == 0 and c.by_op["t"]["bytes"] == 0
    assert c.bytes == sum(want.values())
    assert c.argument_bytes == (8 * 16 + 8 * 4) * f4 + 16 * 4 * h2
    assert c.output_bytes == 8 * 8 * f4 + 8 * 4 * h2
    assert c.alias_bytes == 0
    # live at the peak: the cast and y (the cast dies with the product),
    # then y and z
    assert c.temp_peak_bytes == 8 * 16 * h2 + 8 * 4 * h2 == \
        8 * 4 * h2 + 8 * 8 * f4


def test_memo_gives_a_cold_runs_counts():
    cfg = get_config("yi-6b").smoke()
    params = _meta_params(cfg)
    batch = PR.batch_struct(cfg, tbase.ShapeConfig("p", 64, 2, "prefill"))
    fn = torch.no_grad()(PR.make_prefill_fn(cfg.replace(q_block=16,
                                                        kv_block=16)))
    with OA.no_memo():
        cold = OA.count_ops(fn, params, batch)
    warm = OA.count_ops(fn, params, batch)
    for field in ("flops", "bytes", "calls", "by_op", "temp_peak_bytes",
                  "argument_bytes", "output_bytes", "alias_bytes"):
        assert getattr(cold, field) == getattr(warm, field), field


def test_an_argument_dropped_lends_no_alias():
    state = {"v": _meta(1024)}

    def fn(state):
        state["v"] = state["v"] * 2.0      # the argument's storage dropped
        return state

    c = OA.count_ops(fn, state)
    assert c.alias_bytes == 0 and c.output_bytes == 4096


def test_fit_recovers_a_polynomial_and_checks_it():
    def trace(p):
        c = OA.OpCount()
        c.parts[""] = OA.OpCount()
        c.parts[""].add("mm", 0, None, 3 * p["X"] ** 2 + 5 * p["X"] * p["m"]
                        + 7)
        c.peaks["|other"] = {"": float(11 * p["X"])}
        return c
    monos = [{}, {"X": 1}, {"X": 2}, {"X": 1, "m": 1}, {"m": 1}]
    cand = {"X": (2, 3, 4, 5), "m": (2, 3, 4)}
    samples, held = OA.design(cand, monos, lambda p: p["X"] * p["m"],
                              beyond=("X",))
    assert held not in samples and held["m"] == 3
    assert all(p["X"] != held["X"] for p in samples)   # beyond the samples
    fit = OA.fit_counts(trace, monos, samples, held, {"": {"X": 40, "m": 16}},
                        peak_monomials=[{}, {"X": 1}])
    assert fit.count.bytes == 3 * 1600 + 5 * 640 + 7
    assert fit.count.temp_peak_bytes == 440 and fit.temp_peak_method == "fit"

    def wrong(p):                          # cubic: the held-out trace misses
        c = trace(p)
        c.parts[""].add("mm", 0, None, p["X"] ** 3)
        return c
    with pytest.raises(OA.FitError):
        OA.fit_counts(wrong, monos, samples, held, {"": {"X": 40, "m": 16}})


# -- the table and torch_run --------------------------------------------------

def _report(arch, shape, mesh, fed=None):
    rep = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
           "terms_s": {"compute_s": 1.5, "memory_s": 2.0,
                       "collective_s": 0.0},
           "dominant": "memory", "useful_flops_ratio": 0.5,
           "memory_analysis": {"fits_80gb_hbm": True}}
    if fed:
        rep["federate"] = fed
    return rep


def test_roofline_table_renders_reports(tmp_path):
    from benchmarks import torch_roofline_table as T
    fed = {"profe_collective_bytes": {"total": 2e6},
           "fedavg_collective_bytes": {"total": 8e6},
           "wire_reduction_vs_fedavg": 0.75}
    for rep in (_report("yi-6b", "train_4k", "pod1"),
                _report("yi-6b", "train_4k", "pod2", fed)):
        (tmp_path / f"{rep['arch']}_{rep['shape']}_{rep['mesh']}.json"
         ).write_text(json.dumps(rep))
    tables = T.main(["--reports", str(tmp_path)])
    assert tables["pod1"].splitlines()[0].endswith("| 6ND/counted | "
                                                   "fits 80GB |")
    assert tables["pod1"].splitlines()[2] == \
        "| yi-6b | train_4k | 1.5 | 2 | 0 | **memory** | 0.50 | yes |"
    assert tables["federate"].splitlines()[2] == \
        "| yi-6b | 2.0 MB | 8.0 MB | 75.0% |"
