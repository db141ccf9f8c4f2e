"""The in-node layouts — ``repro_torch.sharding``'s placement rules,
``launch/mesh.py``'s node mesh and the compile report's
``--cards-per-node`` — against the JAX package on the CPU.

* **Specs, exactly.**  ``param_specs`` (the default axes, ``fsdp``'s
  ``(("data", "model"), None)`` and ``--no-fsdp``'s ``(None, "model")``),
  ``opt_state_specs``, and ``batch_specs`` / ``cache_specs`` of every
  shape's stand-ins, for the ten archs at full width, against the JAX
  package's on ``AbstractMesh`` (16, 16), (2, 4), (1, 8) and (8, 1),
  leaf for leaf; ``shard_act``'s spec of every activation kind at the
  same meshes, both MoE fallbacks hit (JAX's spec read through a patched
  ``with_sharding_constraint``).
* **Counts under a layout** (one rank of 8 on a fake process group, each
  layout's node mesh: ``fsdp`` 8 × 1, ``tp`` 2 × 4; fp32): a dense layer
  and a gated FFN block, forward, against closed forms from their
  placements (``_closed_form``); yi-6b's ``train_4k`` state at ``fsdp``
  8: the rank's weight and moment bytes are the one-card count's over 8
  but for the replicated leaves, which the test lists.
* **JAX's HLO.**  yi-6b's smoke decode under ``tp`` on a ``(2, 4)`` mesh
  of the 8 host devices ``tests/conftest.py`` forces, lowered with JAX's
  own ``make_serve_fn`` and specs, its collectives read by
  ``launch/hlo_analysis.analyze_hlo`` (the JAX report's reader, which
  counts a loop body by its trips; ``collective_bytes_from_hlo`` counts it
  once), against the port's count of the same decode.  The two
  partitioners agree on all-gathers and all-reduces and differ in the
  rest, which the test holds exactly (``test_smoke_decode_against_jaxs_hlo``
  says why).
* **The same function.**  Four gloo ranks (one spawn) on a ``(2, 2)``
  mesh run yi-6b's smoke prefill and one ProFe step (sgd, fp32) under
  ``fsdp`` and ``tp``; the logits, losses and updated parameters match
  the unsharded port from the same weights within ``LOGIT_RTOL`` /
  ``PARAM_RTOL`` of the largest magnitude (fp32 sums in another order).
  The unsharded run is held to JAX by ``tests/test_torch_programs.py``.
* **The CLI**: ``--cards-per-node 8 --layout tp`` writes a report with
  the layout's keys; ``--cards-per-node 3`` and ``--node-mesh 3x3`` exit 2.
"""
import json
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import sharding as JS
from repro.config import get_config as jget
from repro.config import get_shape as jshape
from repro.config.base import ShapeConfig as JShape
from repro.launch import programs as JPR
from repro.models import derive_student as jderive
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro_torch import sharding as S
from repro_torch.config import (SHAPES, FederationConfig, TrainConfig,
                                get_config)
from repro_torch.config.base import ShapeConfig
from repro_torch.configs import ASSIGNED
from repro_torch.launch import dryrun as DR
from repro_torch.launch import programs as PR
from repro_torch.launch.mesh import fake_group, make_node_mesh
from repro_torch.launch.op_analysis import count_ops
from repro_torch.models import derive_student, init_cache, init_params
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(2)

MESHES = ((16, 16), (2, 4), (1, 8), (8, 1))
AXES = ("data", "model")
# the train step's weight axes: the default (tp), fsdp, --no-fsdp
WEIGHT_AXES = ({}, {"data_axis": ("data", "model"), "model_axis": None},
               {"data_axis": None})
LOGIT_RTOL = 4e-6
PARAM_RTOL = 1e-6
DEADLINE_S = 240


def _jspecs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _tspecs(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, list):
            for s in t:
                walk(s)
        else:
            out.append(t)
    walk(tree)
    return out


def _jstructs(arch):
    jc = jget(arch)
    return jc, {c.name: jax.eval_shape(lambda c=c: jinit(
        c, jax.random.PRNGKey(0))) for c in (jc, jderive(jc))}


# -- specs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_opt_state_specs_equal_jaxs(arch):
    jc, jparams = _jstructs(arch)
    tc = get_config(arch)
    for tcfg in (tc, derive_student(tc)):
        tparams = init_params(tcfg, torch.Generator().manual_seed(0),
                              device="meta")
        jp = jparams[tcfg.name]
        for shape in MESHES:
            am = AbstractMesh(shape, AXES)
            ms = dict(zip(AXES, shape))
            for ax in WEIGHT_AXES:
                js = JS.param_specs(jc, jp, am, **ax)
                ts = S.param_specs(tcfg, tparams, ms, **ax)
                assert _jspecs(js) == _tspecs(ts), (tcfg.name, shape, ax)
                assert _jspecs(JS.opt_state_specs(tc.optimizer, js)) == \
                    _tspecs(S.opt_state_specs(tc.optimizer, ts, tparams)), \
                    (tcfg.name, shape, ax)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_batch_and_cache_specs_equal_jaxs(arch):
    jc, tc = jget(arch), get_config(arch)
    for name in SHAPES:
        js, ts = jshape(name), SHAPES[name]
        for shape in MESHES:
            am = AbstractMesh(shape, AXES)
            ms = dict(zip(AXES, shape))
            if js.kind in ("train", "prefill"):
                jb, tb = JPR.batch_struct(jc, js), PR.batch_struct(tc, ts)
                for dp in (("data",), ("data", "model")):
                    assert _jspecs(JS.batch_specs(jb, am, dp_axes=dp)) == \
                        _tspecs(S.batch_specs(tb, ms, dp_axes=dp)), \
                        (name, shape, dp)
            if js.kind == "prefill":
                jcache = jax.eval_shape(lambda: jinit_cache(
                    jc, js.global_batch, js.seq_len, jax.numpy.bfloat16))
                tcache = init_cache(tc, ts.global_batch, ts.seq_len,
                                    torch.bfloat16, "meta")
            elif js.kind == "decode":
                jd, td = JPR.decode_struct(jc, js), PR.decode_struct(tc, ts)
                jcache, tcache = jd["cache"], td["cache"]
                for k in ("token", "memory"):
                    if k in jd:
                        assert _jspecs(JS.batch_specs(
                            {k: jd[k]}, am, dp_axes=("data",))) == \
                            _tspecs(S.batch_specs({k: td[k]}, ms,
                                                  dp_axes=("data",)))
            else:
                continue
            assert _jspecs(JS.cache_specs(jcache, am, data_axis=("data",))) \
                == _tspecs(S.cache_specs(tcache, ms, data_axis=("data",))), \
                (name, shape)


def _act_shapes(cfg):
    """An activation of each kind at the arch's widths (and an MoE's
    dispatch at its experts)."""
    b, s, d, v = 32, 4096, cfg.d_model, cfg.vocab_size
    e = max(cfg.num_experts, 1)
    return {"btd": (b, s, d), "btf": (b, s, cfg.d_ff or d),
            "bthd": (b, s, cfg.num_heads, cfg.head_dim), "btv": (b, s, v),
            "bd": (b, d), "egcd": (e, 64, 320, d), "gtd": (64, 2048, d),
            "gtec": (64, 2048, e, 320),
            # a scan's extra leading dim, left free
            "btd+lead": (2, b, s, d)}


def test_activation_specs_equal_jaxs(monkeypatch):
    got = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sh: got.append(tuple(sh.spec)) or x)
    fallbacks = {"egcd": 0, "gtec": 0}
    try:
        for arch in ASSIGNED:
            cfg = get_config(arch)
            for shape in MESHES:
                am = AbstractMesh(shape, AXES)
                ms = dict(zip(AXES, shape))
                for dp, model in ((("data",), "model"),
                                  (("data", "model"), None)):
                    JS.set_activation_sharding(am, dp_axes=dp,
                                               model_axis=model)
                    for kind, sh in _act_shapes(cfg).items():
                        kind = kind.split("+")[0]
                        JS.shard_act(jax.ShapeDtypeStruct(sh, np.float32),
                                     kind)
                        assert got.pop() == S.act_spec(sh, kind, ms, dp,
                                                       model), \
                            (arch, shape, dp, kind, sh)
                        if kind in fallbacks and model and not S._fits(
                                sh[0 if kind == "egcd" else 2], ms, model):
                            fallbacks[kind] += 1
    finally:
        JS.clear_activation_sharding()
    assert all(fallbacks.values()), fallbacks


# -- counts under a layout -----------------------------------------------------

B, T, D, F = 16, 32, 64, 128
E = 4      # fp32


def _closed_form(layout: str, block: str, data: int = 2, model: int = 4):
    """One rank's forward FLOPs and collective bytes (JAX's convention)
    of ``block`` on 8 cards, from the placements:

    * fsdp (8 × 1) — the batch over all 8 ranks, one dim of every weight
      over ``("data", "model")``, 8 ways: each weight is all-gathered
      (output D·F); no other collective;
    * tp (``data × model``) — the batch over data, a column-parallel
      weight ``(data, model)`` gathered over data (output D·F/model), a
      row-parallel one ``(model, data)`` likewise; the dense layer's
      column shards are gathered back to the input's placement (output
      B/data·T·F), the FFN's row-parallel partial sum all-reduced (twice
      B/data·T·D)."""
    mats = 1 if block == "dense" else 3
    if layout == "fsdp":
        return mats * 2 * (B // 8) * T * D * F, {"all-gather": mats * D * F * E}
    coll = {"all-gather": mats * D * (F // model) * E}
    if block == "dense":
        coll["all-gather"] += (B // data) * T * F * E
    else:
        coll["all-reduce"] = 2 * (B // data) * T * D * E
    return mats * 2 * (B // data) * T * D * (F // model), coll


NODES = {"tp": (2, 4), "fsdp": (8, 1)}      # each layout's (data, model)


@pytest.fixture(scope="module")
def meshes8():
    """The two node meshes of 8 cards, ``tp``'s 2 × 4 and ``fsdp``'s
    8 × 1, on one fake process group."""
    with fake_group(8):
        yield {k: make_node_mesh(8, *v) for k, v in NODES.items()}


@pytest.fixture(scope="module")
def node8(meshes8):
    return meshes8["tp"]


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
@pytest.mark.parametrize("block", ["dense", "ffn"])
def test_block_counts_are_their_closed_form(meshes8, layout, block):
    from repro_torch.models import ffn as FF
    from repro_torch.models import layers as L
    mesh = meshes8[layout]
    lay = DR.NodeLayout(layout, 8, *NODES[layout])
    ms = lay.mesh_shape

    def w(i, o):
        return {"kernel": torch.empty(i, o, device="meta")}
    params = {"wi": w(D, F)} if block == "dense" else {"ffn": {
        "wi_gate": w(D, F), "wi_up": w(D, F), "wo": w(F, D)}}
    params = S.distribute(params, S.param_specs(
        None, params, ms, **lay.weight_axes("train")), mesh)
    x = S.distribute(torch.empty(B, T, D, device="meta"),
                     (S.dim_axis(B, ms, lay.act_dp), None, None), mesh)

    @torch.no_grad()
    def fwd(params, x):
        y = L.dense(params["wi"], x) if block == "dense" else \
            FF.gated_ffn(params["ffn"], x)
        return y.redistribute(mesh, x.placements)
    with lay.active(mesh):
        c = count_ops(fwd, params, x)
    flops, coll = _closed_form(layout, block)
    assert c.flops == {"fp32": flops}
    assert c.coll == coll


# the leaves a fsdp layout replicates: 1-d norms and biases
REPLICATED = {"final_norm/scale", "proto_proj/bias",
              "stack/scan/b0/ln1/scale", "stack/scan/b0/ln2/scale"}


def test_fsdp_rank_holds_an_eighth_of_the_state(meshes8):
    """yi-6b's ``train_4k`` state at ``fsdp`` 8: the bytes of each part's
    weights and moments on one rank (the report's arguments, which its
    peak holds) are the one-card count's over 8, but for the replicated
    leaves (and the moments' step counters), which every rank holds
    whole."""
    cfg = get_config("yi-6b")
    st = derive_student(cfg)
    shape = SHAPES["train_4k"]
    lay = DR.node_layout(cfg, shape, 8)
    assert (lay.name, lay.data, lay.model) == ("fsdp", 8, 1)
    train = TrainConfig(optimizer=cfg.optimizer, remat=True, microbatches=1)
    state = PR.node_state_struct(cfg, st, train, cfg.n_proto_classes)
    placed = lay.place_state(state, cfg, st, train.optimizer,
                             meshes8["fsdp"])

    def args(s):
        c = count_ops(lambda *a: None, s, arg_parts={
            "teacher": (s.teacher, s.opt_t), "student": (s.student, s.opt_s)})
        return {p: c.memory[p]["argument_bytes"] for p in ("teacher",
                                                           "student")}
    one, rank = args(state), args(placed)
    for part, c in (("teacher", cfg), ("student", st)):
        params = getattr(state, part)
        specs = S.param_specs(c, params, lay.mesh_shape,
                              **lay.weight_axes("train"))
        rep = {"/".join(map(str, p)): t for (p, t), (_, s) in zip(
            tree_paths(params), _spec_paths(specs)) if not any(s)}
        assert set(rep) == REPLICATED, part
        # a replicated weight, adamw's two fp32 moments of it, its step
        whole = sum(t.numel() * (t.element_size() + 2 * 4)
                    for t in rep.values()) + 4
        assert rank[part] * 8 == one[part] + 7 * whole, part


def _spec_paths(specs, prefix=()):
    """``tree_paths`` of a spec tree (its leaves are tuples)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _spec_paths(specs[k], prefix + (k,))]
    if isinstance(specs, list):
        return [x for i, sub in enumerate(specs)
                for x in _spec_paths(sub, prefix + (i,))]
    return [(prefix, specs)]


# -- JAX's HLO -----------------------------------------------------------------

def _jax_decode_collectives(arch):
    from jax.sharding import Mesh, NamedSharding
    from repro.launch.hlo_analysis import analyze_hlo
    jc = jget(arch).smoke()
    shape = JShape("d", 64, 16, "decode")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), AXES)
    ps = jax.eval_shape(lambda: jinit(jc, jax.random.PRNGKey(0)))
    d = JPR.decode_struct(jc, shape)
    dpa = ("data",)
    JS.set_activation_sharding(mesh, dp_axes=dpa, model_axis="model")
    try:
        csp = JS.cache_specs(d["cache"], mesh, data_axis=dpa)
        tsp = JS.batch_specs({"token": d["token"]}, mesh,
                             dp_axes=dpa)["token"]
        with mesh:
            hlo = jax.jit(
                JPR.make_serve_fn(jc, shape),
                in_shardings=(JS.to_named(JS.param_specs(jc, ps, mesh), mesh),
                              NamedSharding(mesh, tsp),
                              NamedSharding(mesh, P()),
                              JS.to_named(csp, mesh)),
                out_shardings=(NamedSharding(mesh, P(tsp[0], None)),
                               JS.to_named(csp, mesh)),
                donate_argnums=(3,)).lower(
                    ps, d["token"], d["index"], d["cache"]).compile() \
                .as_text()
    finally:
        JS.clear_activation_sharding()
    an = analyze_hlo(hlo)
    return {k: v for k, v in an.coll.items() if v}


def _port_decode_collectives(arch, mesh):
    cfg = get_config(arch).smoke()
    shape = ShapeConfig("d", 64, 16, "decode")
    lay = DR.NodeLayout("tp", 8, 2, 4)
    params = lay.place_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="meta"), mesh)
    d = PR.decode_struct(cfg, shape)
    cache = lay.place_cache(d["cache"], mesh)
    token = lay.place_batch({"token": d["token"]}, "decode", mesh)["token"]
    with lay.active(mesh):
        c = count_ops(torch.no_grad()(PR.make_serve_fn(cfg, shape)), params,
                      token, shape.seq_len - 1, cache)
    return c.coll


def test_smoke_decode_against_jaxs_hlo(node8):
    """Both partitioners gather weights and all-reduce the partial sums
    of scores over the head_dim-sharded cache.  They part elsewhere: XLA
    moves the new token's K/V into that cache with all-to-alls and
    collective-permutes (a dynamic-update-slice at a traced position),
    where the port writes each rank's head_dim shard in place; DTensor
    reduces a row-parallel projection's partial sum straight into the
    next constraint's shards (a reduce-scatter) where XLA all-reduces.
    The kinds each has alone are held, and the ratio of the all-reduce
    bytes (the port's all-reduces are the scores' at every layer, XLA's
    fewer and larger)."""
    jax_coll = _jax_decode_collectives("yi-6b")
    port = _port_decode_collectives("yi-6b", node8)
    shared = {"all-gather", "all-reduce"}
    assert shared <= set(jax_coll) and shared <= set(port)
    assert set(jax_coll) - shared == {"all-to-all", "collective-permute"}
    assert set(port) - shared == {"reduce-scatter"}
    assert port["all-reduce"] / jax_coll["all-reduce"] == 50432 / 40960


# -- the same function on four gloo ranks --------------------------------------

def _smoke():
    cfg = get_config("yi-6b").smoke().replace(dtype="float32",
                                              param_dtype="float32")
    train = TrainConfig(optimizer="sgd", learning_rate=0.1, remat=True,
                        microbatches=1)
    return cfg, derive_student(cfg), train


def _batch(cfg):
    rng = np.random.default_rng(0)

    def ints(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))
    return {"tokens": ints(cfg.vocab_size, (8, 32)),
            "labels": ints(cfg.vocab_size, (8, 32)),
            "domains": ints(4, (8,))}


def _run(layout=None, mesh=None):
    """yi-6b smoke prefill and one ProFe step from seeded weights, whole
    (``layout`` None) or under ``layout`` on ``mesh``; results whole."""
    import contextlib
    cfg, st, train = _smoke()
    state = PR.node_state_struct(cfg, st, train, cfg.n_proto_classes,
                                 device="cpu")
    teacher = init_params(cfg, torch.Generator().manual_seed(1))
    state = state._replace(teacher=teacher, student=init_params(
        st, torch.Generator().manual_seed(2)))
    batch = _batch(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1))
    prompt = {"tokens": batch["tokens"]}
    if layout is not None:
        state = layout.place_state(state, cfg, st, train.optimizer, mesh)
        batch = layout.place_batch(batch, "train", mesh)
        params = layout.place_params(cfg, params, mesh)
        prompt = layout.place_batch(prompt, "prefill", mesh)
    with layout.active(mesh) if layout else contextlib.nullcontext():
        with torch.no_grad():
            logits, _ = PR.make_prefill_fn(cfg)(params, prompt)
        step, _ = PR.make_profe_train_fn(cfg, st, FederationConfig(), train)
        state, metrics = step(state, batch)

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()
    return {"logits": whole(logits),
            "metrics": {k: whole(v) for k, v in metrics.items()},
            "params": [whole(t) for t in tree_leaves((state.teacher,
                                                      state.student))]}


def _rank_main(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        mesh = make_node_mesh(4, 2, 2, device="cpu")
        res = {name: _run(DR.NodeLayout(name, 4, 2, 2), mesh)
               for name in ("fsdp", "tp")}
        try:            # another world size is refused, never faked
            make_node_mesh(8, 2, 4)
        except RuntimeError as e:
            res["refused"] = str(e)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layouts")
    ctx = mp.start_processes(
        _rank_main, args=(4, f"file://{tmp / 'store'}", str(tmp / "r.pt")),
        nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                pytest.fail(f"4 ranks did not finish within {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return torch.load(tmp / "r.pt")


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
def test_four_gloo_ranks_match_the_unsharded_port(gloo4, layout):
    ref, got = _run(), gloo4[layout]
    scale = ref["logits"].abs().max()
    assert (got["logits"] - ref["logits"]).abs().max() <= LOGIT_RTOL * scale
    for k, v in ref["metrics"].items():
        assert abs(float(got["metrics"][k]) - float(v)) <= \
            LOGIT_RTOL * max(abs(float(v)), 1.0), k
    assert len(got["params"]) == len(ref["params"])
    for a, b in zip(got["params"], ref["params"]):
        assert (a - b).abs().max() <= PARAM_RTOL * max(
            float(b.abs().max()), 1.0)
    assert "8" in gloo4["refused"] and "4" in gloo4["refused"]


# -- the CLI -------------------------------------------------------------------

def test_cli_writes_a_layout_report(tmp_path, capsys):
    from repro_torch.launch.roofline import NVLINK_BW
    out = tmp_path / "r.json"
    assert DR.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                    "--cards-per-node", "8", "--layout", "tp",
                    "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == rep
    assert (rep["layout"], rep["cards_per_node"], rep["n_devices"],
            rep["node_mesh"]) == ("tp", 8, 8, {"data": 2, "model": 4})
    coll = rep["collective_bytes_per_device"]
    assert coll > 0 and coll == sum(rep["collective_by_kind"].values())
    assert set(rep["collective_counts"]) == set(rep["collective_by_kind"])
    assert rep["terms_s"]["collective_s"] == coll / NVLINK_BW == coll / 450e9
    mem = rep["memory_analysis"]
    assert mem["fits_80gb_hbm"] == (mem["peak_bytes_estimate"] <= 80e9)
    assert rep["trip_count_fit"]["held_out_check"] == "exact"


@pytest.mark.parametrize("argv", [
    ["--cards-per-node", "3"], ["--cards-per-node", "8", "--node-mesh", "3x3"],
    ["--node-mesh", "3x3"], ["--cards-per-node", "8", "--layout", "dp"]])
def test_cli_refuses_a_node_it_cannot_place(argv, capsys):
    assert DR.main(["--arch", "yi-6b", "--shape", "train_4k"] + argv) == 2
    assert "repro_torch.launch.dryrun" in capsys.readouterr().err


# -- chip_smoke.py's layouts phase on the CPU ------------------------------------

def test_chip_smoke_layouts_phase_on_cpu(node8, tmp_path, capsys):
    """Phase 14h at the CPU's size: one combo of the 8-card sweep, then
    one rank of yi-6b's smoke (2 layers, 4 × 16) under ``tp`` run from
    drawn shards over the fake group, its count beside its time."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", smoke)
    spec.loader.exec_module(smoke)
    line = smoke.run_layouts(
        torch, "cpu", device="cpu", archs=["mamba2-130m"],
        shapes=("decode_32k",), jobs=1, out_dir=str(tmp_path),
        runs=(("tp", (2, 4)),), run_seq=16,
        run_cfg=get_config("yi-6b").smoke().replace(num_layers=2))
    (combo,) = line["combos"]
    assert (combo["arch"], combo["layout"], combo["held_out_check"]) == \
        ("mamba2-130m", "tp", "exact")
    assert (tmp_path / "mamba2-130m_decode_32k_pod1_8cards.json").exists()
    (run,) = line["runs"]
    assert run["measured_ms"] > 0 and 0 < run["share"] < 1
    assert run["collective_by_kind"] and run["collective_ms"] > 0
    out = capsys.readouterr().out
    assert "[OK] mamba2-130m" in out and "layouts rank tp 2x4" in out
