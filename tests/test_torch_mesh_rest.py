"""The rest of the port's multi-node exchange
(``repro_torch.core.mesh_federation``), held against the JAX package's
rounds on ``fed_mesh(4)``: FedAvg (``make_fedavg_round``), ProFe with a
per-leaf student tree, the per-leaf reference exchange
(``exchange="gather"``), the adapter-rank round, and an LM student's
plane (mamba2-130m's smoke config).

The port's rounds run on 4 gloo ranks, spawned once for the whole file
(one node per rank); every case runs in that one spawn and each rank
saves what it saw.  JAX runs the same numpy inputs on 4 virtual CPU
devices (``tests/conftest.py``), jitted, but for the LM plane: jitted on
XLA:CPU the round divides by Δ as a multiply by its reciprocal
(``tests/test_torch_loop_engine.py``), and over the LM payload's ~300k
codes a few hundred land one code apart from the true division, which
the port and the eager round both take (their students then differ by
up to one code step times a gossip weight), so that case runs JAX's
round eagerly.  The spawned ranks import this module and
load torch alone.

What is compared, and how:

* bit for bit: each rank's codes, segment scales and encoded wire bytes
  against the JAX mesh codec run eagerly on the same payload (on the
  adapter wire, the rank's own share: the two packages' factorizations
  differ in the last bits, so their payloads are not the same numbers),
  and the carried error-feedback residual and ``seq`` against the same
  eager chain (the jitted JAX round contracts ``eff - codes·Δ`` into an
  FMA on the CPU, ``tests/test_torch_mesh.py``; its second ``+ef`` round
  is fed the eager chain's state, which the port's state equals);
* exactly: the prototype mask, and each rank's bytes handed to
  collectives (``COLLECTIVE_BYTES``): the copies it sends
  (``ppermute``: its out-degree; ``packed``: its one copy) times
  ``packed_copy_bytes`` of the payload, or on ``gather`` the gathered
  codes', scales' and counts' own bytes; FedAvg's fp32 rows;
* within ``atol = 4 ulp`` of the largest magnitude (``STUDENT_ULPS``):
  the mixed students and models and the prototypes (the port mixes
  sender by sender, JAX by ``einsum`` with contracted multiply-adds);
* the adapter round's merged students: 4 ulp plus what the two
  factorizations' gap can move a merge.  The factors of one delta agree
  to ``FACTOR_RTOL`` (1e-5, ``tests/test_torch_adapters.py``: Ω within 4
  ulp, the Gram-Schmidt in another order), so a naive merge may differ
  by ``FACTOR_RTOL`` of the largest merged delta.  RegMean solves
  ``Gsum_i·X = (A G)ᵀ`` per receiver: a relative gap in its inputs
  grows by at most the condition number of ``Gsum_i`` (computed here in
  float64 from the JAX grams, at these shapes up to ~1e3, the ridge's
  cap), so RegMean merges are held to 4 ulp plus ``cond·FACTOR_RTOL`` of
  the largest merged delta.  The new adapter references exactly (they
  are the sent students' matrices).  The adapter wire runs 16-bit here:
  at int4 one flipped factor code moves a merge by a seventh of its
  delta, far beyond what the frameworks' last bits decide;
* one rank holding all 4 nodes (``packed``) against the port's own
  stacked engine's adapter share and merge: students within 4 ulp,
  prototypes and mask bit for bit, the adapter state bit for bit.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(2)

N = 4
C, P = 5, 16
RANK_R = 4
STUDENT_ULPS = 4
FACTOR_RTOL = 1e-5
DEADLINE_S = 180

# FedAvg: name -> (exchange, topology, student kind)
FEDAVG = {f"fedavg/{ex}/{topo}/{kind}": (ex, topo, kind)
          for ex, topos in (("gather", ("ring", "none")),
                            ("packed", ("ring", "none")),
                            ("ppermute", ("ring", "full")))
          for topo in topos for kind in ("plane", "tree")}
# ProFe: name -> (exchange, topology, wire, student kind, overlap, rounds)
PROFE = {
    "profe/tree/ppermute/16": ("ppermute", "ring", "16", "tree", False, 1),
    "profe/tree/packed/16": ("packed", "ring", "16", "tree", False, 1),
    "profe/tree/gather/16": ("gather", "ring", "16", "tree", False, 1),
    "profe/tree/ppermute+overlap/4/16+ef": ("ppermute", "ring", "4/16+ef",
                                            "tree", True, 2),
    "profe/tree/packed-full/4/16+ef": ("packed", "none", "4/16+ef", "tree",
                                       False, 2),
    "profe/tree/gather/4/16+ef": ("gather", "ring", "4/16+ef", "tree",
                                  False, 2),
    "profe/plane/gather/16": ("gather", "ring", "16", "plane", False, 1),
    "profe/plane/gather-full/4/16+ef": ("gather", "none", "4/16+ef",
                                        "plane", False, 2),
    "profe/lm/mamba2-130m/ppermute/16": ("ppermute", "ring", "16", "lm",
                                         False, 1),
}
# the adapter round: name -> (exchange, wire, grams, student kind, overlap)
ADAPTER = {f"adapter/{ex}/{g}{ef}": (ex, "16" + ef, g == "regmean",
                                     "plane", False)
           for ex in ("gather", "packed", "ppermute")
           for g in ("naive", "regmean") for ef in ("", "+ef")}
ADAPTER["adapter/ppermute+overlap/regmean+ef"] = ("ppermute", "16+ef", True,
                                                  "plane", True)
ADAPTER["adapter/packed/naive/tree"] = ("packed", "16", False, "tree", False)
ADAPTER["adapter/ppermute/regmean+ef/tree"] = ("ppermute", "16+ef", True,
                                               "tree", False)


def _adjacency(topo):
    from repro_torch.core import topology as T
    if topo == "none":
        return None
    if topo == "full":
        return (1.0 - np.eye(N)).astype(np.float32)
    return T.adjacency(N, topo)


def _student_np(kind, rnd):
    """Every node's student as numpy leaves ``[N, ...]``."""
    rng = np.random.default_rng(200 + rnd)
    if kind == "lm":
        return _lm_student()
    if kind == "adapter":
        return {"conv": {"kernel": rng.standard_normal(
                    (N, 3, 3, 6, 8)).astype(np.float32)},
                "fc": {"kernel": rng.standard_normal((N, 40, 12)).astype(
                    np.float32),
                       "bias": rng.standard_normal((N, 12)).astype(
                           np.float32)}}
    return {"w": rng.standard_normal((N, 33, 20)).astype(np.float32),
            "b": rng.standard_normal((N, 7)).astype(np.float32),
            "rem": []}


def _lm_cfgs():
    from repro_torch.config import get_config
    from repro_torch.models import derive_student
    cfg = get_config("mamba2-130m").smoke()
    return cfg, derive_student(cfg)


def _lm_student():
    """mamba2-130m's smoke student, N nodes drawn from seeds 0..N-1."""
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    _, scfg = _lm_cfgs()
    trees = [init_params(scfg, torch.Generator().manual_seed(i))
             for i in range(N)]
    return tree_map(lambda *xs: torch.stack(xs).float().numpy(), *trees)


def _protos_np(rnd, c=C, p=P):
    rng = np.random.default_rng(100 + rnd)
    counts = rng.integers(0, 4, (N, c)).astype(np.float32)
    counts[0, 1] = 0.0
    counts[:, c - 1] = 0.0
    return {"protos": rng.standard_normal((N, c, p)).astype(np.float32),
            "counts": counts,
            "sizes": rng.integers(50, 200, (N,)).astype(np.float32)}


def _adapter_state_np(student, grams: bool):
    """A reference a little behind the student (deltas of 1e-3 of the
    weights) and, with grams, positive semi-definite gram carries."""
    rng = np.random.default_rng(300)
    ref, gram = {}, {}
    for name, w in (("['conv']['kernel']", student["conv"]["kernel"]),
                    ("['fc']['kernel']", student["fc"]["kernel"])):
        ref[name] = (w - 1e-3 * rng.standard_normal(w.shape)).astype(
            np.float32)
        a = rng.standard_normal(w.shape[:-2] + (RANK_R, w.shape[-1]))
        gram[name] = np.einsum("...rk,...rl->...kl", a, a).astype(
            np.float32)
    return {"ref": ref, "grams": gram} if grams else {"ref": ref}


# -- the ranks -------------------------------------------------------------

def _rows(tree, sl):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x[sl])),
                    tree)


def _student(kind, tree):
    from repro_torch.optim.plane import Plane, plane_from_tree
    from repro_torch.tree import tree_map
    if kind == "tree":
        return tree
    n = next(iter(x for x in _leaves(tree))).shape[0]
    planes = [plane_from_tree(tree_map(lambda x: x[i], tree))
              for i in range(n)]
    return Plane(torch.stack([p.buf for p in planes]), planes[0].meta)


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _flat(students):
    from repro_torch.optim.plane import Plane
    if isinstance(students, Plane):
        return [students.buf.clone()]
    return [x.clone() for x in _leaves(students)]


def _run_fedavg(rank, case):
    from repro_torch.core import mesh_federation as M
    exchange, topo, kind = case
    sl = slice(rank, rank + 1)
    models = _student(kind, _rows(_student_np("tree", 0), sl))
    sizes = torch.from_numpy(_protos_np(0)["sizes"])
    fn = M.make_fedavg_round(adjacency=_adjacency(topo), exchange=exchange)
    before = M.COLLECTIVE_BYTES.count
    out = fn(models, sizes)
    return [{"bytes": M.COLLECTIVE_BYTES.count - before,
             "out": _flat(out), "tree": kind == "tree" and
             out["rem"] == [] and out["w"].dtype == torch.float32}]


def _run_profe(rank, case):
    from repro_torch.core import mesh_federation as M
    from repro_torch.core.wire_state import init_codec_state
    from repro_torch.wirespec import WireSpec
    exchange, topo, wire, kind, overlap, rounds = case
    spec = WireSpec.parse(wire)
    fn = M.make_profe_round(adjacency=_adjacency(topo), exchange=exchange,
                            spec=spec, overlap=overlap)
    sl = slice(rank, rank + 1)
    state, out = None, []
    for rnd in range(rounds):
        if kind == "lm":
            cfg, scfg = _lm_cfgs()
            inp = _protos_np(rnd, scfg.n_proto_classes, scfg.proto_dim)
            students = _student("plane", _rows(_student_np("lm", rnd), sl))
        else:
            inp = _protos_np(rnd)
            students = _student(kind, _rows(_student_np("tree", rnd), sl))
        protos = torch.from_numpy(inp["protos"][sl])
        counts = torch.from_numpy(inp["counts"][sl])
        if spec.error_feedback and state is None:
            state = init_codec_state({"protos": protos, "student": students},
                                     n_nodes=1)
        rec = {}
        if exchange != "gather":
            sent = M._send_side(protos, students, spec, state)
            rec.update(codes=sent.codes, scales=sent.scales,
                       wire=sent.wire.clone())
        before = M.COLLECTIVE_BYTES.count
        res = fn(students, protos, counts, torch.from_numpy(inp["sizes"]),
                 *([state] if spec.error_feedback else []))
        rec.update(bytes=M.COLLECTIVE_BYTES.count - before,
                   student=_flat(res[0]), protos=res[1], mask=res[2])
        if spec.error_feedback:
            state = res[3]
            rec.update(res_protos=state.residual["protos"],
                       res_student=_flat(state.residual["student"]),
                       seq=state.seq)
        out.append(rec)
    return out


def _run_adapter(rank, case):
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import round_ops as R
    from repro_torch.core.adapters import adapter_layout, zero_wire_payload
    from repro_torch.core.wire_state import init_codec_state
    from repro_torch.kernels.quantize import ops as Q
    from repro_torch.optim.plane import as_tree
    from repro_torch.wirespec import WireSpec
    exchange, wire, grams, kind, overlap = case
    spec = WireSpec.parse(wire)
    sl = slice(rank, rank + 1)
    inp = _protos_np(0)
    tree_np = _student_np("adapter", 0)
    students = _student(kind, _rows(tree_np, sl))
    ast = _rows(_adapter_state_np(tree_np, grams), sl)
    protos = torch.from_numpy(inp["protos"][sl])
    counts = torch.from_numpy(inp["counts"][sl])
    state = None
    if spec.error_feedback:
        tree = as_tree(students)
        pay = zero_wire_payload(adapter_layout(tree, RANK_R, node_axis=True),
                                tree, grams=grams)
        pay["protos"] = protos
        state = init_codec_state(pay, n_nodes=1)
        # a carried residual of the size error feedback leaves behind
        rng = np.random.default_rng(400 + rank)
        for r in _leaves(state.residual):
            r.copy_(torch.from_numpy(rng.standard_normal(
                tuple(r.shape)).astype(np.float32)) * 1e-6)
    fn = M.make_profe_round(adjacency=_adjacency("ring"), exchange=exchange,
                            spec=spec, overlap=overlap, adapter_rank=RANK_R,
                            adapter_grams=grams)
    # the rank's own share and codec, as the round computes them
    groups, _, _ = R.adapter_share_nodes(students, ast, rank=RANK_R,
                                         grams=grams)
    payload = dict(groups, protos=protos)
    buf, seg_ids, meta = Q.pack_tree_nodes(payload, spec)
    codes, scales, new_ef = M._quantize_with_state(spec, buf, seg_ids, meta,
                                                   state)
    before = M.COLLECTIVE_BYTES.count
    res = fn(students, protos, counts, torch.from_numpy(inp["sizes"]), ast,
             *([state] if spec.error_feedback else []))
    rec = {"bytes": M.COLLECTIVE_BYTES.count - before,
           "payload": [x.clone() for x in _leaves(payload)],
           "residual_in": None if state is None else
           [x.clone() for x in _leaves(state.residual)],
           "codes": codes, "scales": scales,
           "wire": Q.encode_wire(codes, seg_ids, seg_bits=meta[3]).clone(),
           "student": _flat(res[0]), "protos": res[1], "mask": res[2],
           "ref": [x.clone() for x in _leaves(res[3]["ref"])],
           "grams": [x.clone() for x in _leaves(res[3].get("grams", {}))]}
    if spec.error_feedback:
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(res[4].residual), _leaves(new_ef.residual)))
        rec.update(residual=[x.clone() for x in _leaves(res[4].residual)],
                   seq=res[4].seq)
    return [rec]


def _rank_main(rank: int, world: int, init: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        results = {name: _run_fedavg(rank, case)
                   for name, case in FEDAVG.items()}
        results.update({name: _run_profe(rank, case)
                        for name, case in PROFE.items()})
        results.update({name: _run_adapter(rank, case)
                        for name, case in ADAPTER.items()})
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, tmp, *args):
    """Run ``fn(rank, world, init, *args)`` on ``world`` spawned ranks
    over a ``file://`` store in ``tmp``; fail if they take longer than
    ``DEADLINE_S`` (and stop them)."""
    init = f"file://{tmp / 'store'}"
    ctx = mp.start_processes(fn, args=(world, init) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                pytest.fail(f"{world} ranks did not finish within "
                            f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_rest")
    _spawn(_rank_main, N, tmp, str(tmp))
    return [torch.load(tmp / f"rank{r}.pt") for r in range(N)]


# -- the JAX side ----------------------------------------------------------

def _jnp_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), tree)


def _specs(tree):
    import jax
    from jax.sharding import PartitionSpec as Pspec
    return jax.tree_util.tree_map(lambda x: Pspec(*([None] * (x.ndim - 1))),
                                  tree)


def _jax_student(kind, tree):
    import jax
    from repro.optim.plane import plane_from_tree
    t = _jnp_tree(tree)
    return t if kind == "tree" else jax.vmap(plane_from_tree)(t)


def _jflat(students):
    import jax
    from repro.optim.plane import is_plane
    if is_plane(students):
        return [np.asarray(students.buf)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(students)]


def _ulp_atol(x) -> float:
    return STUDENT_ULPS * float(np.spacing(np.float32(np.abs(x).max())))


def _close(got, want, where, extra=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_ulp_atol(want) + extra, err_msg=where)


def _copy_bytes(payload_np, wire) -> int:
    """``packed_copy_bytes`` of one node's payload (numpy leaves
    ``[N, ...]`` by group: the node axis dropped)."""
    from repro_torch.core.comm import packed_copy_bytes
    from repro_torch.tree import ShapeDtypeStruct, tree_map
    from repro_torch.wirespec import WireSpec
    tmpl = tree_map(lambda x: ShapeDtypeStruct(tuple(x.shape[1:]),
                                               np.dtype(np.float32)),
                    payload_np)
    return packed_copy_bytes(tmpl, None if wire is None
                             else WireSpec.parse(wire))


def _out_degree(topo) -> int:
    adj = _adjacency(topo)
    return int(adj.sum(axis=1)[0])


def _fedavg_bytes(exchange, topo, kind):
    tree = _student_np("tree", 0)
    if exchange == "gather":
        return sum(x[0].nbytes for x in _leaves(tree))
    per = _copy_bytes({"model": tree}, None)
    return per * (_out_degree(topo) if exchange == "ppermute" else 1)


@pytest.mark.parametrize("name", list(FEDAVG))
def test_fedavg_round_matches_jax(rank_results, name):
    import jax
    from repro.core import mesh_federation as JM
    from repro.launch.wire import fed_mesh
    exchange, topo, kind = FEDAVG[name]
    mesh = fed_mesh(N)
    tree = _student_np("tree", 0)
    fn = jax.jit(JM.make_fedavg_round(mesh, _specs(tree),
                                      adjacency=_adjacency(topo),
                                      exchange=exchange))
    with mesh:
        want = _jflat(fn(_jax_student(kind, tree),
                         np.asarray(_protos_np(0)["sizes"])))
    for rank, res in enumerate(rank_results):
        (got,) = res[name]
        where = f"{name} rank {rank}"
        assert got["bytes"] == _fedavg_bytes(exchange, topo, kind), where
        assert kind == "plane" or got["tree"], where
        assert len(got["out"]) == len(want)
        for g, w in zip(got["out"], want):
            _close(g, w[rank:rank + 1], where)
    if topo != "none":
        assert not torch.equal(rank_results[0][name][0]["out"][0],
                               rank_results[2][name][0]["out"][0])


def _jax_profe(case):
    """JAX's jitted round per round, and the eager mesh codec's codes,
    scales, wire bytes and carried state per round (packed layouts)."""
    import jax
    import jax.numpy as jnp
    from repro.core import mesh_federation as JM
    from repro.core.wire_state import CodecState, init_codec_state
    from repro.kernels.quantize import ops as JQ
    from repro.launch.wire import fed_mesh
    from repro.wirespec import WireSpec
    exchange, topo, wire, kind, overlap, rounds = case
    spec = WireSpec.parse(wire)
    mesh = fed_mesh(N)
    src_kind = "lm" if kind == "lm" else "tree"
    jkind = "plane" if kind == "lm" else kind
    fn = JM.make_profe_round(
        mesh, _specs(_student_np(src_kind, 0)), adjacency=_adjacency(topo),
        exchange=exchange, spec=spec, overlap=overlap)
    if kind != "lm":
        fn = jax.jit(fn)
    state, out = None, []
    for rnd in range(rounds):
        if kind == "lm":
            _, scfg = _lm_cfgs()
            inp = _protos_np(rnd, scfg.n_proto_classes, scfg.proto_dim)
        else:
            inp = _protos_np(rnd)
        students = _jax_student(jkind, _student_np(src_kind, rnd))
        protos = jnp.asarray(inp["protos"])
        if spec.error_feedback and state is None:
            state = init_codec_state({"protos": protos, "student": students})
        with mesh:
            res = fn(students, protos, jnp.asarray(inp["counts"]),
                     jnp.asarray(inp["sizes"]),
                     *([state] if spec.error_feedback else []))
        rec = {"student": _jflat(res[0]), "protos": np.asarray(res[1]),
               "mask": np.asarray(res[2])}
        if exchange != "gather":
            with mesh:
                buf, seg_ids, meta, _, _ = JM._pack_payload(protos, students,
                                                            spec)
                codes, scales, new = JM._quantize_with_state(
                    mesh, spec, buf, seg_ids, meta, state)
            rec.update(codes=np.asarray(codes), scales=np.asarray(scales),
                       wire=np.asarray(JQ.encode_wire(codes, seg_ids,
                                                      seg_bits=meta[4])))
        elif state is not None:
            new = _gather_ef_chain(spec, students, protos, state)
        if spec.error_feedback:
            state = CodecState(new.residual, new.seq)
            rec.update(res_protos=np.asarray(state.residual["protos"]),
                       res_student=_jflat(state.residual["student"]),
                       seq=int(state.seq))
        out.append(rec)
    return out


def _gather_ef_chain(spec, students, protos, state):
    """The gather exchange's residual update, eagerly: ``eff - deq`` of
    each leaf's per-node codes (``repro``'s ``_make_profe_round_gather``
    step 1)."""
    import jax
    import jax.numpy as jnp
    from repro.core.round_ops import dequantize_leaf, quantize_leaf_per_node
    from repro.core.wire_state import CodecState
    from repro.optim.plane import as_tree, is_plane, plane_from_tree
    plane = is_plane(students)
    st = as_tree(students)
    res_s = state.residual["student"]
    res_s = as_tree(res_s) if is_plane(res_s) else res_s
    decay = jnp.float32(spec.ef_decay)
    eff = jax.tree_util.tree_map(lambda x, r: x.astype(jnp.float32) +
                                 decay * r, st, res_s)
    eff_p = protos.astype(jnp.float32) + decay * state.residual["protos"]
    new_s = jax.tree_util.tree_map(
        lambda e: e - dequantize_leaf(*quantize_leaf_per_node(
            e, spec.bits_for("student"))), eff)
    new_p = eff_p - dequantize_leaf(*quantize_leaf_per_node(
        eff_p, spec.bits_for("protos")))
    if plane:
        new_s = jax.vmap(plane_from_tree)(new_s)
    return CodecState({"protos": new_p, "student": new_s}, state.seq + 1)


def _profe_bytes(case):
    exchange, topo, wire, kind, _, _ = case
    if kind == "lm":
        _, scfg = _lm_cfgs()
        inp = _protos_np(0, scfg.n_proto_classes, scfg.proto_dim)
        tree = _student_np("lm", 0)
    else:
        inp, tree = _protos_np(0), _student_np("tree", 0)
    if exchange == "gather":
        from repro_torch.wirespec import WireSpec
        spec = WireSpec.parse(wire)
        width = {4: 1, 8: 1, 16: 2}
        codes = sum(x[0].size * width[spec.bits_for("student")]
                    for x in _leaves(tree))
        pcodes = inp["protos"][0].size * width[spec.bits_for("protos")]
        # a scale a leaf, the prototypes' scale, the counts
        return codes + pcodes + 4 * len(_leaves(tree)) + 4 + 4 * C
    per = _copy_bytes({"model": tree, "protos": inp["protos"],
                       "counts": inp["counts"]}, wire)
    return per * (_out_degree(topo) if exchange == "ppermute" else 1)


@pytest.mark.parametrize("name", list(PROFE))
def test_profe_round_matches_jax(rank_results, name):
    exchange, topo, wire, kind, overlap, rounds = PROFE[name]
    want = _jax_profe(PROFE[name])
    for rank, res in enumerate(rank_results):
        got = res[name]
        assert len(got) == rounds
        for rnd, (g, w) in enumerate(zip(got, want)):
            where = f"{name} rank {rank} round {rnd}"
            if exchange != "gather":
                for key in ("codes", "scales", "wire"):
                    np.testing.assert_array_equal(
                        g[key].numpy(), w[key][rank:rank + 1],
                        err_msg=f"{where}: {key}")
            assert g["bytes"] == _profe_bytes(PROFE[name]), where
            assert len(g["student"]) == len(w["student"])
            for a, b in zip(g["student"], w["student"]):
                _close(a, b[rank:rank + 1], where)
            pw = w["protos"] if topo == "none" else w["protos"][rank:rank + 1]
            mw = w["mask"] if topo == "none" else w["mask"][rank:rank + 1]
            _close(g["protos"], pw, where)
            np.testing.assert_array_equal(g["mask"].numpy(), mw,
                                          err_msg=where)
            if "+ef" in wire:
                np.testing.assert_array_equal(
                    g["res_protos"].numpy(), w["res_protos"][rank:rank + 1],
                    err_msg=where)
                for a, b in zip(g["res_student"], w["res_student"]):
                    np.testing.assert_array_equal(a.numpy(),
                                                  b[rank:rank + 1],
                                                  err_msg=where)
                assert g["seq"].tolist() == [w["seq"]] == [rnd + 1]


def _jax_adapter(case, payloads, residuals):
    """JAX's jitted adapter round; and per rank the JAX mesh codec,
    eagerly, on the rank's own share (``payloads``) and incoming residual
    (``residuals``)."""
    import jax
    import jax.numpy as jnp
    from repro.core import mesh_federation as JM
    from repro.core.wire_state import CodecState
    from repro.kernels.quantize import ops as JQ
    from repro.launch.wire import fed_mesh
    from repro.wirespec import WireSpec
    exchange, wire, grams, kind, overlap = case
    spec = WireSpec.parse(wire)
    mesh = fed_mesh(N)
    tree = _student_np("adapter", 0)
    inp = _protos_np(0)
    ast = _jnp_tree(_adapter_state_np(tree, grams))
    fn = jax.jit(JM.make_profe_round(
        mesh, _specs(tree), adjacency=_adjacency("ring"), exchange=exchange,
        spec=spec, overlap=overlap, adapter_rank=RANK_R,
        adapter_grams=grams))
    jstate = None
    if spec.error_feedback:
        like = jax.tree_util.tree_structure(_adapter_payload_like(tree,
                                                                  grams))
        stacked = [np.concatenate(xs) for xs in zip(*residuals)]
        jstate = CodecState(jax.tree_util.tree_unflatten(
            like, [jnp.asarray(x) for x in stacked]),
            jnp.zeros((N,), jnp.int32))
    with mesh:
        res = fn(_jax_student(kind, tree), jnp.asarray(inp["protos"]),
                 jnp.asarray(inp["counts"]), jnp.asarray(inp["sizes"]), ast,
                 *([jstate] if spec.error_feedback else []))
    # the JAX codec, eagerly, on every rank's own share stacked over the
    # nodes (each node's segments are scaled on their own)
    like = jax.tree_util.tree_structure(_adapter_payload_like(tree, grams))
    jpay = jax.tree_util.tree_unflatten(like, [
        jnp.asarray(np.concatenate([p[k].numpy() for p in payloads]))
        for k in range(len(payloads[0]))])
    buf, seg_ids, meta = JQ.pack_tree_nodes(jpay, spec=spec)
    with mesh:
        codes, scales, new = JM._quantize_with_state(mesh, spec, buf,
                                                     seg_ids, meta, jstate)
    wire_b = np.asarray(JQ.encode_wire(codes, seg_ids, seg_bits=meta[4]))
    res_leaves = None if new is None else \
        [np.asarray(x) for x in jax.tree_util.tree_leaves(new.residual)]
    codecs = [{"codes": np.asarray(codes)[r:r + 1],
               "scales": np.asarray(scales)[r:r + 1],
               "wire": wire_b[r:r + 1],
               "residual": None if new is None else
               [x[r:r + 1] for x in res_leaves]} for r in range(N)]
    return res, codecs


def _adapter_payload_like(tree, grams, protos=True):
    """The adapter payload's structure (numpy zeros ``[N, ...]``): the
    flatten order both packages pack in."""
    from repro_torch.core.adapters import adapter_layout, zero_wire_payload
    t = _rows(tree, slice(0, N))
    pay = zero_wire_payload(adapter_layout(t, RANK_R, node_axis=True), t,
                            grams=grams)
    if protos:
        pay["protos"] = torch.zeros((N, C, P))
    import jax
    return jax.tree_util.tree_map(lambda x: np.asarray(x), pay)


def _regmean_cond(ast_np, sizes, adj) -> float:
    """The largest condition number of the receivers' ``Gsum_i`` (ridge
    included, ``core/aggregation.py``) in float64."""
    from repro_torch.core.aggregation import REGMEAN_EPS
    from repro_torch.core.round_ops import gossip_matrix
    w = gossip_matrix(adj, sizes)[1].astype(np.float64)
    cond = 1.0
    for g in ast_np["grams"].values():
        gsum = np.einsum("ns,s...kl->n...kl", w, g.astype(np.float64))
        k = g.shape[-1]
        tr = np.trace(gsum, axis1=-2, axis2=-1) / k
        gsum = gsum + (REGMEAN_EPS * tr + 1e-6)[..., None, None] * np.eye(k)
        cond = max(cond, float(np.linalg.cond(gsum).max()))
    return cond


@pytest.mark.parametrize("name", list(ADAPTER))
def test_adapter_round_matches_jax(rank_results, name):
    import jax
    exchange, wire, grams, kind, overlap = ADAPTER[name]
    got = [res[name][0] for res in rank_results]
    res, codecs = _jax_adapter(ADAPTER[name], [g["payload"] for g in got],
                               [g["residual_in"] for g in got])
    tree = _student_np("adapter", 0)
    inp = _protos_np(0)
    want_s = _jflat(res[0])
    delta = max(float(np.abs(w - _jflat(_jax_student(kind, tree))[k]).max())
                for k, w in enumerate(want_s))
    rtol = FACTOR_RTOL * (_regmean_cond(_adapter_state_np(tree, True),
                                        inp["sizes"], _adjacency("ring"))
                          if grams else 1.0)
    pay_np = {"adapters": _adapter_payload_like(tree, grams)["adapters"],
              "model": {"b": np.zeros((N, 12), np.float32)},
              "protos": inp["protos"], "counts": inp["counts"]}
    if grams:
        pay_np["grams"] = _adapter_payload_like(tree, grams)["grams"]
    per = _copy_bytes(pay_np, wire)
    # gather: the payload's code rows at the container of the spec's
    # widest group (int8 up to 8 bits, int16 above), a fp32 scale a leaf
    # and the counts, from the JAX package's layout of the payload
    from repro.kernels.quantize.ops import packed_wire_rows
    from repro.wirespec import WireSpec as JWireSpec
    rows, n_seg = packed_wire_rows(
        {k: v for k, v in pay_np.items() if k != "counts"})
    gather_bytes = rows * 512 * (1 if JWireSpec.parse(wire).max_bits <= 8
                                 else 2) + 4 * n_seg + 4 * C
    for rank, g in enumerate(got):
        where = f"{name} rank {rank}"
        cw = codecs[rank]
        for key in ("codes", "scales", "wire"):
            np.testing.assert_array_equal(g[key].numpy(), cw[key],
                                          err_msg=f"{where}: {key}")
        if exchange == "gather":
            want_bytes = gather_bytes
        else:
            want_bytes = per * (2 if exchange == "ppermute" else 1)
        assert g["bytes"] == want_bytes, (where, g["bytes"], want_bytes)
        for a, b in zip(g["student"], want_s):
            _close(a, b[rank:rank + 1], where, extra=rtol * delta)
        _close(g["protos"], np.asarray(res[1])[rank:rank + 1], where)
        np.testing.assert_array_equal(g["mask"].numpy(),
                                      np.asarray(res[2])[rank:rank + 1],
                                      err_msg=where)
        for a, b in zip(g["ref"], jax.tree_util.tree_leaves(res[3]["ref"])):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b)[rank:rank + 1],
                                          err_msg=where)
        if "+ef" in wire:
            for a, b in zip(g["residual"], cw["residual"]):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=where)
            assert g["seq"].tolist() == [1]
    assert not torch.equal(got[0]["student"][0], got[2]["student"][0])


# -- one rank holding every node, against the stacked engine ----------------

@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("grams", [False, True], ids=["naive", "regmean"])
def test_one_rank_adapter_round_matches_stacked_share_and_merge(
        one_rank_group, grams):
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import topology as T
    from repro_torch.core.federation import _make_round_parts
    from repro_torch.core.profe import NodeState
    from repro_torch.optim.plane import Plane
    from repro_torch.wirespec import WireSpec
    spec = WireSpec.parse("4")
    tree_np = _student_np("adapter", 0)
    plane = _student("plane", _rows(tree_np, slice(0, N)))
    ast_np = _adapter_state_np(tree_np, grams)
    inp = _protos_np(0)
    protos = torch.from_numpy(inp["protos"])
    counts = torch.from_numpy(inp["counts"])
    sched = T.make_schedule(N, "ring")
    fn = M.make_profe_round(one_rank_group, adjacency=sched.adjacency_at(0),
                            exchange="packed", spec=spec,
                            adapter_rank=RANK_R, adapter_grams=grams)
    before = M.COLLECTIVE_BYTES.count
    got = fn(Plane(plane.buf.clone(), plane.meta), protos, counts,
             torch.from_numpy(inp["sizes"]), _rows(ast_np, slice(0, N)))
    sent = M.COLLECTIVE_BYTES.count - before

    _, share_phase, mix_phase = _make_round_parts(
        None, None, C, bits=spec, adapter_rank=RANK_R, adapter_grams=grams)
    st = NodeState(student=Plane(plane.buf.clone(), plane.meta), teacher=None,
                   opt_s={}, opt_t={}, global_protos=None, proto_mask=None,
                   round_idx=None, adapter_state=_rows(ast_np, slice(0, N)))
    st, recv, protos_rx = share_phase(st, protos)
    w_self, w_neigh, include = (torch.from_numpy(x[0]) for x in
                                sched.lower(inp["sizes"]))
    st = mix_phase(st, recv, protos_rx, counts, w_self, w_neigh, include)
    want = st.student.buf.numpy()
    np.testing.assert_allclose(got[0].buf.numpy(), want, rtol=0,
                               atol=_ulp_atol(want))
    assert torch.equal(got[1], st.global_protos)
    assert torch.equal(got[2], st.proto_mask)
    for a, b in zip(_leaves(got[3]), _leaves(st.adapter_state)):
        assert torch.equal(a, b)
    # one rank holding N nodes hands all N copies to the all-gather
    pay_np = {"adapters": _adapter_payload_like(tree_np, grams)["adapters"],
              "model": {"b": np.zeros((N, 12), np.float32)},
              "protos": inp["protos"], "counts": inp["counts"]}
    if grams:
        pay_np["grams"] = _adapter_payload_like(tree_np, grams)["grams"]
    assert sent == N * _copy_bytes(pay_np, "4")


# -- chip_smoke.py's mesh paths ---------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_template(model, n_nodes, algo="profe", **fed_kw):
    """The JAX package's payload template and wire spec of one node at
    ``model``'s full width, as its stacked engine builds them."""
    import types

    import jax
    from repro.config import base as jbase
    from repro.core import federation as JF
    from repro.models import model as jmodel
    from repro.optim import make_optimizer as jmake_optimizer
    from repro.optim import plane as jplane
    jcfg = jbase.get_config(model)
    scfg = jmodel.derive_student(jcfg)
    fed = jbase.FederationConfig(num_nodes=n_nodes, algorithm=algo,
                                 **fed_kw)
    train = jbase.TrainConfig()
    plane = JF._plane_mode(fed, train, algo, scfg)
    opt_t = jmake_optimizer("adamw", 1e-3)
    opt_s = jplane.make_plane_optimizer("adamw", 1e-3) if plane else opt_t
    _, wm, share, bits, cfgs = JF._algo_wiring(algo, jcfg, scfg, fed, train,
                                               opt_s, opt_t, jit=False)
    cfg = cfgs[1] if algo == "profe" else cfgs[0]
    st = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype),
        jax.eval_shape(lambda: jmodel.init_params(cfg,
                                                  jax.random.PRNGKey(0))))
    pay = JF._payload_template(wm, share, types.SimpleNamespace(student=st),
                               JF._n_proto_classes(jcfg),
                               cfg.proto_dim,
                               adapter_rank=fed.adapter_rank,
                               adapter_grams=fed.adapter_grams)
    return pay, bits, st


def test_chip_smoke_mesh_paths_bytes_match_jax():
    """The bytes a rank hands to collectives a round on each of
    ``chip_smoke.py``'s mesh paths: the copies it sends times the JAX
    package's ``packed_copy_bytes`` of its payload template at N = 8
    (FedAvg's on the fp32 wire), or on ``gather`` the int16 codes of the
    student's leaves and the prototypes, a scale each and the counts;
    and the LM path's plane shape and bytes from the JAX package's
    mamba2-130m student."""
    import jax
    import numpy as np
    from repro.core import comm as jcomm
    from repro.optim.plane import plane_from_tree
    smoke = _chip_smoke()
    n = smoke.MESH_NODES
    for name, (topo, exchange, wire, _, _, want, _) in \
            smoke.MESH_PATHS.items():
        spec = smoke.parse_wire(wire)
        fed_kw = dict(smoke.MESH_FED.get(name, {}))
        algo = fed_kw.pop("algorithm", "profe")
        fed_kw.update(smoke.wire_fields(spec))
        pay, bits, st = _jax_template("mnist-cnn", n, algo, **fed_kw)
        copies = 2 if exchange == "ppermute" else 1
        if exchange == "gather":
            leaves = jax.tree_util.tree_leaves(st)
            got = sum(2 * int(np.prod(x.shape)) + 4 for x in leaves) + \
                2 * int(np.prod(pay["protos"].shape)) + 4 + \
                4 * int(np.prod(pay["counts"].shape))
        else:
            got = copies * jcomm.packed_copy_bytes(pay, bits)
        assert got == want, name
    arch = smoke.LM_PATHS["lm/mamba2-130m"][0]
    pay, bits, st = _jax_template(arch, smoke.MESH_LM_RANKS,
                                  quantize_bits=16)
    assert smoke.MESH_LM_BYTES == 2 * jcomm.packed_copy_bytes(pay, bits) \
        == 2 * smoke.LM_PATHS["lm/mamba2-130m"][7][1]
    plane = jax.eval_shape(lambda: plane_from_tree(jax.tree_util.tree_map(
        lambda x: jax.numpy.zeros(x.shape[1:], x.dtype), st)))
    assert smoke.MESH_LM_PLANE == (1,) + tuple(plane.buf.shape)
