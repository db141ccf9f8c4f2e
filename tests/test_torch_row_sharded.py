"""The port's row-sharded permute and the byte accounting of several
ranks a node, held against the JAX package on the CPU.

* ``repro_torch.sharding.row_shard_order``, ``packed_wire_bytes_per_node
  (inner=)``, ``packed_copy_bytes(inner=)`` and
  ``ScheduleCommAccountant.predicted_node_bytes(inner=)`` against the JAX
  package's, exactly.
* The round: 8 gloo ranks, 4 nodes of 2 ranks each, spawned once for the
  whole file; every case runs in that one spawn and each rank saves what
  it saw.  JAX runs the same numpy inputs jitted on its ``(4, 2, 1)``
  ``("pod", "data", "model")`` mesh of 8 virtual CPU devices, the mesh
  ``tests/test_round_engine.py`` runs its row-sharded round on.

What is compared, and how:

* bit for bit: each rank's row block of its node's codes, its scale
  slice and its encoded block bytes against JAX's eager mesh codec
  (``_quantize_with_state``) put in ``row_shard_order``'s order by the
  JAX package's own function and encoded by its ``encode_wire``; the
  ``+ef`` residual and ``seq`` after each round against the same eager
  chain (``tests/test_torch_mesh.py`` says why not the jitted round's);
* exactly: the prototype mask; each rank's wire bytes
  (``COLLECTIVE_BYTES.count``), whose sum over a node's two ranks is
  ``predicted_node_bytes(…, "packed", inner=2)`` on the row-sharded
  permute; its node-group bytes (``.inner``) against the count stated
  from the shapes; and the two ranks of each node, bit-identical;
* within ``atol = 4 ulp`` of the largest magnitude (``STUDENT_ULPS``):
  the mixed students and models and the prototypes (the port mixes
  sender by sender, JAX's jitted round with contracted multiply-adds).
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(2)

N, M = 4, 2
WORLD = N * M
STUDENT_ULPS = 4
DEADLINE_S = 150
# name -> (algorithm, exchange, topology, wire spec, overlap, rounds,
#          prototypes (C, P), student "plane" or "tree")
CASES = {
    "ppermute/16": ("profe", "ppermute", "ring", "16", False, 1, (5, 16),
                    "plane"),
    "ppermute+overlap/16": ("profe", "ppermute", "ring", "16", True, 1,
                            (5, 16), "plane"),
    # both width groups split over the 2 ranks: 2 int16 prototype rows,
    # 6 int4 student and alignment rows
    "ppermute/4/16/split": ("profe", "ppermute", "ring", "4/16", False, 1,
                            (8, 128), "plane"),
    # 1 int16 prototype row and 7 int4 rows: each group takes a pad row
    "ppermute/4/16/pad": ("profe", "ppermute", "ring", "4/16", False, 1,
                          (5, 16), "plane"),
    "auto/4/16/pad": ("profe", "auto", "ring", "4/16", False, 1, (5, 16),
                      "plane"),
    "ppermute/4/16+ef": ("profe", "ppermute", "ring", "4/16+ef", False, 2,
                         (5, 16), "plane"),
    "ppermute/16/per-leaf": ("profe", "ppermute", "ring", "16", False, 1,
                             (5, 16), "tree"),
    "packed/16": ("profe", "packed", "ring", "16", False, 1, (5, 16),
                  "plane"),
    "gather/16": ("profe", "gather", "ring", "16", False, 1, (5, 16),
                  "plane"),
    "packed-full/16": ("profe", "packed", None, "16", False, 1, (5, 16),
                       "plane"),
    "fedavg/ppermute": ("fedavg", "ppermute", "ring", "fp32", False, 1,
                        (5, 16), "plane"),
    "fedavg/packed": ("fedavg", "packed", "ring", "fp32", False, 1, (5, 16),
                      "plane"),
}
ROW_SHARDED = tuple(n for n, c in CASES.items()
                    if c[0] == "profe" and c[1] in ("ppermute", "auto"))


def _inputs(rnd: int, cp):
    """Round ``rnd``'s numpy inputs for all N nodes: a two-leaf student,
    prototypes ``[N, C, P]``, class counts and dataset sizes."""
    c, p = cp
    rng = np.random.default_rng(200 + rnd)
    counts = rng.integers(0, 4, (N, c)).astype(np.float32)
    counts[0, 1] = 0.0                # a class node 0 never saw
    counts[:, 4] = 0.0                # a class nobody saw (mask 0)
    return {"w": rng.standard_normal((N, 33, 20)).astype(np.float32),
            "b": rng.standard_normal((N, 7)).astype(np.float32),
            "protos": rng.standard_normal((N, c, p)).astype(np.float32),
            "counts": counts,
            "sizes": rng.integers(50, 200, (N,)).astype(np.float32)}


def _torch_student(inp, i, kind):
    from repro_torch.optim.plane import Plane, plane_from_tree
    tree = {"w": torch.from_numpy(inp["w"][i:i + 1]),
            "b": torch.from_numpy(inp["b"][i:i + 1])}
    if kind == "tree":
        return tree
    one = plane_from_tree({k: v[0] for k, v in tree.items()})
    return Plane(one.buf[None], one.meta)


def _student_buf(x):
    return x.buf if hasattr(x, "buf") else torch.cat(
        [x["b"].reshape(1, -1), x["w"].reshape(1, -1)], dim=1)


# -- the ranks -------------------------------------------------------------

def _run_case(rank: int, case):
    from repro_torch.core import mesh_federation as M_
    from repro_torch.core import topology as T
    from repro_torch.core.wire_state import init_codec_state
    from repro_torch.wirespec import WireSpec
    algo, exchange, topo, wire, overlap, rounds, cp, kind = case
    node, k = rank // M, rank % M
    adj = None if topo is None else T.adjacency(N, topo)
    spec = None if wire == "fp32" else WireSpec.parse(wire)
    if algo == "fedavg":
        fn = M_.make_fedavg_round(adjacency=adj, exchange=exchange,
                                  ranks_per_node=M)
    else:
        fn = M_.make_profe_round(adjacency=adj, exchange=exchange, spec=spec,
                                 overlap=overlap, ranks_per_node=M)
    state, out = None, []
    for rnd in range(rounds):
        inp = _inputs(rnd, cp)
        sl = slice(node, node + 1)
        students = _torch_student(inp, node, kind)
        sizes = torch.from_numpy(inp["sizes"])
        counts = torch.from_numpy(inp["counts"][sl])
        protos = torch.from_numpy(inp["protos"][sl])
        c = M_.COLLECTIVE_BYTES
        before = (c.count, c.inner, dict(c.by_kind))
        if algo == "fedavg":
            res = fn(students, sizes)
            out.append({"student": _student_buf(res).clone(),
                        "bytes": c.count - before[0],
                        "inner": c.inner - before[1]})
            continue
        if spec.error_feedback and state is None:
            state = init_codec_state({"protos": protos, "student": students},
                                     n_nodes=1)
        buf, seg_ids, meta, _, _ = M_._pack_payload(protos, students, spec)
        codes, scales, _ = M_._quantize_with_state(spec, buf, seg_ids, meta,
                                                   state)
        blk = M_._row_block(buf, codes, scales, counts, seg_ids, meta[3], M,
                            k)
        before = (c.count, c.inner, dict(c.by_kind))
        res = fn(students, protos, counts, sizes,
                 *([state] if spec.error_feedback else []))
        rec = {"bytes": c.count - before[0], "inner": c.inner - before[1],
               "by_kind": {kk: v - before[2].get(kk, 0)
                           for kk, v in c.by_kind.items()
                           if v - before[2].get(kk, 0)},
               "codes": blk.codes.clone(), "scales": blk.scales.clone(),
               "wire": blk.wire.clone(), "counts": blk.counts.clone(),
               "student": _student_buf(res[0]).clone(), "protos": res[1],
               "mask": res[2]}
        if spec.error_feedback:
            state = res[3]
            rec.update(res_protos=state.residual["protos"],
                       res_student=state.residual["student"].buf,
                       seq=state.seq)
        out.append(rec)
    return out


def _adapter_refusal():
    """The adapter wire on the row-sharded permute raises (all ranks make
    the call, so the group creation in it stays collective)."""
    from repro_torch.core import mesh_federation as M_
    from repro_torch.core import topology as T
    try:
        M_.make_profe_round(adjacency=T.adjacency(N, "ring"),
                            exchange="ppermute", adapter_rank=8,
                            ranks_per_node=M)
    except ValueError as e:
        return str(e)
    return None


def _rank_main(rank: int, world: int, init: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        results = {name: _run_case(rank, case)
                   for name, case in CASES.items()}
        results["adapter_refusal"] = _adapter_refusal()
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, tmp, *args):
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
    tmp = tmp_path_factory.mktemp("row_sharded")
    _spawn(_rank_main, WORLD, tmp, str(tmp))
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


# -- the JAX side ----------------------------------------------------------

def _pod_mesh():
    import jax
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:WORLD]).reshape(N, M, 1)
    return Mesh(devs, ("pod", "data", "model"))


def _jax_student(inp, kind):
    import jax
    import jax.numpy as jnp
    from repro.optim.plane import plane_from_tree
    tree = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    return tree if kind == "tree" else jax.vmap(plane_from_tree)(tree)


def _jax_buf(x):
    if hasattr(x, "buf"):
        return np.asarray(x.buf)
    return np.concatenate([np.asarray(x["b"]).reshape(N, -1),
                           np.asarray(x["w"]).reshape(N, -1)], axis=1)


def _jax_blocks(codes, scales, counts, seg_ids, seg_bits):
    """JAX's eager codec put in row-shard order: each node's ``[M]``
    blocks of codes, encoded bytes, scale slices and count slices."""
    import jax.numpy as jnp
    from repro.kernels.quantize import ops as JQ
    from repro.sharding import row_shard_order
    codes, scales, counts = (np.asarray(x) for x in (codes, scales, counts))
    ids = np.asarray(seg_ids)
    order, _, local_bits = row_shard_order(np.asarray(seg_bits)[ids], M)
    rloc = len(order) // M
    full = np.pad(codes, ((0, 0), (0, len(order) - len(ids)), (0, 0)))
    full = full[:, order]

    def part(x):
        w = x.shape[1] + (-x.shape[1]) % M
        return np.pad(x, ((0, 0), (0, w - x.shape[1])))

    sc, cn = part(scales), part(counts)
    out = []
    for k in range(M):
        blk = full[:, k * rloc:(k + 1) * rloc]
        out.append({"codes": blk,
                    "wire": np.asarray(JQ.encode_wire(
                        jnp.asarray(blk), np.arange(rloc),
                        seg_bits=local_bits)),
                    "scales": sc[:, k * sc.shape[1] // M:
                                 (k + 1) * sc.shape[1] // M],
                    "counts": cn[:, k * cn.shape[1] // M:
                                 (k + 1) * cn.shape[1] // M]})
    return out


def _jax_case(case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec
    from repro.core import mesh_federation as JM
    from repro.core import topology as JT
    from repro.core.wire_state import init_codec_state
    from repro.wirespec import WireSpec
    algo, exchange, topo, wire, overlap, rounds, cp, kind = case
    mesh = _pod_mesh()
    adj = None if topo is None else JT.adjacency(N, topo)
    specs = {"w": Pspec(None, None), "b": Pspec(None)}
    if algo == "fedavg":
        fn = jax.jit(JM.make_fedavg_round(mesh, specs, adjacency=adj,
                                          exchange=exchange))
        inp = _inputs(0, cp)
        with mesh:
            res = fn(_jax_student(inp, kind), jnp.asarray(inp["sizes"]))
        return [{"student": _jax_buf(res)}]
    spec = WireSpec.parse(wire)
    fn = jax.jit(JM.make_profe_round(mesh, specs, adjacency=adj,
                                     exchange=exchange, spec=spec,
                                     overlap=overlap))
    state, out = None, []
    for rnd in range(rounds):
        inp = _inputs(rnd, cp)
        students = _jax_student(inp, kind)
        counts = jnp.asarray(inp["counts"])
        protos = jnp.asarray(inp["protos"])
        if spec.error_feedback and state is None:
            state = init_codec_state({"protos": protos, "student": students})
        with mesh:
            res = fn(students, protos, counts, jnp.asarray(inp["sizes"]),
                     *([state] if spec.error_feedback else []))
            buf, seg_ids, meta, _, _ = JM._pack_payload(protos, students,
                                                        spec)
            codes, scales, state = JM._quantize_with_state(
                mesh, spec, buf, seg_ids, meta, state)
        rec = {"student": _jax_buf(res[0]), "protos": np.asarray(res[1]),
               "mask": np.asarray(res[2]),
               "blocks": _jax_blocks(codes, scales, counts, seg_ids,
                                     meta[4])}
        if spec.error_feedback:
            rec.update(res_protos=np.asarray(state.residual["protos"]),
                       res_student=np.asarray(state.residual["student"].buf),
                       seq=int(state.seq))
        out.append(rec)
    return out


def _ulp_atol(x) -> float:
    return STUDENT_ULPS * float(np.spacing(np.float32(np.abs(x).max())))


def _payload(cp, *, dense=False):
    from repro_torch.tree import ShapeDtypeStruct
    f32 = np.dtype(np.float32)
    c, p = cp
    out = {"model": {"b": ShapeDtypeStruct((7,), f32),
                     "w": ShapeDtypeStruct((33, 20), f32)}}
    if not dense:
        out.update(protos=ShapeDtypeStruct((c, p), f32),
                   counts=ShapeDtypeStruct((c,), f32))
    return out


def _wire_bytes(case) -> int:
    """The bytes a rank hands to its pod group a round.  Row-sharded:
    its two steps' share of ``packed_copy_bytes(inner=2)``; replicated:
    the one-rank-a-node round's (``packed``: one copy; ``gather``: each
    leaf's int16 codes, its scale and the counts; FedAvg on ``ppermute``:
    two steps of the fp32 rows)."""
    from repro_torch.core.comm import packed_copy_bytes
    from repro_torch.wirespec import WireSpec
    algo, exchange, topo, wire, _, _, cp, _ = case
    c, p = cp
    if algo == "fedavg":
        rows = packed_copy_bytes(_payload(cp, dense=True), None)
        return rows * (2 if exchange == "ppermute" else 1)
    spec = WireSpec.parse(wire)
    if exchange in ("ppermute", "auto"):
        return 2 * packed_copy_bytes(_payload(cp), spec, inner=M) // M
    if exchange == "gather":
        return (33 * 20 + 7 + c * p) * 2 + 3 * 4 + c * 4
    return packed_copy_bytes(_payload(cp), spec)


def _inner_bytes(case, blk) -> int:
    """The node-group bytes a rank hands on the row-sharded permute a
    round: a step's scale and count slices to the widening all-gather,
    the two steps' prototype rows ``[2, rows, 512]`` to the all-reduce,
    its mixed block ``[R'/2, 512]`` to the final all-gather; none
    replicated."""
    algo, exchange, _, _, _, _, cp, _ = case
    if algo == "fedavg" or exchange not in ("ppermute", "auto"):
        return 0
    c, p = cp
    proto_rows = -(-c * p // 512)
    rloc = blk["codes"].shape[1]
    side = blk["scales"].shape[1] + blk["counts"].shape[1]
    return 4 * (2 * side + 2 * proto_rows * 512 + rloc * 512)


@pytest.mark.parametrize("name", list(CASES))
def test_row_sharded_round_matches_jax(rank_results, name):
    from repro_torch.core.comm import ScheduleCommAccountant
    from repro_torch.core import topology as T
    from repro_torch.wirespec import WireSpec
    case = CASES[name]
    algo, exchange, topo, wire, _, rounds, cp, _ = case
    want = _jax_case(case)
    row_sharded = name in ROW_SHARDED
    for rank, res in enumerate(rank_results):
        got = res[name]
        node, k = rank // M, rank % M
        assert len(got) == rounds
        for rnd, (g, w) in enumerate(zip(got, want)):
            where = f"{name} rank {rank} round {rnd}"
            sw = w["student"][node:node + 1]
            np.testing.assert_allclose(g["student"].numpy(), sw, rtol=0,
                                       atol=_ulp_atol(sw), err_msg=where)
            assert g["bytes"] == _wire_bytes(case), where
            if algo == "fedavg":
                assert g["inner"] == 0, where
                continue
            jb = w["blocks"][k]
            for key in ("codes", "wire", "scales", "counts"):
                np.testing.assert_array_equal(
                    g[key].numpy(), jb[key][node:node + 1],
                    err_msg=f"{where}: {key}")
            assert g["inner"] == _inner_bytes(case, jb), where
            if row_sharded:
                assert set(g["by_kind"]) == {"collective-permute"}, where
            pw = w["protos"] if topo is None else w["protos"][node:node + 1]
            mw = w["mask"] if topo is None else w["mask"][node:node + 1]
            np.testing.assert_allclose(g["protos"].numpy(), pw, rtol=0,
                                       atol=_ulp_atol(pw), err_msg=where)
            np.testing.assert_array_equal(g["mask"].numpy(), mw,
                                          err_msg=where)
            if "+ef" in wire:
                np.testing.assert_array_equal(
                    g["res_protos"].numpy(), w["res_protos"][node:node + 1],
                    err_msg=where)
                np.testing.assert_array_equal(
                    g["res_student"].numpy(),
                    w["res_student"][node:node + 1], err_msg=where)
                assert g["seq"].tolist() == [w["seq"]] == [rnd + 1]
    # the two ranks of a node end bit-identical
    for node in range(N):
        a, b = rank_results[M * node][name], rank_results[M * node + 1][name]
        for ra, rb in zip(a, b):
            for key in ("student", "protos", "mask", "res_protos",
                        "res_student"):
                if key in ra:
                    assert torch.equal(ra[key], rb[key]), (name, node, key)
    if row_sharded:
        # a node's wire bytes are the accountant's packed prediction
        spec = WireSpec.parse(wire)
        pred = ScheduleCommAccountant(T.make_schedule(N, topo)) \
            .predicted_node_bytes(_payload(cp), 0, spec, "packed", inner=M)
        for node in range(N):
            sent = sum(rank_results[M * node + k][name][0]["bytes"]
                       for k in range(M))
            assert sent == int(pred[node]), (name, node, sent, pred)


def test_adapter_row_sharded_permute_raises_like_jax(rank_results):
    """The adapter wire has no row-sharded permute: the port raises JAX's
    ``ValueError`` on every rank."""
    from jax.sharding import PartitionSpec as Pspec
    from repro.core import mesh_federation as JM
    from repro.core import topology as JT
    with pytest.raises(ValueError) as e:
        JM.make_profe_round(_pod_mesh(), {"w": Pspec(None, None)},
                            adjacency=JT.adjacency(N, "ring"),
                            exchange="ppermute", adapter_rank=8)
    for res in rank_results:
        assert res["adapter_refusal"] == str(e.value)


# -- the static row order and the byte accounting ---------------------------

@pytest.mark.parametrize("inner", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_row_shard_order_matches_jax(inner, seed):
    from repro.sharding import row_shard_order as jax_order
    from repro_torch.sharding import row_shard_order
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 40))
    bits = rng.choice(np.asarray([4, 8, 16], np.int32), r)
    got, want = row_shard_order(bits, inner), jax_order(bits, inner)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    order, inv, local = got
    assert len(order) % inner == 0 and len(inv) == r
    np.testing.assert_array_equal(order[inv], np.arange(r))


def _arch_payloads():
    """The accountant's payload skeletons of mnist-cnn and ResNet8 (the
    CIFAR student), in both packages, and the adapter payload."""
    from repro.launch.wire import _student_setup, accountant_payload
    from repro_torch.launch import wire as W
    out = {}
    for arch in ("mnist-cnn", "cifar10-resnet18"):
        _, scfg, struct, ncls = _student_setup(arch)
        _, tscfg, tstruct, tncls = W.student_setup(arch)
        out[arch] = (accountant_payload(struct, ncls, scfg.proto_dim),
                     W.accountant_payload(tstruct, tncls, tscfg.proto_dim))
    _, scfg, struct, ncls = _student_setup("mnist-cnn")
    _, tscfg, tstruct, tncls = W.student_setup("mnist-cnn")
    out["mnist-cnn/adapters8"] = (
        accountant_payload(struct, ncls, scfg.proto_dim, adapter_rank=8),
        W.accountant_payload(tstruct, tncls, tscfg.proto_dim,
                             adapter_rank=8))
    return out


PAYLOADS = ("mnist-cnn", "cifar10-resnet18", "mnist-cnn/adapters8")
SPECS = ("16", "4/16", "4/16+ef", "8", "fp32")


@pytest.fixture(scope="module")
def payloads():
    return _arch_payloads()


@pytest.mark.parametrize("wire", SPECS)
@pytest.mark.parametrize("payload", PAYLOADS)
def test_packed_bytes_match_jax(payloads, payload, wire):
    """``packed_copy_bytes``, ``predicted_node_bytes`` and
    ``packed_wire_bytes_per_node`` at ``inner`` 1, 2, 4 and 8 against
    the JAX package's, exactly."""
    from repro.core.comm import ScheduleCommAccountant as JAcct
    from repro.core.comm import packed_copy_bytes as jcopy
    from repro.core.topology import make_schedule as jsched
    from repro.kernels.quantize.ops import packed_wire_bytes_per_node as jwb
    from repro.wirespec import WireSpec as JW
    from repro_torch.core.comm import ScheduleCommAccountant, packed_copy_bytes
    from repro_torch.core.topology import make_schedule
    from repro_torch.kernels.quantize.ops import packed_wire_bytes_per_node
    from repro_torch.wirespec import WireSpec
    jp, tp = payloads[payload]
    jb = None if wire == "fp32" else JW.parse(wire)
    tb = None if wire == "fp32" else WireSpec.parse(wire)
    jacct = JAcct(jsched(4, "ring"))
    tacct = ScheduleCommAccountant(make_schedule(4, "ring"))
    for inner in (1, 2, 4, 8):
        assert packed_copy_bytes(tp, tb, inner=inner) == \
            jcopy(jp, jb, inner=inner), inner
        np.testing.assert_array_equal(
            tacct.predicted_node_bytes(tp, 0, tb, "packed", inner=inner),
            jacct.predicted_node_bytes(jp, 0, jb, "packed", inner=inner))
        floats = {k: v for k, v in tp.items() if k != "counts"}
        jfloats = {k: v for k, v in jp.items() if k != "counts"}
        for bits in (None, 4, 16):
            assert packed_wire_bytes_per_node(floats, bits, inner=inner) == \
                jwb(jfloats, bits, node_axis=False, inner=inner)
        if tb is not None:
            from repro_torch.tree import tree_leaves
            lb = [4 if i % 3 else 16
                  for i in range(len(tree_leaves(floats)))]
            assert packed_wire_bytes_per_node(floats, 16, leaf_bits=lb,
                                              inner=inner) == \
                jwb(jfloats, 16, node_axis=False, leaf_bits=lb, inner=inner)
    np.testing.assert_array_equal(
        tacct.predicted_node_bytes(tp, 0, tb, "dense"),
        jacct.predicted_node_bytes(jp, 0, jb, "dense"))
    with pytest.raises(ValueError, match="wire must be"):
        tacct.predicted_node_bytes(tp, 0, tb, "sparse")


def test_packed_copy_bytes_motivation_numbers(payloads):
    """The numbers the wire audit stands on: mnist-cnn's copy at inner 1,
    2, 4 and 8 (the ``4/16`` copy grows by the pad rows)."""
    from repro_torch.core.comm import packed_copy_bytes
    from repro_torch.wirespec import WireSpec
    tp = payloads["mnist-cnn"][1]
    want = {"16": (426060, 426064, 426080, 426112),
            "4/16": (108876, 110160, 110688, 114816),
            "4/16+ef": (108876, 110160, 110688, 114816)}
    for wire, nums in want.items():
        got = tuple(packed_copy_bytes(tp, WireSpec.parse(wire), inner=i)
                    for i in (1, 2, 4, 8))
        assert got == nums, wire


def test_chip_smoke_row_sharded_constants_match_jax():
    """``chip_smoke.py``'s several-ranks-a-node constants from the JAX
    package's accountant: a rank's pod bytes a round on the 4 × 2 mnist
    paths (2 steps of half ``packed_copy_bytes(inner=2)``, or one whole
    copy replicated), and mamba2-130m's at full width with its row block
    ``[1, R/2, 512]``."""
    import importlib.util
    from pathlib import Path

    import jax
    from repro.config import get_config
    from repro.core.comm import packed_copy_bytes as jcopy
    from repro.kernels.quantize.ops import packed_wire_rows
    from repro.launch.wire import _student_setup, accountant_payload
    from repro.models import derive_student, init_params
    from repro.wirespec import WireSpec as JW
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    m = smoke.MESH_RANKS_PER_NODE
    _, scfg, struct, ncls = _student_setup("mnist-cnn")
    pay = accountant_payload(struct, ncls, scfg.proto_dim)
    for name, (_, exchange, wire, _, _, want, mix) in \
            smoke.MESH_ROW_PATHS.items():
        bits = JW.parse(wire)
        got = 2 * jcopy(pay, bits, inner=m) // m if exchange == "ppermute" \
            else jcopy(pay, bits)
        assert got == want, name
        assert mix == (2 if exchange == "ppermute" else 1), name
    cfg = get_config("mamba2-130m")
    lm_cfg = derive_student(cfg)
    lm = jax.eval_shape(lambda: init_params(lm_cfg, jax.random.PRNGKey(0)))
    lpay = accountant_payload(lm, cfg.n_proto_classes, lm_cfg.proto_dim)
    assert smoke.MESH_LM_4X2_BYTES == jcopy(lpay, 16, inner=m) \
        == jcopy(lpay, 16) == smoke.MESH_LM_BYTES // 2
    rows, _ = packed_wire_rows({k: v for k, v in lpay.items()
                                if k != "counts"}, node_axis=False)
    assert smoke.MESH_LM_BLOCK == (1, rows // m, 512)
    assert smoke.NEW_PATHS == tuple(smoke.MESH_ROW_PATHS) + \
        (smoke.MESH_LM_4X2,)
