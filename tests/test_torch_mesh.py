"""The port's multi-node exchange (``repro_torch.core.mesh_federation``),
held against the JAX package's ``make_profe_round`` on ``fed_mesh(4)``.

The port's round runs on 4 gloo ranks, spawned once for the whole file
(one node per rank); every exchange, overlap, spec and proto-pass case
runs in that one spawn and each rank saves what it saw.  JAX runs the
same numpy inputs on 4 virtual CPU devices (``tests/conftest.py``).
JAX is imported inside the tests only: the spawned ranks import this
module and load torch alone.

What is compared, and how:

* bit for bit: each rank's codes, segment scales and encoded wire bytes
  against the JAX mesh codec (``_quantize_with_state`` and
  ``encode_wire``, run eagerly), and the carried error-feedback residual
  and ``seq`` after each round against the same eager chain.  The
  jitted JAX round contracts the residual update ``eff - codes·Δ`` into
  an FMA on the CPU (ROADMAP queue 3), so its residual is not the
  oracle; its second ``+ef`` round is fed the eager chain's state, which
  the port's state equals;
* within ``atol = 4 ulp`` of the largest magnitude (``STUDENT_ULPS``):
  the mixed students and the prototypes.  The port mixes sender by
  sender in the mix kernel's order, the JAX round by ``einsum`` with
  contracted multiply-adds: the same products, summed in another order
  over at most N + 1 terms (2 ulp measured);
* exactly: the prototype mask, and each rank's bytes handed to
  collectives, which must be the permutation steps it sends in (or its
  one all-gathered copy) times ``packed_copy_bytes`` of
  ``{model, protos, counts}``.

One rank holding all the nodes (``exchange="packed"``, in this process)
is held against the port's own stacked engine, ``share_phase`` then
``mix_phase``: prototypes, mask and residual bit for bit (the same codec
and the same Eq. 4 on the same dequantized view), students within 4 ulp
(the mix sums sender by sender where the engine's ``tensordot`` sums in
its own order, and its fp32 gossip weights are rounded once from
float64).
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
STUDENT_ULPS = 4
DEADLINE_S = 120
# name -> (exchange, topology, wire spec, overlap, proto pass, rounds)
CASES = {
    "ppermute/16": ("ppermute", "ring", "16", False, "exact", 1),
    "ppermute+overlap/16": ("ppermute", "ring", "16", True, "exact", 1),
    "packed-ring/16": ("packed", "ring", "16", False, "exact", 1),
    "packed-full/16": ("packed", None, "16", False, "exact", 1),
    "ppermute/4/16+ef": ("ppermute", "ring", "4/16+ef", False, "exact", 2),
    "ppermute+overlap/4/16+ef": ("ppermute", "ring", "4/16+ef", True,
                                 "exact", 2),
    "packed-ring/4/16+ef": ("packed", "ring", "4/16+ef", False, "exact", 2),
    "packed-full/4/16+ef": ("packed", None, "4/16+ef", False, "exact", 2),
    "ppermute/16/fused": ("ppermute", "ring", "16", False, "fused", 1),
}


def _inputs(rnd: int):
    """Round ``rnd``'s numpy inputs for all N nodes: a small two-leaf
    student, prototypes (or, for the fused pass, raw sums), class
    counts and dataset sizes."""
    rng = np.random.default_rng(100 + rnd)
    counts = rng.integers(0, 4, (N, C)).astype(np.float32)
    counts[0, 1] = 0.0                # a class node 0 never saw
    counts[:, 4] = 0.0                # a class nobody saw (mask 0)
    return {"w": rng.standard_normal((N, 33, 20)).astype(np.float32),
            "b": rng.standard_normal((N, 7)).astype(np.float32),
            "protos": rng.standard_normal((N, C, P)).astype(np.float32),
            "counts": counts,
            "sizes": rng.integers(50, 200, (N,)).astype(np.float32)}


def _torch_plane(inp, nodes):
    from repro_torch.optim.plane import Plane, plane_from_tree
    planes = [plane_from_tree({"w": torch.from_numpy(inp["w"][i]),
                               "b": torch.from_numpy(inp["b"][i])})
              for i in nodes]
    return Plane(torch.stack([p.buf for p in planes]), planes[0].meta)


def _sums(inp):
    """The raw Eq. 3 accumulators whose normalization is ``protos``."""
    return inp["protos"] * np.maximum(inp["counts"], 1.0)[..., None]


# -- the ranks -------------------------------------------------------------

def _run_case(rank: int, case):
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import topology as T
    from repro_torch.core.profe import normalize_protos
    from repro_torch.core.wire_state import init_codec_state
    from repro_torch.wirespec import WireSpec
    exchange, topo, wire, overlap, proto_pass, rounds = case
    spec = WireSpec.parse(wire)
    adj = None if topo is None else T.adjacency(N, topo)
    fn = M.make_profe_round(adjacency=adj, exchange=exchange, spec=spec,
                            overlap=overlap, proto_pass=proto_pass)
    state, out = None, []
    for rnd in range(rounds):
        inp = _inputs(rnd)
        sl = slice(rank, rank + 1)
        students = _torch_plane(inp, [rank])
        counts = torch.from_numpy(inp["counts"][sl])
        protos = torch.from_numpy(inp["protos"][sl])
        arg = torch.from_numpy(_sums(inp)[sl]) if proto_pass == "fused" \
            else protos
        if spec.error_feedback and state is None:
            state = init_codec_state({"protos": protos, "student": students},
                                     n_nodes=1)
        sent = M._send_side(normalize_protos(arg, counts) if proto_pass ==
                            "fused" else arg, students, spec, state)
        before = M.COLLECTIVE_BYTES.count
        res = fn(students, arg, counts, torch.from_numpy(inp["sizes"]),
                 *([state] if spec.error_feedback else []))
        rec = {"bytes": M.COLLECTIVE_BYTES.count - before,
               "codes": sent.codes, "scales": sent.scales,
               "wire": sent.wire.clone(),
               "student": res[0].buf, "protos": res[1], "mask": res[2]}
        if spec.error_feedback:
            state = res[3]
            rec.update(res_protos=state.residual["protos"],
                       res_student=state.residual["student"].buf,
                       seq=state.seq)
        out.append(rec)
    return out


def _rank_main(rank: int, world: int, init: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        results = {name: _run_case(rank, case)
                   for name, case in CASES.items()}
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
    tmp = tmp_path_factory.mktemp("mesh")
    _spawn(_rank_main, N, tmp, str(tmp))
    return [torch.load(tmp / f"rank{r}.pt") for r in range(N)]


# -- the JAX side ----------------------------------------------------------

def _jax_case(case):
    """JAX's jitted round outputs per round, and the eager mesh codec's
    codes, scales, wire bytes and carried state per round."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec
    from repro.core import mesh_federation as JM
    from repro.core import topology as JT
    from repro.core.profe import normalize_protos
    from repro.core.wire_state import init_codec_state
    from repro.kernels.quantize import ops as JQ
    from repro.launch.wire import fed_mesh
    from repro.optim.plane import plane_from_tree
    from repro.wirespec import WireSpec
    exchange, topo, wire, overlap, proto_pass, rounds = case
    spec = WireSpec.parse(wire)
    mesh = fed_mesh(N)
    adj = None if topo is None else JT.adjacency(N, topo)
    fn = jax.jit(JM.make_profe_round(
        mesh, {"w": Pspec(None, None), "b": Pspec(None)}, adjacency=adj,
        exchange=exchange, spec=spec, overlap=overlap,
        proto_pass=proto_pass))
    state, out = None, []
    for rnd in range(rounds):
        inp = _inputs(rnd)
        plane = jax.vmap(plane_from_tree)({"w": jnp.asarray(inp["w"]),
                                           "b": jnp.asarray(inp["b"])})
        counts = jnp.asarray(inp["counts"])
        protos = jnp.asarray(inp["protos"])
        arg = jnp.asarray(_sums(inp)) if proto_pass == "fused" else protos
        if spec.error_feedback and state is None:
            state = init_codec_state({"protos": protos, "student": plane})
        with mesh:
            res = fn(plane, arg, counts, jnp.asarray(inp["sizes"]),
                     *([state] if spec.error_feedback else []))
            buf, seg_ids, meta, _, _ = JM._pack_payload(
                normalize_protos(arg, counts) if proto_pass == "fused"
                else arg, plane, spec)
            codes, scales, state = JM._quantize_with_state(
                mesh, spec, buf, seg_ids, meta, state)
        rec = {"student": np.asarray(res[0].buf), "protos": np.asarray(res[1]),
               "mask": np.asarray(res[2]), "codes": np.asarray(codes),
               "scales": np.asarray(scales),
               "wire": np.asarray(JQ.encode_wire(codes, seg_ids,
                                                 seg_bits=meta[4]))}
        if spec.error_feedback:
            rec.update(res_protos=np.asarray(state.residual["protos"]),
                       res_student=np.asarray(state.residual["student"].buf),
                       seq=int(state.seq))
        out.append(rec)
    return out


def _ulp_atol(x) -> float:
    return STUDENT_ULPS * float(np.spacing(np.float32(np.abs(x).max())))


def _copy_bytes(wire: str) -> int:
    from repro_torch.core.comm import packed_copy_bytes
    from repro_torch.tree import ShapeDtypeStruct
    from repro_torch.wirespec import WireSpec
    f32 = np.dtype(np.float32)
    payload = {"model": {"b": ShapeDtypeStruct((7,), f32),
                         "w": ShapeDtypeStruct((33, 20), f32)},
               "protos": ShapeDtypeStruct((C, P), f32),
               "counts": ShapeDtypeStruct((C,), f32)}
    return packed_copy_bytes(payload, WireSpec.parse(wire))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_round_matches_jax(rank_results, name):
    exchange, topo, wire, overlap, proto_pass, rounds = CASES[name]
    want = _jax_case(CASES[name])
    # a ring rank sends in both permutation steps; a packed rank hands one
    # copy of its node to the all-gather
    copies = 2 if exchange == "ppermute" else 1
    for rank, res in enumerate(rank_results):
        got = res[name]
        assert len(got) == rounds
        for rnd, (g, w) in enumerate(zip(got, want)):
            where = f"{name} rank {rank} round {rnd}"
            for key in ("codes", "scales", "wire"):
                np.testing.assert_array_equal(
                    g[key].numpy(), w[key][rank:rank + 1],
                    err_msg=f"{where}: {key}")
            assert g["wire"].dtype == torch.int8
            assert g["bytes"] == copies * _copy_bytes(wire), where
            sw = w["student"][rank:rank + 1]
            np.testing.assert_allclose(g["student"].numpy(), sw, rtol=0,
                                       atol=_ulp_atol(sw), err_msg=where)
            pw = w["protos"] if topo is None else w["protos"][rank:rank + 1]
            mw = w["mask"] if topo is None else w["mask"][rank:rank + 1]
            np.testing.assert_allclose(g["protos"].numpy(), pw, rtol=0,
                                       atol=_ulp_atol(pw), err_msg=where)
            np.testing.assert_array_equal(g["mask"].numpy(), mw,
                                          err_msg=where)
            if "+ef" in wire:
                np.testing.assert_array_equal(
                    g["res_protos"].numpy(), w["res_protos"][rank:rank + 1],
                    err_msg=where)
                np.testing.assert_array_equal(
                    g["res_student"].numpy(),
                    w["res_student"][rank:rank + 1], err_msg=where)
                assert g["seq"].tolist() == [w["seq"]] == [rnd + 1]
                assert float(g["res_student"].abs().max()) > 0
    if topo is not None:
        # sparse gossip keeps the nodes distinct
        assert not torch.equal(rank_results[0][name][0]["student"],
                               rank_results[2][name][0]["student"])


# -- one rank holding every node, against the stacked engine ----------------

@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("wire", ["16", "4/16+ef"])
def test_one_rank_packed_round_matches_stacked_share_and_mix(one_rank_group,
                                                             wire):
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import topology as T
    from repro_torch.core.federation import _make_round_parts
    from repro_torch.core.profe import NodeState
    from repro_torch.core.wire_state import init_codec_state
    from repro_torch.optim.plane import Plane
    from repro_torch.wirespec import WireSpec
    n = 8
    spec = WireSpec.parse(wire)
    rng = np.random.default_rng(7)
    plane = _torch_plane({"w": rng.standard_normal((n, 33, 20)).astype(
        np.float32), "b": rng.standard_normal((n, 7)).astype(np.float32)},
        range(n))
    protos = torch.from_numpy(rng.standard_normal((n, C, P)).astype(
        np.float32))
    counts = torch.from_numpy(rng.integers(0, 4, (n, C)).astype(np.float32))
    sizes = rng.integers(50, 200, (n,)).astype(np.float32)
    sched = T.make_schedule(n, "ring")
    state = None
    if spec.error_feedback:
        # a carried residual of the size error feedback leaves behind
        state = init_codec_state({"protos": protos, "student": plane}, n)
        state.residual["protos"].copy_(protos * 1e-4)
        state.residual["student"].buf.copy_(plane.buf * 1e-3)

    fn = M.make_profe_round(one_rank_group, adjacency=sched.adjacency_at(0),
                            exchange="packed", spec=spec)
    before = M.COLLECTIVE_BYTES.count
    got = fn(Plane(plane.buf.clone(), plane.meta), protos, counts,
             torch.from_numpy(sizes),
             *([state] if state is not None else []))
    sent = M.COLLECTIVE_BYTES.count - before

    _, share_phase, mix_phase = _make_round_parts(None, None, C, bits=spec)
    st = NodeState(student=Plane(plane.buf.clone(), plane.meta), teacher=None,
                   opt_s={}, opt_t={}, global_protos=None, proto_mask=None,
                   round_idx=None, wire_state=state)
    st, recv_student, protos_rx = share_phase(st, protos)
    w_self, w_neigh, include = (torch.from_numpy(x[0])
                                for x in sched.lower(sizes))
    st = mix_phase(st, recv_student, protos_rx, counts, w_self, w_neigh,
                   include)

    want = st.student.buf.detach().numpy()
    np.testing.assert_allclose(got[0].buf.numpy(), want, rtol=0,
                               atol=_ulp_atol(want))
    assert torch.equal(got[1], st.global_protos)
    assert torch.equal(got[2], st.proto_mask)
    if state is not None:
        assert torch.equal(got[3].residual["protos"],
                           st.wire_state.residual["protos"])
        assert torch.equal(got[3].residual["student"].buf,
                           st.wire_state.residual["student"].buf)
        assert got[3].seq.tolist() == st.wire_state.seq.tolist() == [1] * n
    # one rank holding n nodes hands all n copies to the all-gather
    assert sent == n * _copy_bytes(wire)


# -- the host-side pieces against the JAX package ----------------------------

@pytest.mark.parametrize("integer_sizes", [True, False],
                         ids=["integer-sizes", "float-sizes"])
def test_gossip_matrix_dyn_matches_jax(integer_sizes):
    """Integer dataset sizes give exact sums, so the weights are
    bit-identical; fractional sizes are held to 1 ulp (the row sums may
    round in another order)."""
    from repro.core.round_ops import gossip_matrix_dyn as jax_dyn
    from repro_torch.core import topology as T
    from repro_torch.core.round_ops import gossip_matrix_dyn
    rng = np.random.default_rng(3)
    n = 8
    sizes = (rng.integers(50, 200, (n,)) if integer_sizes
             else rng.random(n) * 100).astype(np.float32)
    for topo in ("ring", "star", "random-k2", "full"):
        adj = T.make_schedule(n, topo, seed=0).adjacency_at(0)
        got = gossip_matrix_dyn(adj, torch.from_numpy(sizes))
        want = jax_dyn(adj, sizes)
        for g, w in zip(got, want):
            w = np.asarray(w)
            if integer_sizes:
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                np.testing.assert_array_max_ulp(g.numpy(), w, maxulp=1)
        np.testing.assert_allclose(got[0].numpy() + got[1].numpy().sum(1),
                                   1.0, rtol=1e-6)


def test_aggregate_prototypes_matches_jax():
    """Global Eq. 4: the mask exact, the weighted means to 1e-6 (the
    einsums sum over the nodes in their own orders)."""
    from repro.core.prototypes import aggregate_prototypes as jax_agg
    from repro_torch.core.prototypes import aggregate_prototypes
    rng = np.random.default_rng(4)
    protos = rng.standard_normal((6, C, P)).astype(np.float32)
    counts = rng.integers(0, 5, (6, C)).astype(np.float32)
    counts[:, 2] = 0.0
    glob, mask = aggregate_prototypes(torch.from_numpy(protos),
                                      torch.from_numpy(counts))
    jglob, jmask = jax_agg(protos, counts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.tolist()[2] == 0.0 and not glob[2].any()
    np.testing.assert_allclose(glob.numpy(), np.asarray(jglob), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("topo", ["ring", "star", "random-k2"])
def test_perm_lowering_matches_jax(topo):
    from repro.core.mesh_federation import _perm_lowering as jax_lowering
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import topology as T
    adj = T.make_schedule(8, topo, seed=0).adjacency_at(0)
    perms, srcs = M._perm_lowering(adj)
    jperms, jsrcs = jax_lowering(adj)
    assert perms == jperms
    for a, b in zip(srcs, jsrcs):
        np.testing.assert_array_equal(a, b)


def test_exchange_resolves_like_jax():
    """``auto`` picks ``ppermute`` exactly where the JAX package does (a
    regular graph with one rank per node), and the invalid requests
    raise alike."""
    from repro.core.mesh_federation import _resolve_exchange as jax_resolve
    from repro.launch.wire import fed_mesh
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import topology as T
    for world in (4, 2):
        mesh = fed_mesh(world)
        for topo in ("ring", "star", None):
            adj = None if topo is None else T.make_schedule(
                4, topo).adjacency_at(0)
            for ex in ("auto", "packed", "ppermute"):
                try:
                    want = jax_resolve(ex, adj, mesh)
                except ValueError:
                    with pytest.raises(ValueError):
                        M._resolve_exchange(ex, adj, world)
                    continue
                assert M._resolve_exchange(ex, adj, world) == want, \
                    (world, topo, ex)
    with pytest.raises(ValueError, match="exchange must be one of"):
        M._resolve_exchange("allreduce", None, 4)


def test_options_outside_the_slice_raise(one_rank_group, monkeypatch):
    """What the port still refuses: every backend but gloo
    (``NotImplementedError`` naming the queue item); a world that
    ``ranks_per_node`` does not divide into nodes (``ValueError``, here
    one rank in nodes of two); and what ``repro`` refuses alike: a
    stochastic spec (its mesh round takes no key), an unknown proto
    pass, and the adapter wire on the full protocol (``adjacency=None``:
    merge-based aggregation is neighbourhood-wise)."""
    from repro_torch.core import mesh_federation as M
    from repro_torch.wirespec import WireSpec
    for make in (M.make_profe_round, M.make_fedavg_round):
        with pytest.raises(ValueError, match="ranks_per_node=2"):
            make(one_rank_group, ranks_per_node=2)
    # repro's mesh round takes no noise key and rounds to nearest: the
    # port refuses a stochastic spec rather than fake unbiased codes
    with pytest.raises(ValueError, match="no PRNG key"):
        M.make_profe_round(one_rank_group,
                           spec=WireSpec(4, stochastic_rounding=True))
    with pytest.raises(ValueError, match="proto_pass"):
        M.make_profe_round(one_rank_group, proto_pass="ema")
    for exchange in ("auto", "gather", "packed"):
        with pytest.raises(ValueError, match="explicit adjacency"):
            M.make_profe_round(one_rank_group, adapter_rank=8,
                               exchange=exchange)
    # every backend but gloo raises: nothing falls back
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(NotImplementedError, match="nccl"):
        M.make_profe_round(one_rank_group)
    with pytest.raises(NotImplementedError, match="nccl"):
        M.make_fedavg_round(one_rank_group)
