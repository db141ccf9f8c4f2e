"""Production-mapping demo for the PyTorch port: the ProFe gossip round
as collectives over ``torch.distributed``.

Runs the multi-node federation round (``core/mesh_federation.py``:
quantize -> 16-bit exchange between ranks -> Eq. 4 aggregation) on
spawned gloo ranks, all on this run's device, in four parts:

(a) one ProFe round of 2 nodes of yi-6b's smoke student (seeds 0 and 1,
    dataset sizes 1 and 3, prototypes all 1 and all 2) on the full
    graph: the aggregated student is held to 0.25·s0 + 0.75·s1 within
    the 16-bit wire's step, and the global prototype C̄[0,0] is 1.5;
(b) the bytes a rank hands to its collectives (``COLLECTIVE_BYTES``) in
    that round against FedAvg's (``make_fedavg_round``) on yi-6b's smoke
    teacher;
(c) the masked ``star`` graph on the same 2 nodes, with its node
    divergence;
(d) 8 nodes: the full-graph packed all-gather against the ``ppermute``
    ring, in bytes a node (``launch.wire.measure_exchange_bytes``, HLO
    counting: an all-gather by its gathered output).

The JAX demo runs its 2 pods on a (2, 2, 2) mesh, 4 devices a node that
shard the model.  Parts (a)-(c) here run one rank a node: the port
shards no model within a node (``ranks_per_node`` > 1 gives a node
replicas of its whole state, and every exchange but the row-sharded
permute runs replicated over them), so 4 ranks a node would repeat the
same round 4 times and hand 4 times the bytes, not mirror the JAX
mesh's sharding.

    PYTHONPATH=src python examples/torch_mesh_federation_demo.py \\
        [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises with no
card).
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from repro_torch.core.profe import resolve_device

ARCH = "yi-6b"
SIZES = (1.0, 3.0)            # node 1 has 3x the data
RING_NODES = 8
QMAX16 = 32767


def _leaves(params, dev):
    from repro_torch.tree import tree_paths
    return {p: x.to(dev).float() for p, x in tree_paths(params)}


def _parts(rank: int, world: int, dev) -> dict:
    """Parts (a)-(c) on this rank (node ``rank``)."""
    import torch.distributed as dist

    from repro_torch.config import get_config
    from repro_torch.core import comm
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import topology as T
    from repro_torch.kernels.build import launch_counts
    from repro_torch.models import derive_student, init_params
    from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
    from repro_torch.tree import ShapeDtypeStruct, tree_map, tree_paths

    cfg = get_config(ARCH).smoke()
    scfg = derive_student(cfg)
    drawn = [init_params(scfg, torch.Generator().manual_seed(k))
             for k in range(world)]
    one = plane_from_tree(tree_map(lambda x: x.to(dev), drawn[rank]))
    students = Plane(one.buf[None], one.meta)
    ncls, pdim = cfg.n_proto_classes, scfg.proto_dim
    protos = torch.full((1, ncls, pdim), float(rank + 1), device=dev)
    counts = torch.ones((1, ncls), device=dev)
    sizes = torch.tensor(SIZES, device=dev)
    c = M.COLLECTIVE_BYTES

    # (a) the ProFe round on the full graph
    before = c.count
    new, glob, _ = M.make_profe_round(bits=16)(students, protos, counts,
                                               sizes)
    profe_bytes = c.count - before
    w = (sizes / sizes.sum()).tolist()
    s0, s1 = _leaves(drawn[0], dev), _leaves(drawn[1], dev)
    err, worst = 0.0, 0.0          # max |error|, and its share of the step
    for path, got in tree_paths(as_tree(new)):
        a, b = s0[path], s1[path]
        e = float((got[0] - (w[0] * a + w[1] * b)).abs().max())
        step = (w[0] * float(a.abs().max()) + w[1] * float(b.abs().max())) \
            / QMAX16
        err, worst = max(err, e), max(worst, e / max(step, 1e-30))

    # (b) FedAvg's round on the teacher
    teacher = init_params(cfg, torch.Generator().manual_seed(2))
    models = tree_map(lambda x: x.to(dev)[None], teacher)
    before = c.count
    M.make_fedavg_round()(models, sizes)
    fedavg_bytes = c.count - before
    struct = tree_map(lambda x: ShapeDtypeStruct(tuple(x.shape), x.dtype),
                      teacher)

    # (c) the masked star graph
    star = M.make_profe_round(bits=16, adjacency=T.adjacency(world, "star"))
    s_star, protos_star, _ = star(students, protos, counts, sizes)
    buf = s_star.buf.detach().cpu().contiguous()
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    views = [dict(tree_paths(as_tree(Plane(b, s_star.meta)))) for b in bufs]
    divergence = max(float((views[0][p] - views[1][p]).abs().max())
                     for p in views[0])
    return {"aggregate_max_err": err, "aggregate_err_over_step": worst,
            "c_bar_00": float(glob[0, 0]),
            "profe_bytes_per_rank": profe_bytes,
            "fedavg_bytes_per_rank": fedavg_bytes,
            "fedavg_pred_bytes": int(comm.packed_copy_bytes(
                {"model": struct}, None)),
            "star_protos_shape": [world] + list(protos_star.shape[1:]),
            "star_divergence": divergence,
            "launches": {k: v for k, v in launch_counts().items() if v}}


def _rank(rank: int, world: int, init: str, out_dir: str, job) -> None:
    """One spawned rank of parts (a)-(c): its record to
    ``out_dir/rank<r>.json``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = resolve_device(job["device"])
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        rec = _parts(rank, world, dev)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def run(device=None, verbose: bool = False) -> dict:
    """Parts (a)-(d) (module docstring).  Raises if the aggregate of (a)
    strays beyond the 16-bit wire's step.  Returns the numbers each part
    prints: rank 0's record of (a)-(c), the kernel launches of (a)-(c)
    summed over the ranks (none off the card), and (d)'s bytes a node
    and launches."""
    from repro_torch.launch.wire import (exchange_predictions,
                                         measure_exchange_bytes, spawn_ranks)
    dev = resolve_device(device)
    world = len(SIZES)
    if verbose:
        print(f"mesh: {world} gloo ranks, one a node, on {dev}")
    recs = spawn_ranks({"device": str(dev)}, world, main=_rank)
    launches = {}
    for rec in recs:
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out = dict(recs[0], launches=launches, device=str(dev), ranks=world,
               layout="one rank a node",
               profe_pred_bytes=exchange_predictions(
                   ARCH, world, "full", 16)["packed_copy_bytes"])
    out["saved"] = 1 - out["profe_bytes_per_rank"] / \
        out["fedavg_bytes_per_rank"]
    if out["aggregate_err_over_step"] > 1.0:
        raise RuntimeError(
            f"aggregated student max err {out['aggregate_max_err']:.3e} is "
            f"{out['aggregate_err_over_step']:.2f} steps of the 16-bit wire "
            f"from the exact weighted mean")
    if verbose:
        print(f"\naggregated student max err vs exact weighted mean: "
              f"{out['aggregate_max_err']:.2e} (16-bit wire quantization, "
              f"{out['aggregate_err_over_step']:.2f} of a step)")
        print(f"global prototypes: C̄[0,0] = {out['c_bar_00']:.3f} "
              f"(equal counts -> 1.5)")
        print(f"\nwire bytes/rank: ProFe "
              f"{out['profe_bytes_per_rank'] / 1e6:.2f} MB vs FedAvg "
              f"{out['fedavg_bytes_per_rank'] / 1e6:.2f} MB  "
              f"(-{out['saved']:.0%})")
        print(f"\nmasked 'star' gossip: per-node prototypes "
              f"{tuple(out['star_protos_shape'])}, node divergence "
              f"{out['star_divergence']:.2e} (sparse graphs keep nodes "
              f"distinct)")
    # (d) one device a node: the packed int16 buffer rides degree-many
    # permutes, so a ring moves O(degree), not O(N), bytes
    wire = measure_exchange_bytes(ARCH, RING_NODES, "ring", bits=16,
                                  exchanges=("ppermute",), device=str(dev))
    ring = {"full_gather_bytes_per_node": wire["full_gather_bytes_per_node"],
            "ppermute_bytes_per_node":
                wire["exchanges"]["ppermute"]["collective_bytes_per_node"],
            "packed_pred_bytes_per_node": wire["packed_pred_bytes_per_node"],
            "packed_copy_bytes": wire["packed_copy_bytes"],
            "launches": wire["exchanges"]["ppermute"]["launches"]}
    ring["ratio"] = ring["ppermute_bytes_per_node"] / \
        ring["full_gather_bytes_per_node"]
    out["ring8"] = ring
    if verbose:
        print(f"\nphysical wire, N={RING_NODES} federation: full all-gather "
              f"{ring['full_gather_bytes_per_node'] / 1e6:.2f} MB/node vs "
              f"ppermute ring {ring['ppermute_bytes_per_node'] / 1e6:.2f} "
              f"MB/node ({ring['ratio']:.1%} — physical bytes match the "
              f"logical ring)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    run(device=args.device, verbose=True)


if __name__ == "__main__":
    main()
