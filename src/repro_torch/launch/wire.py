"""Physical-vs-logical wire bytes per topology: the wire audit.

The logical cost of a gossip round is what
:class:`repro_torch.core.comm.ScheduleCommAccountant` charges:
``out_degree × bytes-per-copy``.  The physical cost is what the mesh
round (``core/mesh_federation.py``) hands to its collectives.
:func:`measure_exchange_bytes` runs one round of each exchange on
``n_nodes · inner`` spawned gloo ranks at an architecture's student
shapes, reads every rank's ``COLLECTIVE_BYTES``, and reports them beside
the accountant's predictions; the ``check_*`` gates hold the two
together (``python -m repro_torch.launch.dryrun --topology``).

Collectives are counted as XLA's compiled HLO counts them, so the
numbers compare one for one with the JAX package's audit: a permute
counts its operand once a step, an all-gather its gathered output (the
group's size times the operand), an all-reduce its operand; with
``inner`` ranks a node, a node's pod (wire) bytes are the sum over its
ranks, and the node-group traffic is reported apart (``by_axis``).
:func:`measure_exchange_rows` measures several wire specs on one spawn
of ranks and can also time each exchange's round (``round_ms``).
"""
from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import topology as T
from repro_torch.wirespec import WireSpec, resolve_spec

RANK_DEADLINE_S = 900
# the inner (node-group) axis, named as the JAX package's mesh names it
INNER_AXIS = "data"


def parse_pods(pods) -> "tuple[int, int]":
    """``"8"`` → ``(8, 1)``, ``"8x2"`` → ``(8, 2)``: R federation nodes
    × C ranks a node.  Ints pass through as ``(pods, 1)``."""
    if isinstance(pods, int):
        return pods, 1
    parts = str(pods).lower().split("x")
    if len(parts) not in (1, 2) or not all(p.isdigit() for p in parts):
        raise ValueError(f"--pods must be 'R' or 'RxC', got {pods!r}")
    r = int(parts[0])
    c = int(parts[1]) if len(parts) == 2 else 1
    if r < 1 or c < 1:
        raise ValueError(f"--pods sizes must be >= 1, got {pods!r}")
    return r, c


def _config(arch: str):
    from repro_torch.config import get_config
    cfg = get_config(arch)
    if hasattr(cfg, "smoke") and cfg.family not in ("cnn", "resnet"):
        cfg = cfg.smoke()
    return cfg


def _student_params(cfg, seed: int):
    import torch

    from repro_torch.models import derive_student, init_params
    return init_params(derive_student(cfg),
                       torch.Generator().manual_seed(seed))


def student_setup(arch: str, full: bool = False):
    """``(cfg, student_cfg, struct, ncls)``: the smoke config for the LM
    families (``full=True``: the full-width config), the paper config
    for ``cnn`` / ``resnet``; the student's parameter skeleton (shapes
    and dtypes, drawn on ``meta`` for an LM); the prototype classes
    (label classes for ``cnn`` / ``resnet``, domain tags for an LM), as
    the simulator counts them."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import derive_student, init_params
    from repro_torch.tree import ShapeDtypeStruct, tree_map
    cfg = get_config(arch) if full else _config(arch)
    student_cfg = derive_student(cfg)
    if cfg.family in ("cnn", "resnet"):     # drawn on the generator's CPU
        params = _student_params(cfg, 0)
    else:
        params = init_params(student_cfg, torch.Generator().manual_seed(0),
                             device="meta")
    struct = tree_map(lambda x: ShapeDtypeStruct(tuple(x.shape), x.dtype),
                      params)
    ncls = cfg.num_classes if cfg.family in ("cnn", "resnet") \
        else cfg.n_proto_classes
    return cfg, student_cfg, struct, ncls


def accountant_payload(struct, ncls: int, proto_dim: int, *,
                       adapter_rank: int = 0,
                       adapter_grams: bool = False) -> Dict[str, Any]:
    """The per-copy payload skeleton the comm accountants meter for one
    gossip share: ``{"model", "protos", "counts"}``, or with an adapter
    rank the factored wire ``{"adapters", ["grams",] "model" (the
    non-matrix rest), "protos", "counts"}``, split by the
    ``adapter_layout`` the rounds run."""
    from repro_torch.tree import ShapeDtypeStruct, tree_map
    f32 = np.dtype(np.float32)
    model = tree_map(lambda s: ShapeDtypeStruct(tuple(s.shape), s.dtype),
                     struct)
    payload: Dict[str, Any] = {
        "model": model,
        "protos": ShapeDtypeStruct((ncls, proto_dim), f32),
        "counts": ShapeDtypeStruct((ncls,), f32),
    }
    if adapter_rank:
        from repro_torch.core.adapters import (adapter_layout,
                                               adapter_payload_template,
                                               split_student)
        layout = adapter_layout(model, adapter_rank)
        _mats, rest = split_student(layout, model)
        payload.update(adapter_payload_template(layout,
                                                grams=adapter_grams))
        payload["model"] = rest
    return payload


# -- the ranks ------------------------------------------------------------------

def _rank_inputs(job, node: int, device):
    """Node ``node``'s round inputs, drawn from the job's seed (every
    rank of a node draws the same): its student plane, prototypes,
    counts, every node's dataset size, and the carries its wire needs."""
    import torch

    from repro_torch.core.adapters import (adapter_layout, init_adapter_state,
                                           zero_wire_payload)
    from repro_torch.core.wire_state import init_codec_state
    from repro_torch.models import derive_student
    from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
    from repro_torch.tree import tree_map
    cfg = _config(job["arch"])
    scfg = derive_student(cfg)
    ncls = cfg.num_classes if cfg.family in ("cnn", "resnet") \
        else cfg.n_proto_classes
    seed = job["seed"] * 1000 + node
    one = plane_from_tree(tree_map(lambda x: x.to(device),
                                   _student_params(cfg, seed)))
    students = Plane(one.buf[None], one.meta)
    gen = torch.Generator().manual_seed(seed)
    protos = torch.rand((1, ncls, scfg.proto_dim), generator=gen).to(device)
    counts = torch.randint(0, 4, (1, ncls), generator=gen).to(
        device, torch.float32)
    sizes = torch.as_tensor(np.random.default_rng(job["seed"]).integers(
        50, 200, job["n_nodes"]), dtype=torch.float32, device=device)
    carry = []
    rank_, grams = job["adapter_rank"], job["adapter_grams"]
    tree = as_tree(students)
    if rank_:
        carry.append(init_adapter_state(adapter_layout(tree, rank_,
                                                       node_axis=True),
                                        tree, grams=grams))
    spec = WireSpec.parse(job["bits"])
    if spec.error_feedback:
        ef = {"protos": torch.zeros_like(protos)}
        if rank_:
            ef.update(zero_wire_payload(adapter_layout(
                tree, rank_, node_axis=True), tree, grams=grams))
        else:
            ef["student"] = students
        carry.append(init_codec_state(ef, 1))
    return students, protos, counts, sizes, carry


def _rank_main(rank: int, world: int, init: str, out_dir: str, job) -> None:
    """One spawned rank: for each of the job's ``rows`` (a wire spec, an
    adapter rank, its exchanges), one round of each exchange, the bytes
    it handed to collectives by group and kind and the kernels it
    launched (or the error the exchange raised); then, where the job
    asks for ``timed_rounds``, that many more rounds of each exchange but
    the full-gather reference, each started after a ``dist.barrier()``
    and read on the host clock after ``torch.cuda.synchronize()``
    (``round_ms``, a list), and the kernels those rounds launched
    (``timed_launches``).  Writes the rows' records to
    ``out_dir/rank<r>.json``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.core import mesh_federation as M
    from repro_torch.core.profe import resolve_device
    from repro_torch.kernels.build import launch_counts

    torch.set_num_threads(1)
    dev = resolve_device(job["device"])
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        inner = job["inner"]
        adj = T.make_schedule(job["n_nodes"], job["topology"], rounds=1,
                              seed=job["seed"]).adjacency_at(0)
        rows = []
        for row in job["rows"]:
            rjob = dict(job, **row)
            spec = WireSpec.parse(rjob["bits"])
            out = {}
            for name, full, mode in row["combos"]:
                students, protos, counts, sizes, carry = _rank_inputs(
                    rjob, rank // inner, dev)
                c = M.COLLECTIVE_BYTES
                pod0, inner0 = dict(c.by_kind), dict(c.inner_by_kind)
                launches0 = launch_counts()
                try:
                    fn = M.make_profe_round(
                        adjacency=None if full else adj, exchange=mode,
                        spec=spec, adapter_rank=rjob["adapter_rank"],
                        adapter_grams=rjob["adapter_grams"],
                        ranks_per_node=inner)
                    fn(students, protos, counts, sizes, *carry)
                except (ValueError, RuntimeError) as e:
                    out[name] = {"error": f"{type(e).__name__}: {e}"}
                    continue
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                out[name] = {
                    "pod": {k: v - pod0.get(k, 0)
                            for k, v in c.by_kind.items()
                            if v - pod0.get(k, 0)},
                    "inner": {k: v - inner0.get(k, 0)
                              for k, v in c.inner_by_kind.items()
                              if v - inner0.get(k, 0)},
                    "launches": {k: v - launches0[k]
                                 for k, v in launch_counts().items()
                                 if v - launches0[k]}}
                if full or not job["timed_rounds"]:
                    continue
                times = []
                launches0 = launch_counts()
                for _ in range(job["timed_rounds"]):
                    # the round replays the warm-up's inputs (the mix may
                    # have written the plane in place: same shapes, same
                    # work)
                    dist.barrier()
                    t0 = time.perf_counter()
                    fn(students, protos, counts, sizes, *carry)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                out[name]["round_ms"] = times
                out[name]["timed_launches"] = {
                    k: v - launches0[k] for k, v in launch_counts().items()
                    if v - launches0[k]}
            rows.append(out)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(job, world: int, main=None) -> list:
    """Run ``main(rank, world, init, out_dir, job)`` (by default
    :func:`_rank_main`) on ``world`` spawned ranks (a ``file://`` store
    in a temporary directory); each rank writes its JSON record to
    ``out_dir/rank<r>.json``, and the records are returned in rank
    order.  A rank that fails fails the call; ranks still running at
    ``RANK_DEADLINE_S`` are killed."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            main or _rank_main,
            args=(world, f"file://{tmp}/store", tmp, job),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_DEADLINE_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"{world} spawned ranks still running "
                                       f"after {RANK_DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(world)]


def _as_hlo(kinds: Dict[str, int], group: int) -> Dict[str, float]:
    """A rank's operand bytes by kind, as the HLO counts them: an
    all-gather by its gathered output."""
    return {k: float(v * group if k == "all-gather" else v)
            for k, v in kinds.items()}


def _add(into: Dict[str, float], kinds: Dict[str, float]) -> None:
    for k, v in kinds.items():
        into[k] = into.get(k, 0.0) + v


def _exchange_entry(records, n_nodes: int, inner: int) -> Dict[str, Any]:
    """One exchange's report entry from every rank's record."""
    errors = [r["error"] for r in records if "error" in r]
    if errors:
        return {"error": errors[0]}
    nodes = []
    pod_sys: Dict[str, float] = {}
    inner_sys: Dict[str, float] = {}
    for i in range(n_nodes):
        pod: Dict[str, float] = {}
        both: Dict[str, float] = {}
        for r in records[i * inner:(i + 1) * inner]:
            p, q = _as_hlo(r["pod"], n_nodes), _as_hlo(r["inner"], inner)
            _add(pod, p)
            _add(both, p)
            _add(both, q)
            _add(inner_sys, q)
        _add(pod_sys, pod)
        nodes.append((sum(pod.values()), both))
    per_node, by_kind = max(nodes, key=lambda t: t[0])
    def launches(key):
        total: Dict[str, float] = {}
        for r in records:
            _add(total, r[key])
        return {k: int(v) for k, v in total.items()}
    entry: Dict[str, Any] = {"collective_bytes_per_node": float(per_node),
                             "by_kind": by_kind,
                             "launches": launches("launches")}
    if "round_ms" in records[0]:
        # a round lasts as long as its slowest rank
        entry["round_ms"] = round(statistics.median(
            max(ts) for ts in zip(*(r["round_ms"] for r in records))), 3)
        entry["timed_launches"] = launches("timed_launches")
    if inner > 1:
        entry["by_axis"] = {ax: kinds for ax, kinds in
                            (("pod", pod_sys), (INNER_AXIS, inner_sys))
                            if kinds}
        entry["pod_by_kind_per_node"] = {k: v / n_nodes
                                         for k, v in pod_sys.items() if v}
    return entry


def exchange_predictions(arch: str, n_nodes: int, topology: str = "ring",
                         bits=16, seed: int = 0, inner: int = 1,
                         adapter_rank: int = 0,
                         adapter_grams: bool = False,
                         full: bool = False) -> Dict[str, Any]:
    """The shape-derived keys of a :func:`measure_exchange_bytes` report,
    from ``arch``'s student skeleton and the accountant alone (no rank is
    spawned): ``degree``, ``logical_bytes_per_node``,
    ``packed_pred_bytes_per_node``, ``packed_copy_bytes`` (at the spec
    and ``_int16``) and ``packed_sidecar_bytes_per_copy``.  ``full=True``
    takes an LM's full-width student (:func:`student_setup`)."""
    from repro_torch.core.comm import ScheduleCommAccountant, packed_copy_bytes
    from repro_torch.kernels.quantize.ops import packed_wire_rows

    spec = WireSpec.parse(bits) if isinstance(bits, str) \
        else resolve_spec(bits)
    sched = T.make_schedule(n_nodes, topology, rounds=1, seed=seed)
    _cfg, student_cfg, struct, ncls = student_setup(arch, full=full)
    payload = accountant_payload(struct, ncls, student_cfg.proto_dim,
                                 adapter_rank=adapter_rank,
                                 adapter_grams=adapter_grams)
    rows16, _ = packed_wire_rows({k: v for k, v in payload.items()
                                  if k != "counts"})
    copy16 = int(packed_copy_bytes(payload, 16, inner=inner))
    acct = ScheduleCommAccountant(sched)
    logical = acct.predicted_node_bytes(payload, 0, spec, wire="dense")
    packed = acct.predicted_node_bytes(payload, 0, spec, wire="packed",
                                       inner=inner)
    return {
        "degree": [int(d) for d in sched.out_degrees()[0]],
        "logical_bytes_per_node": int(logical.max()),
        "packed_pred_bytes_per_node": int(packed.max()),
        "packed_copy_bytes": int(packed_copy_bytes(payload, spec,
                                                   inner=inner)),
        "packed_copy_bytes_int16": copy16,
        "packed_sidecar_bytes_per_copy": copy16 - rows16 * 512 * 2,
    }


def measure_exchange_rows(arch: str, n_nodes: int, topology: str = "ring",
                          rows=({"bits": 16},), seed: int = 0,
                          inner: int = 1,
                          timed_rounds: int = 0,
                          device=None) -> List[Dict[str, Any]]:
    """:func:`measure_exchange_bytes` for each of ``rows`` on ONE spawn of
    ``n_nodes · inner`` gloo ranks: each row a dict with ``bits`` (an
    int, a :class:`WireSpec` or a spec string) and optionally
    ``adapter_rank``, ``adapter_grams`` and ``exchanges`` (by default
    ``gather``, ``packed`` and ``ppermute``).  Returns one report a row,
    in order, each as :func:`measure_exchange_bytes` gives it.  With
    ``timed_rounds`` > 0 each exchange's entry (not the full-gather
    reference's) also has ``round_ms``, the median of ``timed_rounds``
    rounds after the warm-up, each as long as its slowest rank, and
    ``timed_launches``, the kernels those rounds launched on every rank;
    the report then also has ``full_gather_launches``, the reference
    round's."""
    from repro_torch.core.profe import resolve_device

    dev = resolve_device(device)
    rows = [dict(dict(adapter_rank=0, adapter_grams=False,
                      exchanges=("gather", "packed", "ppermute")), **row,
                 spec=WireSpec.parse(row["bits"])
                 if isinstance(row["bits"], str)
                 else resolve_spec(row["bits"])) for row in rows]
    outs = [{
        "arch": arch, "topology": topology, "n_nodes": n_nodes,
        "inner": inner, "bits": row["spec"].describe(),
        "adapter_rank": row["adapter_rank"],
        "adapter_grams": row["adapter_grams"], "device": str(dev),
        **exchange_predictions(arch, n_nodes, topology, row["spec"],
                               seed=seed, inner=inner,
                               adapter_rank=row["adapter_rank"],
                               adapter_grams=row["adapter_grams"]),
        "exchanges": {},
    } for row in rows]
    job = dict(arch=arch, n_nodes=n_nodes, topology=topology, seed=seed,
               inner=inner, timed_rounds=timed_rounds, device=str(dev),
               rows=[dict(bits=row["spec"].arg(),
                          adapter_rank=row["adapter_rank"],
                          adapter_grams=row["adapter_grams"],
                          combos=[(ex, False, ex) for ex in row["exchanges"]]
                          + [("full-gather", True, "packed")])
                     for row in rows])
    records = spawn_ranks(job, n_nodes * inner)
    for i, (out, row) in enumerate(zip(outs, job["rows"])):
        for name, _, _ in row["combos"]:
            entry = _exchange_entry([r[i][name] for r in records], n_nodes,
                                    inner)
            if name == "full-gather":
                out["full_gather_bytes_per_node"] = \
                    entry.get("collective_bytes_per_node")
                if timed_rounds:
                    out["full_gather_launches"] = entry.get("launches", {})
            else:
                out["exchanges"][name] = entry
    return outs


def measure_exchange_bytes(arch: str, n_nodes: int, topology: str = "ring",
                           bits=16,
                           exchanges=("gather", "packed", "ppermute"),
                           seed: int = 0, inner: int = 1,
                           adapter_rank: int = 0,
                           adapter_grams: bool = False,
                           device=None) -> Dict[str, Any]:
    """One ProFe gossip round of each exchange in ``exchanges``, plus the
    ``"full-gather"`` reference (``packed``, ``adjacency=None``), on
    ``n_nodes · inner`` gloo ranks spawned once (``inner`` ranks a node,
    all on ``device``: the card unless ``"cpu"`` is named), at ``arch``'s
    student shapes with seeded inputs; the report has each exchange's
    physical bytes beside the accountant's logical and packed
    predictions (:func:`exchange_predictions`), under the JAX package's
    keys.

    ``bits`` is an int, a :class:`WireSpec` or a spec string;
    ``adapter_rank`` > 0 runs the adapter-rank wire (whose full-gather
    reference records its error: merge-based aggregation needs an
    adjacency).  ``collective_bytes_per_node`` is a node's pod (wire)
    bytes, summed over its ranks; ``launches`` the kernel launches of the
    round summed over every rank (none off the card); at ``inner`` > 1
    the entry also has ``by_axis`` (system totals on the pod and the node
    groups) and ``pod_by_kind_per_node``.  An exchange that does not apply records
    ``{"error": ...}``.  One row of :func:`measure_exchange_rows`."""
    return measure_exchange_rows(
        arch, n_nodes, topology,
        rows=[dict(bits=bits, adapter_rank=adapter_rank,
                   adapter_grams=adapter_grams, exchanges=exchanges)],
        seed=seed, inner=inner, device=device)[0]


# -- the gates --------------------------------------------------------------------

def check_topology_bytes(report: Dict[str, Any], *, exchange: str,
                         rel_tol: float = 0.10,
                         gather_frac: Optional[float] = None,
                         exact: bool = False) -> Dict[str, Any]:
    """Assert physical ≈ predicted wire bytes for one exchange mode:
    within ``rel_tol`` of the accountant's packed prediction; with
    ``exact`` (several ranks a node, or the adapter wire) the pod
    permute bytes a node equal to it; with ``gather_frac``, physical
    below that fraction of the full-graph all-gather reference.  Returns
    a verdict dict (also appended to ``report["checks"]``)."""
    ex = report["exchanges"][exchange]
    if "error" in ex:
        raise AssertionError(f"{exchange} did not compile: {ex['error']}")
    phys = ex["collective_bytes_per_node"]
    pred = report["packed_pred_bytes_per_node"]
    rel = abs(phys - pred) / max(pred, 1)
    verdict = {"exchange": exchange, "physical": phys, "predicted": pred,
               "rel_err": rel, "rel_tol": rel_tol}
    if rel > rel_tol:
        raise AssertionError(
            f"{exchange} physical bytes {phys:.0f} deviate "
            f"{rel:.1%} (> {rel_tol:.0%}) from the accountant's "
            f"prediction {pred}")
    if exact:
        perm = ex.get("pod_by_kind_per_node",
                      ex.get("by_kind", {})).get("collective-permute")
        verdict["permute_bytes_per_node"] = perm
        verdict["exact"] = True
        if perm is None or perm != pred:
            raise AssertionError(
                f"{exchange} pod-axis collective-permute moves "
                f"{perm} bytes/node, accountant predicts {pred} — the "
                f"row-sharded permute must be spec-EXACT")
    if gather_frac is not None:
        full = report.get("full_gather_bytes_per_node")
        verdict["full_gather"] = full
        verdict["gather_frac"] = gather_frac
        if not full:
            raise AssertionError(
                "full-graph gather reference did not compile — the "
                f"{gather_frac:.2f}x sparse-vs-dense bound cannot be "
                "checked")
        if phys >= gather_frac * full:
            raise AssertionError(
                f"{exchange} physical bytes {phys:.0f} not < "
                f"{gather_frac:.2f}x the full-graph gather {full:.0f}")
    report.setdefault("checks", []).append(verdict)
    return verdict


def check_bits_reduction(report: Dict[str, Any], report16: Dict[str, Any],
                         *, exchange: str = "ppermute") -> Dict[str, Any]:
    """Assert the sub-int16 wire shrinks the exchange's code-buffer
    bytes (physical per copy less the width-invariant sidecar) by at
    least the spec's exact byte ratio against the int16 ``report16`` of
    the same (arch, topology, N)."""
    for rep, name in ((report, "spec"), (report16, "int16")):
        ex = rep["exchanges"].get(exchange, {})
        if "error" in ex or "collective_bytes_per_node" not in ex:
            raise AssertionError(
                f"{exchange} ({name}) did not compile: "
                f"{ex.get('error', 'missing')}")
    deg = max(report["degree"])
    side = report["packed_sidecar_bytes_per_copy"]
    buf_spec = report["exchanges"][exchange][
        "collective_bytes_per_node"] / deg - side
    buf16 = report16["exchanges"][exchange][
        "collective_bytes_per_node"] / max(report16["degree"]) - side
    expected = (report["packed_copy_bytes"] - side) / \
        max(report["packed_copy_bytes_int16"] - side, 1)
    ratio = buf_spec / max(buf16, 1)
    verdict = {"check": "bits_reduction", "exchange": exchange,
               "bits": report["bits"], "buffer_bytes": buf_spec,
               "buffer_bytes_int16": buf16, "ratio_vs_int16": ratio,
               "expected_frac": expected}
    if ratio > expected * 1.0001 + 1e-9:
        raise AssertionError(
            f"{exchange} at {report['bits']} moves {buf_spec:.0f} buffer "
            f"bytes = {ratio:.4f}x the int16 exchange ({buf16:.0f}); the "
            f"spec's byte ratio is {expected:.4f}x")
    report.setdefault("checks", []).append(verdict)
    return verdict


def check_ef_zero_overhead(report_ef: Dict[str, Any],
                           report_stateless: Dict[str, Any], *,
                           exchange: str = "ppermute") -> Dict[str, Any]:
    """Assert the error-feedback wire moves EXACTLY the stateless spec's
    collective bytes: the residual never enters a collective."""
    for rep, name in ((report_ef, "ef"), (report_stateless, "stateless")):
        ex = rep["exchanges"].get(exchange, {})
        if "error" in ex or "collective_bytes_per_node" not in ex:
            raise AssertionError(
                f"{exchange} ({name}) did not compile: "
                f"{ex.get('error', 'missing')}")
    b_ef = report_ef["exchanges"][exchange]["collective_bytes_per_node"]
    b_sl = report_stateless["exchanges"][exchange][
        "collective_bytes_per_node"]
    verdict = {"check": "ef_zero_overhead", "exchange": exchange,
               "bits": report_ef["bits"], "bytes_ef": b_ef,
               "bytes_stateless": b_sl}
    if b_ef != b_sl:
        raise AssertionError(
            f"{exchange} with error feedback moves {b_ef:.0f} bytes/node "
            f"vs {b_sl:.0f} stateless — EF must be wire-free; the "
            f"residual leaked into a collective")
    report_ef.setdefault("checks", []).append(verdict)
    return verdict


def check_adapter_reduction(report: Dict[str, Any],
                            report_dense: Dict[str, Any], *,
                            exchange: str = "ppermute",
                            frac: Optional[float] = 0.15
                            ) -> Dict[str, Any]:
    """Assert the adapter-rank wire's collective bytes a node are below
    ``frac`` of the dense full-parameter exchange's, same (arch,
    topology, N) and exchange; ``frac=None`` records the ratio without
    gating it."""
    if not report.get("adapter_rank"):
        raise AssertionError("report was not measured with an adapter "
                             "rank — nothing to bound")
    if report_dense.get("adapter_rank"):
        raise AssertionError("dense reference report was measured WITH "
                             "an adapter rank")
    for rep, name in ((report, "adapters"), (report_dense, "dense")):
        ex = rep["exchanges"].get(exchange, {})
        if "error" in ex or "collective_bytes_per_node" not in ex:
            raise AssertionError(
                f"{exchange} ({name}) did not compile: "
                f"{ex.get('error', 'missing')}")
    b_ad = report["exchanges"][exchange]["collective_bytes_per_node"]
    b_dn = report_dense["exchanges"][exchange][
        "collective_bytes_per_node"]
    ratio = b_ad / max(b_dn, 1)
    verdict = {"check": "adapter_reduction", "exchange": exchange,
               "bits": report["bits"],
               "adapter_rank": report["adapter_rank"],
               "bytes_adapters": b_ad, "bytes_dense": b_dn,
               "ratio_vs_dense": ratio, "frac": frac}
    if frac is not None and ratio >= frac:
        raise AssertionError(
            f"{exchange} adapter wire (rank "
            f"{report['adapter_rank']}) moves {b_ad:.0f} bytes/node = "
            f"{ratio:.4f}x the dense exchange ({b_dn:.0f}); required "
            f"< {frac:.2f}x")
    report.setdefault("checks", []).append(verdict)
    return verdict
