"""The node mesh: the cards of one NVLink node as a ``DeviceMesh``.

Mesh semantics, as the JAX package's ``launch/mesh.py``:

* ``data``  — in-node batch / FSDP parallelism;
* ``model`` — in-node tensor parallelism;
* ``pod``   — the federation node (the gossip crosses this axis only;
  the port runs one node's program, so its node mesh has no pod axis).

The compile report traces one rank of a D-card node: the mesh is built
over a fake process group of D ranks (``torch.distributed``'s ``fake``
backend, which hallucinates every collective), as rank 0, so sharding
propagation and its collectives run in one process with nothing sent.
A node is one HGX H100 board: D is 2, 4 or 8.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

NODE_CARDS = (2, 4, 8)
AXES = ("data", "model")


def default_node_shape(cards: int, layout: str = "tp") -> Tuple[int, int]:
    """``(data, model)`` of a node of ``cards`` under ``layout``: ``data 2
    × model D/2`` (``1 × 2`` at D = 2) for ``tp``; one data axis of D
    cards for ``fsdp``, which shards every dim it shards over both axes
    as one: on one axis DTensor moves such a dim in one collective (over
    two, in two), and the card's torch (2.11) has no DTensor strategy
    for some ops on a dim sharded over two mesh axes."""
    check_cards(cards)
    if layout == "fsdp":
        return (cards, 1)
    return (1, 2) if cards == 2 else (2, cards // 2)


def check_cards(cards: int) -> None:
    if cards not in NODE_CARDS:
        raise ValueError(f"a node holds {' or '.join(map(str, NODE_CARDS))} "
                         f"cards (one NVLink board), not {cards}")


def parse_node_mesh(text: str, cards: int) -> Tuple[int, int]:
    """``"DxM"`` -> ``(data, model)``, whose product must be ``cards``."""
    try:
        data, model = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--node-mesh takes DxM, not {text!r}") from None
    if data < 1 or model < 1 or data * model != cards:
        raise ValueError(f"--node-mesh {text}: {data} x {model} is not the "
                         f"node's {cards} cards")
    return data, model


@contextlib.contextmanager
def fake_group(cards: int) -> Iterator[None]:
    """A fake process group of ``cards`` ranks, this process rank 0, for
    the block; one already initialised with ``cards`` ranks is used as it
    is (and left), one of another size raises."""
    import torch.distributed as dist
    check_world(cards)
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=cards)
    try:
        yield
    finally:
        dist.destroy_process_group()


def check_world(cards: int) -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() != cards:
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks is initialised; the node mesh needs "
                           f"{cards}")


def make_node_mesh(cards: int, data: int, model: int, device="meta"):
    """A ``DeviceMesh`` of axes ``("data", "model")``, ``data × model =
    cards``, less an axis of one rank (DTensor then keeps no placement on
    it), over the initialised process group (:func:`fake_group` for
    one rank's trace; a real group of ``cards`` ranks otherwise).  The
    mesh is the card's (``"cuda"``), also for shards on ``meta``, so that
    DTensor plans the card's collectives, unless ``device`` is the CPU or
    this build of torch has no CUDA: DTensor then plans for gloo, which
    has no all-to-all (it moves a dim from one shard to another by an
    all-gather and a chunk)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if data * model != cards:
        raise ValueError(f"{data} x {model} is not {cards} cards")
    if not dist.is_initialized():
        raise RuntimeError("make_node_mesh needs a process group "
                           "(launch.mesh.fake_group for one rank's trace)")
    check_world(cards)
    kind = torch.device(device).type
    card = kind != "cpu" and torch.backends.cuda.is_built()
    axes = tuple(a for a, n in zip(AXES, (data, model)) if n > 1)
    sizes = tuple(n for n in (data, model) if n > 1)
    return DeviceMesh("cuda" if card else "cpu",
                      torch.arange(cards).reshape(sizes),
                      mesh_dim_names=axes)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes the training batch shards over."""
    names = mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)
