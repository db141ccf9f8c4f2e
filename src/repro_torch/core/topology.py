"""DFL topology subsystem: who gossips with whom, per round.

The paper's protocol is 20 nodes fully connected, but topology/mixing
choice is the main communication–convergence lever in decentralized FL
(Liu et al., arXiv:2107.12048), so the graph is a first-class object
here rather than a string compared in two engines.

:class:`TopologySchedule` is the single source of truth both round
engines consume: a round-stacked boolean adjacency ``[R, N, N]``
(``R == 1`` for static graphs; round ``r`` uses phase ``r % R``) that

* **lowers** to precomputed gossip/include matrices
  (``w_self [R, N]``, ``w_neigh [R, N, N]``, ``include [R, N, N]``) so a
  round-varying topology rides through the jitted ``lax.scan`` round
  program in ``core/federation.py`` as a traced per-round slice — same
  shapes every round, no retrace, no Python-side rebuild;
* drives the **mesh path** (``core/mesh_federation.py``): the static
  phase adjacency is baked into the pod-axis round program as the mask
  of the weighted-einsum gossip;
* yields **wire-byte accounting** (``out_degrees``/``in_degrees``/
  ``directed_edge_counts``) that ``core/comm.ScheduleCommAccountant``
  turns into vectorized Table II numbers, asserted byte-identical to the
  seed per-edge ``CommMeter`` loop.

Spec grammar (``FederationConfig.topology``)::

    full | ring | star           static classics
    random-k<k>                  random k-regular (seeded, connected)
    er-<p>                       Erdős–Rényi G(N, p) (seeded; patched
                                 with a random cycle if disconnected)
    dynamic:<a>,<b>,...          time-varying: round r uses phase r % R
    resample:<sub>               fresh seeded <sub> graph every round
                                 (R == rounds)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

STATIC_TOPOLOGIES = ("full", "ring", "star")


def adjacency(num_nodes: int, topology: str = "full") -> np.ndarray:
    """Boolean [N, N] adjacency (no self-loops) for the static classics."""
    a = np.zeros((num_nodes, num_nodes), bool)
    if topology == "full":
        a[:] = True
        np.fill_diagonal(a, False)
    elif topology == "ring":
        for i in range(num_nodes):
            a[i, (i - 1) % num_nodes] = True
            a[i, (i + 1) % num_nodes] = True
        if num_nodes > 1:
            np.fill_diagonal(a, False)
    elif topology == "star":
        a[0, 1:] = True
        a[1:, 0] = True
    else:
        raise ValueError(f"unknown topology {topology!r}")
    return a


def neighbors(adj: np.ndarray, node: int) -> List[int]:
    return list(np.nonzero(adj[node])[0])


def mixing_weights(adj: np.ndarray) -> np.ndarray:
    """Row-stochastic gossip weights including self: W[i,j] = 1/(deg_i+1)."""
    n = adj.shape[0]
    w = adj.astype(np.float64) + np.eye(n)
    return w / w.sum(axis=1, keepdims=True)


def connected(adj: np.ndarray) -> bool:
    """BFS from node 0 reaches every node."""
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    seen[0] = True
    frontier = [0]
    while frontier:
        cur = frontier.pop()
        for j in np.nonzero(adj[cur])[0]:
            if not seen[j]:
                seen[j] = True
                frontier.append(int(j))
    return bool(seen.all())


# ---------------------------------------------------------------------------
# random-graph generators (seeded, always connected)
# ---------------------------------------------------------------------------

def random_k_regular(num_nodes: int, k: int, seed: int = 0,
                     max_tries: int = 500) -> np.ndarray:
    """Random simple connected k-regular graph via the pairing model.

    Rejection-samples stub pairings until the multigraph is simple and
    connected — for the small N of the federation protocol (≤ a few
    hundred) this converges in a handful of tries.  Deterministic under
    ``seed``.
    """
    if not 0 < k < num_nodes:
        raise ValueError(f"need 0 < k < N, got k={k}, N={num_nodes}")
    if (num_nodes * k) % 2:
        raise ValueError(f"N*k must be even, got N={num_nodes}, k={k}")
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        stubs = np.repeat(np.arange(num_nodes), k)
        rng.shuffle(stubs)
        a = np.zeros((num_nodes, num_nodes), bool)
        ok = True
        for u, v in stubs.reshape(-1, 2):
            if u == v or a[u, v]:
                ok = False            # self-loop / parallel edge: resample
                break
            a[u, v] = a[v, u] = True
        if ok and connected(a):
            return a
    raise RuntimeError(f"no connected {k}-regular graph on {num_nodes} nodes "
                       f"after {max_tries} pairing attempts")


def erdos_renyi(num_nodes: int, p: float, seed: int = 0) -> np.ndarray:
    """G(N, p): each undirected edge present independently with prob p.

    A disconnected sample is patched with a random Hamiltonian cycle so
    every node can participate in gossip (a DFL round over a
    disconnected graph silently strands nodes).  Deterministic under
    ``seed``.
    """
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"need 0 <= p <= 1, got {p}")
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((num_nodes, num_nodes)) < p, 1)
    a = a | a.T
    if not connected(a):
        perm = rng.permutation(num_nodes)
        for i in range(num_nodes):
            u, v = perm[i], perm[(i + 1) % num_nodes]
            a[u, v] = a[v, u] = True
    np.fill_diagonal(a, False)
    return a


def is_regular(adj: np.ndarray) -> bool:
    """Every node has the same degree (ring, full, random-k, ...)."""
    deg = np.asarray(adj, bool).sum(axis=1)
    return bool(deg.size == 0 or (deg == deg[0]).all())


def _max_bipartite_matching(edges: np.ndarray, n: int) -> List[Tuple[int, int]]:
    """Maximum matching of the directed edge set ``{(i, j): edges[i, j]}``
    viewed as a bipartite graph senders -> receivers (simple augmenting
    paths — N is the federation size, tens to a few hundred)."""
    match_of_dst = [-1] * n            # receiver -> sender

    def augment(u: int, seen: List[bool]) -> bool:
        for v in np.nonzero(edges[u])[0]:
            v = int(v)
            if seen[v]:
                continue
            seen[v] = True
            if match_of_dst[v] < 0 or augment(match_of_dst[v], seen):
                match_of_dst[v] = u
                return True
        return False

    for u in range(n):
        augment(u, [False] * n)
    return [(s, d) for d, s in enumerate(match_of_dst) if s >= 0]


def permutation_rounds(adj: np.ndarray) -> List[List[Tuple[int, int]]]:
    """Decompose a 0/1 adjacency's *directed* edge set into a sequence of
    (partial) permutations — the ``jax.lax.ppermute`` lowering of one
    gossip round.

    Each step is a list of ``(src, dst)`` pairs with distinct sources and
    distinct destinations; the union over steps is exactly the directed
    edge set (every undirected edge contributes both directions).  For a
    k-regular graph every step is a *full* permutation and there are
    exactly k steps (a k-regular bipartite graph decomposes into k
    perfect matchings), so a ring lowers to its two shifts; irregular
    graphs yield partial steps (>= max-degree of them).
    """
    edges = np.asarray(adj, bool).copy()
    np.fill_diagonal(edges, False)
    n = edges.shape[0]
    steps: List[List[Tuple[int, int]]] = []
    while edges.any():
        matching = _max_bipartite_matching(edges, n)
        if not matching:            # cannot happen for a nonempty edge set
            raise RuntimeError("empty matching on nonempty edge set")
        steps.append(matching)
        for s, d in matching:
            edges[s, d] = False
    return steps


def _static_adjacency(num_nodes: int, spec: str, seed: int) -> np.ndarray:
    if spec in STATIC_TOPOLOGIES:
        return adjacency(num_nodes, spec)
    if spec.startswith("random-k"):
        return random_k_regular(num_nodes, int(spec[len("random-k"):]), seed)
    if spec.startswith("er-"):
        return erdos_renyi(num_nodes, float(spec[len("er-"):]), seed)
    raise ValueError(f"unknown topology {spec!r}")


# ---------------------------------------------------------------------------
# the schedule: round-stacked adjacency + lowering
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class TopologySchedule:
    """Round-indexed gossip graph: ``stack`` is bool ``[R, N, N]``,
    round ``r`` gossips over phase ``r % R`` (``R == 1`` == static)."""

    spec: str
    stack: np.ndarray

    def __post_init__(self):
        s = np.asarray(self.stack, bool)
        if s.ndim != 3 or s.shape[1] != s.shape[2]:
            raise ValueError(f"stack must be [R, N, N], got {s.shape}")
        if s[:, np.arange(s.shape[1]), np.arange(s.shape[1])].any():
            raise ValueError("adjacency must have no self-loops")
        # Symmetric-only for now: the two engines and the accounting use
        # different edge-direction conventions (gossip rows vs delivery
        # columns), which only coincide on undirected graphs.  Directed
        # push-sum gossip is a named follow-up; admitting an asymmetric
        # stack today would silently desynchronize them.  Name the first
        # offending phase (and one offending edge) so a bad time-varying
        # schedule is debuggable without bisecting the stack by hand.
        asym = (s != s.transpose(0, 2, 1)).any(axis=(1, 2))
        if asym.any():
            p = int(np.nonzero(asym)[0][0])
            # name an edge that is PRESENT without its reverse (not the
            # missing direction): s & ~s.T is exactly the one-way edges
            i, j = (int(x[0]) for x in np.nonzero(s[p] & ~s[p].T)[:2])
            raise ValueError(
                f"adjacency must be symmetric (directed gossip is not "
                f"supported yet): round/phase {p} has edge ({i}, {j}) "
                f"without its reverse")
        object.__setattr__(self, "stack", s)

    @property
    def num_phases(self) -> int:
        return self.stack.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.stack.shape[1]

    def phase_index(self, round_idx: int) -> int:
        return round_idx % self.num_phases

    def adjacency_at(self, round_idx: int) -> np.ndarray:
        return self.stack[self.phase_index(round_idx)]

    def neighbors_at(self, round_idx: int, node: int) -> List[int]:
        return neighbors(self.adjacency_at(round_idx), node)

    # -- wire-byte accounting views ----------------------------------------
    def out_degrees(self) -> np.ndarray:
        """[R, N] int64: copies node i *sends* per round of each phase."""
        return self.stack.sum(axis=2).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        """[R, N] int64: copies node i *receives* per round of each phase."""
        return self.stack.sum(axis=1).astype(np.int64)

    def directed_edge_counts(self) -> np.ndarray:
        """[R] int64: directed edges (== payload copies on the wire)
        per round of each phase."""
        return self.stack.sum(axis=(1, 2)).astype(np.int64)

    def is_regular_at(self, round_idx: int) -> bool:
        return is_regular(self.adjacency_at(round_idx))

    def permutation_rounds_at(self, round_idx: int
                              ) -> List[List[Tuple[int, int]]]:
        """The round's adjacency lowered to ``jax.lax.ppermute`` steps
        (see :func:`permutation_rounds`) — what the mesh path's physical
        sparse exchange executes on the pod axis."""
        return permutation_rounds(self.adjacency_at(round_idx))

    # -- lowering to the round program's traced operands -------------------
    def lower(self, sizes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Precompute the gossip/include matrices the round engine
        consumes: ``(w_self [R, N], w_neigh [R, N, N], include [R, N, N])``
        fp32 numpy arrays.  The driver moves them to the device once and
        passes round ``r``'s slice ``[r % R]`` — a round-varying topology
        costs an index.
        """
        from repro_torch.core import round_ops as R
        w_self, w_neigh = R.gossip_matrix(self.stack, sizes)
        return w_self, w_neigh, R.include_matrix(self.stack)


def make_schedule(num_nodes: int, spec: str = "full", *, rounds: int = 1,
                  seed: int = 0) -> TopologySchedule:
    """Parse a topology spec string into a :class:`TopologySchedule`.

    ``rounds`` only matters for ``resample:`` specs (one fresh graph per
    round); cyclic ``dynamic:`` schedules and static graphs ignore it.
    Both round engines build their schedule from the same
    ``(num_nodes, spec, seed)``, so they walk identical graphs.
    """
    if spec.startswith("dynamic:"):
        phases = [s.strip() for s in spec[len("dynamic:"):].split(",")
                  if s.strip()]
        if not phases:
            raise ValueError(f"empty dynamic schedule {spec!r}")
        stack = np.stack([_static_adjacency(num_nodes, ph, seed + i)
                          for i, ph in enumerate(phases)])
    elif spec.startswith("resample:"):
        sub = spec[len("resample:"):]
        stack = np.stack([_static_adjacency(num_nodes, sub, seed + r)
                          for r in range(max(rounds, 1))])
    else:
        stack = _static_adjacency(num_nodes, spec, seed)[None]
    return TopologySchedule(spec=spec, stack=stack)


def from_stack(stack: np.ndarray, spec: str = "custom") -> TopologySchedule:
    """Wrap an explicit ``[R, N, N]`` (or ``[N, N]``) adjacency."""
    s = np.asarray(stack, bool)
    if s.ndim == 2:
        s = s[None]
    return TopologySchedule(spec=spec, stack=s)
