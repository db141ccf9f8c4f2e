"""Federated data partitioning — the paper's five splits (Sec. IV):

IID, non-IID with 60%/40%/20% of classes present per client, and
non-IID Dirichlet(alpha = 0.5).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid_partition(labels: np.ndarray, n_nodes: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(labels))
    return [np.sort(chunk) for chunk in np.array_split(perm, n_nodes)]


def pathological_partition(labels: np.ndarray, n_nodes: int,
                           frac_classes: float, seed: int) -> List[np.ndarray]:
    """Each node only sees ``frac_classes`` of the label set (paper's
    non-IID 60/40/20% configurations)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    k = max(int(round(len(classes) * frac_classes)), 1)
    node_classes = [rng.choice(classes, k, replace=False) for _ in range(n_nodes)]
    # ensure every class is assigned to at least one node
    owned = set(int(c) for ncs in node_classes for c in ncs)
    missing = [c for c in classes if int(c) not in owned]
    for i, c in enumerate(missing):
        node_classes[i % n_nodes] = np.append(node_classes[i % n_nodes], c)

    by_class = {int(c): np.nonzero(labels == c)[0] for c in classes}
    for c in by_class:
        by_class[c] = rng.permutation(by_class[c])
    # split each class's examples evenly among the nodes that own it
    owners: Dict[int, List[int]] = {int(c): [] for c in classes}
    for node, ncs in enumerate(node_classes):
        for c in ncs:
            owners[int(c)].append(node)
    parts: List[List[int]] = [[] for _ in range(n_nodes)]
    for c, nodes in owners.items():
        for node, chunk in zip(nodes, np.array_split(by_class[c], len(nodes))):
            parts[node].extend(chunk.tolist())
    return [np.sort(np.array(p, np.int64)) for p in parts]


def dirichlet_partition(labels: np.ndarray, n_nodes: int, alpha: float,
                        seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    parts: List[List[int]] = [[] for _ in range(n_nodes)]
    for c in classes:
        idx = rng.permutation(np.nonzero(labels == c)[0])
        props = rng.dirichlet(alpha * np.ones(n_nodes))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for node, chunk in enumerate(np.split(idx, cuts)):
            parts[node].extend(chunk.tolist())
    # guarantee non-empty nodes
    for node in range(n_nodes):
        if not parts[node]:
            donor = max(range(n_nodes), key=lambda i: len(parts[i]))
            parts[node].append(parts[donor].pop())
    return [np.sort(np.array(p, np.int64)) for p in parts]


def partition(labels: np.ndarray, n_nodes: int, split: str, seed: int,
              dirichlet_alpha: float = 0.5) -> List[np.ndarray]:
    if split == "iid":
        return iid_partition(labels, n_nodes, seed)
    if split.startswith("noniid"):
        frac = int(split[len("noniid"):]) / 100.0
        return pathological_partition(labels, n_nodes, frac, seed)
    if split == "dirichlet":
        return dirichlet_partition(labels, n_nodes, dirichlet_alpha, seed)
    raise ValueError(f"unknown split {split!r}")


def image_federation(cfg, samples: int, n_nodes: int, split: str = "iid",
                     seed: int = 0, test_frac: float = 0.1):
    """The user scripts' federation: ``samples`` synthetic images of
    ``cfg``'s shape and classes, ``test_frac`` of them held out, the rest
    partitioned over ``n_nodes`` by ``split``.  Returns ``(node_data,
    test_data)``, each node's a dict of its rows."""
    from repro_torch.data.synthetic import make_image_dataset, train_test_split
    data = make_image_dataset(seed, samples, cfg.input_hw, cfg.num_classes)
    train, test = train_test_split(data, test_frac, seed)
    parts = partition(train["label"], n_nodes, split, seed)
    return [{k: v[i] for k, v in train.items()} for i in parts], test
