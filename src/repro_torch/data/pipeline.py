"""Deterministic synthetic molecular-graph streams (MolHIV / MolPCBA size
statistics) and DGN's Laplacian eigenvector input — the GNN half of
``repro.data.pipeline``, copied as numpy.

Graph ``i`` of a stream is a pure function of (seed, i), so the port and
the JAX package serve identical inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class MoleculeStats:
    """Size statistics matching OGB molecular property datasets."""

    name: str
    mean_nodes: float
    std_nodes: float
    mean_degree: float  # undirected edges per node ~ 1.05-1.1 (molecules)
    feat_dim: int = 9
    edge_dim: int = 3


MOLHIV = MoleculeStats("molhiv", 25.5, 12.0, 2.2)
MOLPCBA = MoleculeStats("molpcba", 26.0, 6.5, 2.2)


def synthetic_molecule(rng: np.random.Generator, stats: MoleculeStats):
    """One random molecule-like graph: a random tree (connected backbone)
    plus ring-closing extra edges, symmetric COO."""
    n = max(int(rng.normal(stats.mean_nodes, stats.std_nodes)), 4)
    parents = np.array([rng.integers(0, max(i, 1)) for i in range(1, n)])
    s = np.concatenate([np.arange(1, n), parents])
    r = np.concatenate([parents, np.arange(1, n)])
    extra = max(int(n * (stats.mean_degree - 2.0) / 2.0), 0)
    if extra:
        a = rng.integers(0, n, extra)
        b = rng.integers(0, n, extra)
        s = np.concatenate([s, a, b])
        r = np.concatenate([r, b, a])
    nf = rng.normal(size=(n, stats.feat_dim)).astype(np.float32)
    ef = rng.normal(size=(len(s), stats.edge_dim)).astype(np.float32)
    label = (nf.sum() + 0.1 * len(s)) > 0  # synthetic separable target
    return s.astype(np.int32), r.astype(np.int32), nf, ef, np.float32(label)


def laplacian_eigvec(s: np.ndarray, r: np.ndarray, n: int,
                     n_pad: Optional[int] = None) -> np.ndarray:
    """First non-trivial Laplacian eigenvector of the symmetrised graph —
    DGN's precomputed input, (n_pad,) float32 with zero padding rows."""
    a = np.zeros((n, n))
    a[np.asarray(r), np.asarray(s)] = 1.0
    a = np.maximum(a, a.T)
    lap = np.diag(a.sum(1)) - a
    _, v = np.linalg.eigh(lap)
    vec = v[:, min(1, v.shape[1] - 1)]
    out = np.zeros((n_pad if n_pad is not None else n,), np.float32)
    out[:n] = vec
    return out


class MoleculeStream:
    """Deterministic stream of raw COO graphs (the paper's real-time input)."""

    def __init__(self, stats: MoleculeStats, seed: int = 0):
        self.stats = stats
        self.seed = seed

    def graph_at(self, i: int):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        return synthetic_molecule(rng, self.stats)

    def take(self, n: int):
        return [self.graph_at(i) for i in range(n)]
