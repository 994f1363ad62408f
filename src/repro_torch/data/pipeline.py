"""Deterministic data pipelines (port of ``repro.data.pipeline``, copied as
numpy): synthetic token streams and the flat-binary corpus reader of the
LM trainer, synthetic molecular-graph streams (MolHIV / MolPCBA size
statistics) and DGN's Laplacian eigenvector input.

Batch ``i`` of a token stream is a pure function of (seed, i, shard) and
graph ``i`` of a molecule stream one of (seed, i), so the port and the
JAX package train and serve on identical inputs, and a restarted job
resumes mid-epoch from its step counter alone.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


# ---------------------------------------------------------------------------
# token streams (LM substrate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    zipf_a: float = 1.2  # synthetic vocabulary skew


class SyntheticTokens:
    """Zipf-distributed tokens with short-range structure (bigram mixing):
    enough signal for a loss that falls."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard_index])
        )
        z = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq_len))
        tokens = (z - 1) % cfg.vocab_size
        # short-range structure: with p=0.5, token t+1 = f(token t)
        repeat = rng.random((cfg.batch, cfg.seq_len)) < 0.5
        shifted = (tokens * 31 + 7) % cfg.vocab_size
        tokens[:, 1:] = np.where(repeat[:, 1:], shifted[:, :-1], tokens[:, 1:])
        return {"tokens": tokens.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class BinTokenDataset:
    """Memory-mapped flat-binary token corpus (uint16 / uint32), sharded by
    host: shard k reads window k of every batch."""

    def __init__(self, path: str, cfg: TokenPipelineConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        n = len(self.data) - cfg.seq_len - 1
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        starts = rng.integers(0, n, size=cfg.batch * cfg.shard_count)
        starts = starts[cfg.shard_index :: cfg.shard_count][: cfg.batch]
        out = np.stack([self.data[s : s + cfg.seq_len] for s in starts])
        return {"tokens": out.astype(np.int32) % cfg.vocab_size}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def write_synthetic_corpus(path: str, n_tokens: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    arr = ((rng.zipf(1.2, size=n_tokens) - 1) % vocab).astype(np.uint16)
    arr.tofile(path)
    return path


# ---------------------------------------------------------------------------
# molecular graph streams (GNN engine)
# ---------------------------------------------------------------------------


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
