"""Discrete-event simulator for the NE/MP pipeline strategies (paper §3.5),
port of ``repro.core.pipeline_sim`` (numpy only, as there).

The paper's Fig. 4/9 compares three schedules for the two processing
elements — Node Embedding (NE, fixed per-node cost) and Message Passing
(MP, cost proportional to out-degree):

  1. non-pipelined:  NE_i then MP_i, strictly sequential;
  2. fixed pipeline: depth-2 lockstep — NE_{i+1} overlaps MP_i, but the
     pair advances at the pace of the slower stage;
  3. streaming:      NE runs freely ahead into a bounded FIFO (depth Q);
     MP drains the FIFO — degree imbalance is absorbed until the FIFO
     fills/empties (paper uses Q = 10).

On the GPU the *execution* answer is edge-parallel segment reduction (see
scatter_gather.py) — but the *scheduling study* is a contribution of the
paper and is reproduced here exactly, as a cycle-level model.  The same
model also reproduces the virtual-node experiment (Fig. 6): a VN is a node
whose degree is N-1, and the streaming schedule hides it if it is emitted
early.

Costs are in abstract cycles: t_NE = c_ne; t_MP(d) = c_mp0 + d * c_mp_edge.
Defaults are calibrated so NE and mean-MP are comparable, the regime the
paper's U50 implementation sits in (Fig. 9 shows pipelining gains shrink
once MP strictly dominates).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineCosts:
    c_ne: float = 16.0  # node-embedding cycles per node (MLP PE, fixed width)
    c_mp0: float = 2.0  # message-passing fixed overhead per node
    c_mp_edge: float = 4.0  # cycles per outgoing edge
    queue_depth: int = 10  # paper's FIFO depth

    def t_ne(self, n: int) -> np.ndarray:
        return np.full(n, self.c_ne, dtype=np.float64)

    def t_mp(self, degrees: np.ndarray) -> np.ndarray:
        return self.c_mp0 + degrees.astype(np.float64) * self.c_mp_edge


def makespan_non_pipelined(degrees: np.ndarray, costs: PipelineCosts) -> float:
    """Fig. 4(a): Sum_i (t_NE + t_MP(d_i))."""
    return float(np.sum(costs.t_ne(len(degrees)) + costs.t_mp(degrees)))


def makespan_fixed(degrees: np.ndarray, costs: PipelineCosts) -> float:
    """Fig. 4(b): depth-2 lockstep pipeline.

    Stage pair (NE_{i+1} || MP_i) completes in max(t_NE, t_MP(d_i));
    prologue = first NE, epilogue included in the final max term.
    """
    t_ne = costs.t_ne(len(degrees))
    t_mp = costs.t_mp(degrees)
    return float(t_ne[0] + np.sum(np.maximum(t_ne, t_mp)))


def makespan_streaming(degrees: np.ndarray, costs: PipelineCosts) -> float:
    """Fig. 4(c): bounded-FIFO decoupled pipeline (event-driven).

    NE emits node i at time ne_done[i] but stalls when the FIFO holds
    ``queue_depth`` not-yet-consumed nodes.  MP consumes in emission order.
    """
    n = len(degrees)
    t_ne = costs.t_ne(n)
    t_mp = costs.t_mp(degrees)
    q = costs.queue_depth
    ne_done = np.zeros(n)
    mp_done = np.zeros(n)
    ne_free = 0.0  # time NE engine becomes free
    for i in range(n):
        # back-pressure: slot available once node i-q left the FIFO
        gate = mp_done[i - q] if i >= q else 0.0
        start = max(ne_free, gate)
        ne_done[i] = start + t_ne[i]
        ne_free = ne_done[i]
        mp_start = max(ne_done[i], mp_done[i - 1] if i else 0.0)
        mp_done[i] = mp_start + t_mp[i]
    return float(mp_done[-1])


STRATEGIES = {
    "non": makespan_non_pipelined,
    "fixed": makespan_fixed,
    "streaming": makespan_streaming,
}


def simulate(degrees: np.ndarray, costs: PipelineCosts | None = None) -> dict:
    """Makespans + the three paper speed-up ratios for one graph."""
    costs = costs or PipelineCosts()
    ms = {k: fn(np.asarray(degrees), costs) for k, fn in STRATEGIES.items()}
    return {
        **ms,
        "fixed_over_non": ms["non"] / ms["fixed"],
        "streaming_over_fixed": ms["fixed"] / ms["streaming"],
        "streaming_over_non": ms["non"] / ms["streaming"],
    }


def random_degree_graph(
    rng: np.random.Generator,
    n: int,
    avg_degree: float,
    pct_large: float,
    large_factor: float = 8.0,
) -> np.ndarray:
    """Synthetic degree sequences matching the Fig. 9(a) sweep axes:
    average node degree x percentage of large-degree nodes."""
    n_large = int(round(n * pct_large))
    n_small = n - n_large
    # solve small-node mean so the overall mean stays avg_degree
    large_deg = avg_degree * large_factor
    small_mean = max((avg_degree * n - large_deg * n_large) / max(n_small, 1), 0.5)
    small = rng.poisson(small_mean, size=n_small)
    large = rng.poisson(large_deg, size=n_large)
    deg = np.concatenate([small, large])
    rng.shuffle(deg)
    return np.maximum(deg, 0)


def virtual_node_graph(
    rng: np.random.Generator, n: int, avg_degree: float, vn_position: str = "first"
) -> np.ndarray:
    """Degree sequence with one virtual node of degree n-1 (Fig. 6).

    ``vn_position``: "first" (paper's recommendation — emit the VN early so
    streaming hides it) or "last" (worst case).
    """
    deg = rng.poisson(avg_degree, size=n - 1)
    vn = np.array([n - 1])
    if vn_position == "first":
        return np.concatenate([vn, deg])
    return np.concatenate([deg, vn])
