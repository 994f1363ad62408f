"""The Fig. 9 scheduling study of the port (``repro_torch.core.pipeline_sim``),
counterpart of ``tests/test_pipeline_sim.py``: the simulator's invariants,
the paper's speed-up bands on the same synthetic sweep and the
virtual-node experiment (Fig. 6), then float-for-float equality with the
JAX package's simulator on its sweeps (the same degree sequences, the
same ``numpy.random.Generator`` draws)."""
import dataclasses

import numpy as np
import pytest

from repro.core import pipeline_sim as JS
from repro_torch.core import pipeline_sim as PS
from repro_torch.core.pipeline_sim import (
    STRATEGIES,
    PipelineCosts,
    makespan_fixed,
    makespan_non_pipelined,
    makespan_streaming,
    random_degree_graph,
    simulate,
    virtual_node_graph,
)

RNG = np.random.default_rng(7)


def test_streaming_never_slower_than_fixed_never_slower_than_non():
    for _ in range(20):
        deg = RNG.poisson(RNG.uniform(1, 10), size=200)
        c = PipelineCosts()
        non = makespan_non_pipelined(deg, c)
        fix = makespan_fixed(deg, c)
        stream = makespan_streaming(deg, c)
        assert stream <= fix + 1e-9 <= non + 1e-9


def test_streaming_lower_bound_is_stage_max():
    """Streaming cannot beat max(total NE, total MP), the busy-stage bound."""
    deg = RNG.poisson(4, size=300)
    c = PipelineCosts()
    stream = makespan_streaming(deg, c)
    lower = max(c.c_ne * len(deg), float(np.sum(c.t_mp(deg))))
    assert stream >= lower - 1e-9
    assert stream <= lower * 1.5


def test_paper_speedup_bands_on_synthetic_sweep():
    """Fig. 9(a): fixed/non ~1.2-1.5x, streaming/fixed ~1.15-1.37x,
    streaming/non ~1.53-1.92x over the (avg degree x %large) sweep."""
    ratios = {"fn": [], "sf": [], "sn": []}
    for avg_deg in (2, 3, 4):
        for pct in (0.01, 0.05, 0.1):
            r = simulate(random_degree_graph(RNG, 2000, avg_deg, pct))
            ratios["fn"].append(r["fixed_over_non"])
            ratios["sf"].append(r["streaming_over_fixed"])
            ratios["sn"].append(r["streaming_over_non"])
    assert 1.15 <= np.mean(ratios["fn"]) <= 1.55, np.mean(ratios["fn"])
    assert 1.10 <= np.mean(ratios["sf"]) <= 1.40, np.mean(ratios["sf"])
    assert 1.45 <= np.mean(ratios["sn"]) <= 2.00, np.mean(ratios["sn"])


def test_virtual_node_hidden_when_early():
    """Fig. 6: streaming absorbs the virtual node iff it is emitted early."""
    c = PipelineCosts()
    deg_first = virtual_node_graph(RNG, 400, avg_degree=3, vn_position="first")
    deg_last = virtual_node_graph(RNG, 400, avg_degree=3, vn_position="last")
    s_first = makespan_streaming(deg_first, c)
    s_last = makespan_streaming(deg_last, c)
    assert s_first < s_last
    base = max(c.c_ne * 400, float(np.sum(c.t_mp(deg_first))))
    assert s_first <= base * 1.25


def test_degree_imbalance_helps_streaming():
    """More imbalance (NE ~ MP) => larger streaming gain; MP-dominated
    graphs degrade streaming toward fixed."""
    c = PipelineCosts()
    r_bal = simulate(random_degree_graph(RNG, 1000, 3, 0.02), c)
    r_heavy = simulate(random_degree_graph(RNG, 1000, 20, 0.3), c)
    assert r_bal["streaming_over_fixed"] > r_heavy["streaming_over_fixed"]


def _sweep(mod, seed):
    """The Fig. 9(a) sweep, the Fig. 6 graphs and two cost models through
    one package's simulator, from one seed."""
    rng = np.random.default_rng(seed)
    out = []
    for avg_deg in (2, 3, 4, 20):
        for pct in (0.0, 0.01, 0.05, 0.1, 0.3):
            deg = mod.random_degree_graph(rng, 500, avg_deg, pct)
            out.append(deg.astype(np.float64))
            for costs in (mod.PipelineCosts(), mod.PipelineCosts(c_ne=3.0, c_mp0=1.0,
                                                                  c_mp_edge=2.5,
                                                                  queue_depth=2)):
                out.append(np.array(list(mod.simulate(deg, costs).values())))
    for pos in ("first", "last"):
        deg = mod.virtual_node_graph(rng, 300, 3.0, vn_position=pos)
        out.append(deg.astype(np.float64))
        out.append(np.array([mod.makespan_streaming(deg, mod.PipelineCosts())]))
    return out


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sweeps_equal_jax_float_for_float(seed):
    got, want = _sweep(PS, seed), _sweep(JS, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_names_and_costs_are_jax_s():
    assert list(STRATEGIES) == list(JS.STRATEGIES)
    assert dataclasses.asdict(PipelineCosts()) == dataclasses.asdict(JS.PipelineCosts())
    deg = np.array([0, 3, 1, 7])
    c = PipelineCosts()
    np.testing.assert_array_equal(c.t_ne(4), JS.PipelineCosts().t_ne(4))
    np.testing.assert_array_equal(c.t_mp(deg), JS.PipelineCosts().t_mp(deg))
