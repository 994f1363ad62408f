"""Adaptive-ladder and admission invariants of the port's scheduler,
property-style; mirrors ``tests/test_slo_properties.py``.

After any refit the ladder is strictly increasing, every rung multiple
lies in ``[1, capacity]``, the top rung stays at ``capacity`` and at most
``max_rungs`` survive; a refit while buckets are open strands no request
(``served + shed == offered``, each served request in exactly one flush).
Each seeded trace also runs through JAX's scheduler over
``conftest.scripted_executor``, and the two reports (flush logs, sheds,
latencies) and the refit geometries are equal as floats.  When
``hypothesis`` is installed the same properties are fuzzed.
"""
import numpy as np
import pytest

from conftest import scripted_executor
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import StreamScheduler as JScheduler
from repro_torch.core.batching import BucketBudget
from repro_torch.serve.scheduler import Request, StreamScheduler
from test_torch_scheduler import TorchScripted, assert_same_report

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # the seeded cases only
    HAVE_HYPOTHESIS = False

BASE_SIG = (32, 96)  # the scripted executors' smallest single-graph bucket


def make_graph(rng, n, e):
    return (
        rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.normal(size=(e, 3)).astype(np.float32),
    )


def fresh_pair(capacity=8, max_rungs=4, **kw):
    """(port scheduler, JAX scheduler) of one configuration."""
    kw.setdefault("adapt_ladder", True)
    kw.setdefault("max_wait_s", 0.015625)
    return (StreamScheduler(TorchScripted(service_s=0.00390625), capacity=capacity,
                            max_rungs=max_rungs, **kw),
            JScheduler(scripted_executor(service_s=0.00390625), capacity=capacity,
                       max_rungs=max_rungs, **kw))


def assert_ladder_invariants(s, sig):
    ks = s.ladder_multiples(sig)
    assert ks, f"signature {sig} lost its ladder entirely"
    assert ks == sorted(set(ks)), f"not strictly increasing: {ks}"
    assert ks[0] >= 1 and ks[-1] == s.capacity, (
        f"top rung must stay pinned at capacity={s.capacity}: {ks}")
    nb, eb = sig
    for k, b in zip(ks, s._ladders[sig]):
        assert b == BucketBudget(n_pad=k * nb, e_pad=k * eb, g_pad=2 * k)


def force_refit(s, request_cls, sig, window):
    """Install an observation window and refit, as the flush loop would."""
    if sig not in s._ladders:
        rng = np.random.default_rng(0)
        s.ladder_for(request_cls(rid=0, graph=make_graph(rng, 4, 4), arrival_s=0.0))
    s._obs_multiples[sig] = list(window)
    s._refit_ladder(sig)


def check_window(window, capacity=8, max_rungs=4):
    s, js = fresh_pair(capacity=capacity, max_rungs=max_rungs)
    force_refit(s, Request, BASE_SIG, window)
    force_refit(js, JRequest, BASE_SIG, window)
    assert_ladder_invariants(s, BASE_SIG)
    ks = s.ladder_multiples(BASE_SIG)
    assert ks == js.ladder_multiples(BASE_SIG)
    assert len(ks) <= max_rungs
    nb, eb = BASE_SIG
    assert s._ladders[BASE_SIG][-1].admits(0, 0, 0, capacity * nb, capacity * eb)
    for k in window:
        want = min(max(int(k), 1), capacity)
        assert any(r >= want for r in ks), (window, ks, want)
    assert s._obs_multiples[BASE_SIG] == []


def check_trace(sizes, deltas, priorities, slo_s, refit_every, seed):
    rng = np.random.default_rng(seed)
    graphs = [make_graph(rng, n, e) for n, e in sizes]
    arrivals = [float(f"{t:.6f}") for t in np.cumsum(deltas)]
    s, js = fresh_pair(capacity=4, max_rungs=3, refit_every=refit_every,
                       slo_s=slo_s, service_s=0.001)
    jrep = js.run(graphs, arrivals=arrivals, priorities=priorities)
    rep = s.run(graphs, arrivals=arrivals, priorities=priorities)
    assert_same_report(jrep, rep)
    assert rep.num_served + rep.num_shed == rep.num_requests == len(graphs)
    shed_rids = {x.rid for x in rep.shed}
    flushed = [r for f in rep.flush_log for r in f.rids]
    assert len(flushed) == len(set(flushed)), "double flush"
    assert sorted(flushed) == sorted(set(range(len(graphs))) - shed_rids)
    for i in range(len(graphs)):
        served = i not in shed_rids
        assert (rep.outputs[i] is not None) == served
        assert np.isfinite(rep.latencies_s[i]) == served
        if served:
            assert rep.latencies_s[i] >= 0.0
    assert sum(rep.batch_sizes) == rep.num_served
    assert rep.deadline_misses <= rep.num_served
    for sig in s._ladders:
        assert_ladder_invariants(s, sig)
        assert s.ladder_multiples(sig) == js.ladder_multiples(sig)
    return rep


SEED_WINDOWS = [
    [1],
    [1, 1, 2, 2, 3, 3],
    [8, 8, 8],
    [5],
    [1, 2, 3, 4, 5, 6, 7, 8],
    [0, -3, 99],
    [3, 3, 3, 1, 7],
]


@pytest.mark.parametrize("window", SEED_WINDOWS, ids=[str(w) for w in SEED_WINDOWS])
def test_refit_geometry_invariants(window):
    check_window(window)


def test_refit_with_empty_window_is_a_noop():
    s, _ = fresh_pair()
    force_refit(s, Request, BASE_SIG, [])
    assert s.ladder_multiples(BASE_SIG) == [1, 2, 3, 4, 6, 8]


def test_refit_respects_max_rungs_quantiles():
    s, js = fresh_pair(capacity=8, max_rungs=3)
    force_refit(s, Request, BASE_SIG, [1, 2, 3, 4, 5, 6, 7, 8])
    force_refit(js, JRequest, BASE_SIG, [1, 2, 3, 4, 5, 6, 7, 8])
    ks = s.ladder_multiples(BASE_SIG)
    assert len(ks) <= 3 and ks[0] == 1 and ks[-1] == 8
    assert ks == js.ladder_multiples(BASE_SIG)


SEED_TRACES = [
    ([(8, 12)] * 10, [0.001] * 10, [0] * 10, None, 2, 0),
    ([(8, 12), (40, 60), (100, 300), (8, 12)] * 3,
     [0.0, 0.002, 0.0, 0.01] * 3, [0, 1, 0, 1] * 3, 0.05, 3, 1),
    ([(16, 24)] * 20, [0.0] * 20, [i % 3 for i in range(20)], 0.02, 4, 2),
    ([(200, 600)] * 5, [0.5] * 5, [0] * 5, 0.001, 1, 3),
    ([(4, 2)], [0.0], [7], None, 1, 4),
]


@pytest.mark.parametrize("case", SEED_TRACES,
                         ids=[f"trace{i}" for i in range(len(SEED_TRACES))])
def test_trace_conservation_under_live_refits(case):
    check_trace(*case)


def test_shed_plus_served_exhaustive_under_overload():
    rep = check_trace(sizes=[(24, 48)] * 40, deltas=[0.0005] * 40,
                      priorities=[i % 2 for i in range(40)], slo_s=0.01,
                      refit_every=2, seed=5)
    assert rep.num_shed > 0 and rep.num_served > 0


if HAVE_HYPOTHESIS:

    @settings(max_examples=50, deadline=None)
    @given(window=st.lists(st.integers(-2, 12), min_size=1, max_size=64),
           capacity=st.integers(2, 16), max_rungs=st.integers(2, 6))
    def test_refit_geometry_invariants_fuzzed(window, capacity, max_rungs):
        check_window(window, capacity=capacity, max_rungs=max_rungs)

    trace_strategy = st.lists(
        st.tuples(st.integers(3, 120), st.integers(2, 360),
                  st.floats(0.0, 0.02, allow_nan=False, allow_infinity=False),
                  st.integers(0, 2)),
        min_size=1, max_size=24,
    )

    @settings(max_examples=25, deadline=None)
    @given(trace=trace_strategy,
           slo_s=st.one_of(st.none(), st.floats(0.001, 0.1)),
           refit_every=st.integers(1, 6), seed=st.integers(0, 2**16))
    def test_trace_conservation_fuzzed(trace, slo_s, refit_every, seed):
        check_trace([(n, e) for n, e, _, _ in trace], [d for _, _, d, _ in trace],
                    [p for _, _, _, p in trace], slo_s, refit_every, seed)
