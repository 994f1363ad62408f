"""Property tests (hypothesis) of the port's core invariants that
``tests/test_torch_moe.py`` did not take from ``tests/test_core_properties.py``
(it has the dispatch / combine round trip and the rank within a segment):
permutation invariance of aggregation, the CSR / CSC conversion's
consistency, and the O(N) output of the merged scatter-gather.  Each runs
a fixed ``max_examples`` with no deadline, derandomized, so its time is
bounded and repeats."""
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import graph as G
from repro_torch.core import scatter_gather as sg

graph_strategy = st.integers(3, 24).flatmap(
    lambda n: st.tuples(
        st.just(n),
        st.lists(st.tuples(st.integers(0, n - 1), st.integers(0, n - 1)),
                 min_size=1, max_size=60),
    )
)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(graph_strategy, st.sampled_from(["sum", "mean", "max", "min", "std"]))
def test_aggregation_is_permutation_invariant(graph, op):
    """A(.) must not depend on edge order: the property that legalizes the
    paper's merged scatter-gather (§3.4); rtol 1e-4 / atol 1e-5 (JAX's)."""
    n, edges = graph
    e = len(edges)
    dst = np.array([b for _, b in edges], np.int32)
    vals = np.random.default_rng(e).normal(size=(e, 5)).astype(np.float32)
    out1 = sg.sorted_segment_reduce(torch.from_numpy(vals), torch.from_numpy(dst), n, op)
    perm = np.random.default_rng(e + 1).permutation(e)
    out2 = sg.sorted_segment_reduce(torch.from_numpy(vals[perm]),
                                    torch.from_numpy(dst[perm]), n, op)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-4, atol=1e-5)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(graph_strategy)
def test_csr_csc_roundtrip(graph):
    """Degrees equal numpy's, offsets are monotone and end at the real edge
    count, the permutation is a bijection, and the sorted keys are sorted
    with the padding edges last."""
    n, edges = graph
    src = np.array([a for a, _ in edges], np.int32)
    dst = np.array([b for _, b in edges], np.int32)
    g = G.from_numpy(src, dst, np.zeros((n, 2), np.float32), n_pad=n + 2,
                     e_pad=len(edges) + 3)
    for order, keys in (("csr", src), ("csc", dst)):
        comp = G.coo_to_compressed(g, order)
        deg_np = np.bincount(keys, minlength=n + 2)
        np.testing.assert_array_equal(comp.degree.numpy(), deg_np)
        off = comp.offsets.numpy()
        assert (np.diff(off) >= 0).all() and off[-1] == len(edges)
        perm = comp.perm.numpy()
        assert sorted(perm.tolist()) == list(range(len(perm)))
        keys_pad = np.concatenate([keys, [n + 2] * 3])
        assert (np.diff(keys_pad[perm]) >= 0).all()
        sorted_ep = (comp.src_sorted if order == "csr" else comp.dst_sorted).numpy()
        np.testing.assert_array_equal(sorted_ep[:len(edges)], keys_pad[perm][:len(edges)])


@settings(max_examples=10, deadline=None, derandomize=True)
@given(st.integers(2, 32), st.integers(1, 8), st.sampled_from([10, 100, 1000]))
def test_merged_scatter_gather_buffer_is_O_N(n, f, e):
    """The paper's memory claim: the aggregate is (N, F) whatever the edge
    count (no O(E) buffer of aggregates)."""
    rng = np.random.default_rng(e + n)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    vals = rng.normal(size=(e, f)).astype(np.float32)
    out = sg.segment_reduce(torch.from_numpy(vals), torch.from_numpy(dst), n, "sum")
    assert tuple(out.shape) == (n, f)
