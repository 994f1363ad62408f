"""Packing round-trip properties of the port (counterpart of
``tests/test_packing_property.py``): a packed multi-graph batch must be
indistinguishable from per-graph serving, for every model of
``repro_torch.gnn.models`` (params from ``torch.Generator`` seed 0).

  * round-trip: packed slot i == graph i served alone, across two bucket
    budgets (rtol 1e-4 / atol 1e-6, JAX's bound);
  * mask-exact: garbage written into every padding region (node / edge
    features, padded edge endpoints, graph ids, the eigvec tail) leaves
    the outputs bit for bit;
  * aggregators: ``gather_scatter`` over a packed batch equals the
    per-graph one for every op of ``AGGREGATORS`` (rtol 1e-5 / atol 1e-6).

Seeded cases always run; hypothesis fuzzes the same properties over drawn
graph sets with a fixed ``max_examples`` and no deadline.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import message_passing as mp
from repro_torch.core.batching import BucketBudget, pack_eigvecs, pack_graphs, unpack_outputs
from repro_torch.core.graph import batch_graphs
from repro_torch.gnn.models import apply, init, paper_config

MODELS = [("gcn", False), ("gin", False), ("gin", True), ("gat", False),
          ("pna", False), ("dgn", False)]
SINGLE_N, SINGLE_E = 16, 40
BUDGETS = (BucketBudget(80, 200, 6), BucketBudget(96, 240, 8))
SEED_CASES = [
    ([(8, 20), (11, 26), (4, 7)], 0),
    ([(12, 30)], 1),
    ([(3, 2), (3, 2), (3, 2), (3, 2), (3, 2)], 2),
    ([(12, 30), (12, 30), (12, 30), (12, 30), (12, 30)], 3),
    ([(5, 9), (12, 24)], 4),
]


def _materialize(sizes, seed):
    rng = np.random.default_rng(seed)
    graphs, eigs = [], []
    for n, e in sizes:
        graphs.append((
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.normal(size=(n, 9)).astype(np.float32),
            rng.normal(size=(e, 3)).astype(np.float32),
        ))
        eigs.append(rng.normal(size=(n,)).astype(np.float32))
    return graphs, eigs


@lru_cache(maxsize=None)
def _model(model, vn):
    cfg = paper_config(model, virtual_node=vn)
    return cfg, init(torch.Generator().manual_seed(0), cfg)


def _forward(model, vn, g, eig, num_graphs):
    cfg, params = _model(model, vn)
    with torch.inference_mode():
        return apply(params, g, cfg, eigvec=torch.as_tensor(eig),
                     num_graphs=num_graphs).numpy()


def _check_roundtrip(model, vn, sizes, seed):
    graphs, eigs = _materialize(sizes, seed)
    want = []
    for g, eig in zip(graphs, eigs):
        ev = np.zeros((SINGLE_N,), np.float32)
        ev[:len(eig)] = eig
        want.append(_forward(model, vn, batch_graphs([g], SINGLE_N, SINGLE_E), ev, 1)[0])
    for budget in BUDGETS:
        packed, meta = pack_graphs(graphs, budget)
        out = _forward(model, vn, packed, pack_eigvecs(eigs, meta), budget.g_pad)
        got = unpack_outputs(out, meta, level="graph")
        for i in range(len(graphs)):
            np.testing.assert_allclose(got[i][0], want[i], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{model} vn={vn} {budget} graph {i}")


def _check_gather_scatter(sizes, seed, op):
    graphs, _ = _materialize(sizes, seed)
    packed, meta = pack_graphs(graphs, BUDGETS[0])
    msgs = packed.node_feat[packed.src.long()]
    per_node = unpack_outputs(mp.gather_scatter(packed, msgs, ops=(op,)).numpy(), meta,
                              level="node")
    for i, g in enumerate(graphs):
        single = batch_graphs([g], SINGLE_N, SINGLE_E)
        want = mp.gather_scatter(single, single.node_feat[single.src.long()],
                                 ops=(op,)).numpy()
        n = meta.node_counts[i]
        np.testing.assert_allclose(per_node[i], want[:n], rtol=1e-5, atol=1e-6,
                                   err_msg=f"op={op} graph={i}")


@pytest.mark.parametrize("model,vn", MODELS)
@pytest.mark.parametrize("sizes,seed", SEED_CASES[:3])
def test_packed_forward_matches_per_graph(model, vn, sizes, seed):
    _check_roundtrip(model, vn, sizes, seed)


@pytest.mark.parametrize("op", mp.AGGREGATORS)
@pytest.mark.parametrize("sizes,seed", SEED_CASES)
def test_packed_gather_scatter_matches_per_graph(op, sizes, seed):
    _check_gather_scatter(sizes, seed, op)


@pytest.mark.parametrize("model,vn", MODELS)
def test_packed_forward_is_mask_exact(model, vn, rng):
    """Garbage in every padding region must not move a single bit."""
    budget = BUDGETS[0]
    graphs, eigs = _materialize([(8, 20), (11, 26), (4, 7)], seed=3)
    packed, meta = pack_graphs(graphs, budget)
    eig = pack_eigvecs(eigs, meta)
    baseline = _forward(model, vn, packed, eig, budget.g_pad)
    n_real, e_real = sum(meta.node_counts), sum(meta.edge_counts)
    nf = packed.node_feat.numpy().copy()
    nf[n_real:] = rng.normal(size=nf[n_real:].shape)
    ef = packed.edge_feat.numpy().copy()
    ef[e_real:] = rng.normal(size=ef[e_real:].shape)
    ei = packed.edge_index.numpy().copy()
    ei[:, e_real:] = rng.integers(0, budget.n_pad, size=ei[:, e_real:].shape)
    gid = packed.graph_id.numpy().copy()
    gid[n_real:] = rng.integers(0, budget.g_pad + 1, size=budget.n_pad - n_real)
    eig_fuzz = eig.copy()
    eig_fuzz[n_real:] = rng.normal(size=budget.n_pad - n_real)
    fuzzed = dataclasses.replace(
        packed,
        node_feat=torch.from_numpy(nf.astype(np.float32)),
        edge_feat=torch.from_numpy(ef.astype(np.float32)),
        edge_index=torch.from_numpy(ei.astype(np.int32)),
        graph_id=torch.from_numpy(gid.astype(np.int32)),
    )
    out = _forward(model, vn, fuzzed, eig_fuzz, budget.g_pad)
    np.testing.assert_array_equal(out[:meta.num_graphs], baseline[:meta.num_graphs],
                                  err_msg=f"{model} vn={vn}: padding leaked")


graph_set_strategy = st.lists(st.tuples(st.integers(3, 12), st.integers(2, 30)),
                              min_size=1, max_size=5)


@pytest.mark.parametrize("model,vn", MODELS)
@settings(max_examples=5, deadline=None, derandomize=True)
@given(sizes=graph_set_strategy, seed=st.integers(0, 2**16))
def test_packed_forward_matches_per_graph_fuzzed(model, vn, sizes, seed):
    _check_roundtrip(model, vn, sizes, seed)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(sizes=graph_set_strategy, seed=st.integers(0, 2**16),
       op=st.sampled_from(mp.AGGREGATORS))
def test_packed_gather_scatter_matches_per_graph_fuzzed(sizes, seed, op):
    _check_gather_scatter(sizes, seed, op)
