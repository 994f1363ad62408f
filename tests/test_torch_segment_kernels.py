"""GAT's two segment kernels in the port, on the CPU: plain versions against
the JAX oracles, and the dispatch rules of their wrappers.

  * ``kernels.ops.segment_reduce`` (sum, mean, sqsum, max, min) and
    ``kernels.ops.edge_softmax``, with and without ``perm=``, match
    ``repro.kernels.ref.segment_reduce_sorted_ref`` / ``edge_softmax_ref``
    at rtol 1e-6, atol 1e-6.  Cases: empty segments, padding ids, an
    all-padding edge list, extreme logits (a spread of +-80), H in {1, 4},
    and "hub": hubs of 300 and 1000 edges beside segments of degree 0, 1,
    16, 17 and 33 (the lengths at which the CUDA kernels change paths).
    The oracles are the JAX package's ``ref.py`` functions, not its Pallas
    kernels.
  * Every segment's softmax weights sum to 1 per head; padding rows are 0.
  * The kernel wrappers refuse CPU tensors without launching;
    ``mode="kernel"`` raises on a CPU tensor.
  * ``segment_reduce.vector_width`` picks float4 / float2 / one-float reads
    from F and the data's alignment; ``kernels.segment_times`` builds its
    hub graph with the stated in-degrees and needs a card.
  * The CUDA kernels themselves are held against these plain versions in
    ``tests/test_torch_on_card.py`` (it skips without a card) and by
    ``python3 chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import edge_softmax as ES
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import segment_reduce as SR
from repro_torch.kernels import segment_times as ST
from test_torch_on_card import segment_case, to_t

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
OPS = ("sum", "mean", "sqsum", "max", "min")
CASES = ("empty_and_padding", "all_padding", "wide", "hub")


def _coo(rng, sorted_values):
    """(perm, COO-order values) with ``values_coo[perm] == sorted_values``."""
    perm = rng.permutation(sorted_values.shape[0]).astype(np.int32)
    coo = np.empty_like(sorted_values)
    coo[perm] = sorted_values
    return perm, coo


@pytest.mark.parametrize("use_perm", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", OPS)
def test_segment_reduce_matches_jax_ref(op, case, use_perm):
    rng = np.random.default_rng(OPS.index(op) + 10 * CASES.index(case))
    f = {"empty_and_padding": 5, "all_padding": 3, "wide": 64, "hub": 64}[case]
    ids, offsets, n = segment_case(rng, case)
    values = rng.normal(size=(ids.shape[0], f)).astype(np.float32)
    want = np.asarray(JREF.segment_reduce_sorted_ref(
        jnp.asarray(values), jnp.asarray(ids), n, op))
    if use_perm:
        perm, coo = _coo(rng, values)
        got = kops.segment_reduce(to_t(coo), to_t(ids), to_t(offsets), n, op,
                                  perm=to_t(perm))
    else:
        got = kops.segment_reduce(to_t(values), to_t(ids), to_t(offsets), n, op)
    assert got.shape == (n, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    empty = np.diff(offsets) == 0
    assert (got.numpy()[empty] == 0).all()


@pytest.mark.parametrize("use_perm", [False, True])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("case", ["empty_and_padding", "all_padding", "extreme", "hub"])
def test_edge_softmax_matches_jax_ref(case, heads, use_perm):
    rng = np.random.default_rng(100 + heads + (case == "extreme") + 2 * (case == "hub"))
    ids, offsets, n = segment_case(rng, "wide" if case == "extreme" else case)
    logits = rng.normal(size=(ids.shape[0], heads)).astype(np.float32)
    if case == "extreme":
        logits = rng.uniform(-80.0, 80.0, size=logits.shape).astype(np.float32)
    want = np.asarray(JREF.edge_softmax_ref(jnp.asarray(logits), jnp.asarray(ids), n))
    if use_perm:
        perm, coo = _coo(rng, logits)
        got = kops.edge_softmax(to_t(coo), to_t(ids), to_t(offsets), n,
                                perm=to_t(perm))
    else:
        got = kops.edge_softmax(to_t(logits), to_t(ids), to_t(offsets), n)
    got = got.numpy()
    assert got.shape == logits.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    pad = ids >= n
    assert (got[pad] == 0).all()
    sums = np.zeros((n, heads))
    np.add.at(sums, ids[~pad], got[~pad])
    live = np.diff(offsets) > 0
    np.testing.assert_allclose(sums[live], 1.0, rtol=0, atol=1e-5)
    assert (sums[~live] == 0).all()


def test_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    rng = np.random.default_rng(7)
    ids, offsets, n = segment_case(rng, "empty_and_padding")
    values = to_t(rng.normal(size=(ids.shape[0], 4)).astype(np.float32))
    before = (SR.launches, ES.launches)
    with pytest.raises(ValueError, match="CUDA"):
        SR.segment_reduce(values, to_t(offsets), n)
    with pytest.raises(ValueError, match="CUDA"):
        ES.edge_softmax(values, to_t(offsets), n)
    with pytest.raises(RuntimeError, match="CUDA"):
        kops.segment_reduce(values, to_t(ids), to_t(offsets), n, mode="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        kops.edge_softmax(values, to_t(ids), to_t(offsets), n, mode="kernel")
    monkeypatch.setenv("REPRO_KERNEL_MODE", "reference")
    assert torch.equal(
        kops.edge_softmax(values, to_t(ids), to_t(offsets), n, mode="kernel"),
        TREF.edge_softmax_ref(values, to_t(ids), n))
    assert (SR.launches, ES.launches) == before


@pytest.mark.parametrize("f, offset, want", [(64, 0, 4), (100, 0, 4), (6, 0, 2), (64, 2, 2),
                                             (64, 1, 1), (101, 0, 1), (3, 0, 1), (1, 0, 1)])
def test_vector_width_follows_f_and_alignment(f, offset, want):
    """float4 reads where F is a multiple of 4 and the data is 16-byte
    aligned, float2 where F is even and it is 8-byte aligned, else one
    float; ``offset`` floats past an aligned allocation."""
    big = torch.zeros(8 * f + offset)
    values = big[offset:].view(8, f)
    assert SR.vector_width(f, values, torch.zeros(4, f)) == want


def test_hub_graph_has_the_stated_degrees():
    g, lay = ST.hub_graph(np.random.default_rng(0), 512, 2048, "cpu")
    deg = lay.in_degree.numpy()
    assert tuple(deg[:len(ST.HUB_DEGREES)]) == ST.HUB_DEGREES
    assert deg[len(ST.HUB_DEGREES):].max() <= 3 and (deg[512 - 96:] == 0).all()
    assert int(lay.offsets[-1]) == deg.sum() < 2048
    # the degrees straddle every path of the CUDA kernels
    t = ES.THREAD_EDGES
    assert {t, t + 1, 33, 300, 1000} <= set(ST.HUB_DEGREES) and ES.WARP_EDGES < 1000


def test_segment_times_needs_a_card(capsys):
    assert ST.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
