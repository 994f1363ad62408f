"""The port's CUDA kernels on an NVIDIA GPU, against their plain versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX.  Every test takes the ``cuda`` fixture, which skips when no CUDA
device is present (decided inside the test run, never at import):

    PYTHONPATH=src python -m pytest -q tests/test_torch_on_card.py

Tolerance: |kernel - plain| <= 1e-5 + 1e-5 |plain| (the same fp32 FMAs
summed in another order); PNA 5e-3, whose std amplifies one rounding of
``sqsum/c - mean^2``.  int8: ``quant_node_mlp`` (both entries) 1e-6 +
1e-6 |plain|, its x_q probe bit for bit;
``fused_mp`` on exact aggregates bit for bit (GIN 2e-5); the int8 engine
within the quantization-noise bound of ``tests/test_torch_quant.py``.
``flash_attention``: fp32 1e-5 + 1e-5 |plain| (fp32 products summed in
another order), bf16 1.6e-2 + 1.6e-2 |plain| (two bf16 ulps at 1); the fp32
LM server against its reference mode 1e-4, and the LM server's CUDA graphs
give the eager loop's tokens exactly (the same kernels on the same
inputs); an MoE server's captured decode step gives its eager step's
cache and token bit for bit under deterministic algorithms.  The
numpy operand helpers are shared with ``tests/test_torch_kernels.py``,
``tests/test_torch_segment_kernels.py`` and ``tests/test_torch_quant.py``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.core import layout as TLY
from repro_torch.core import message_passing as TMP
from repro_torch.kernels import edge_softmax as ES
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_mp as FM
from repro_torch.kernels import node_mlp as NM
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant_mlp as QM
from repro_torch.kernels import ref as kref
from repro_torch.kernels import segment_reduce as SR
from repro_torch.kernels import segment_times as ST

torch.set_num_threads(1)

# cuBLAS under PyTorch's deterministic algorithms needs its workspace set
# before the process's first GEMM: 8 buffers of 4 MiB
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

TOL = dict(rtol=1e-5, atol=1e-5)
PNA_TOL = dict(rtol=5e-3, atol=5e-3)
GAMMAS = ("gcn", "gin", "pna", "dgn")
# the plan arrays ``kernels.ops.fused_mp`` takes, in its order
PLAN_ARGS = ("ids_sorted", "offsets", "src_sorted", "in_degree", "node_mask")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card (see chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def to_t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def plan_arrays(rng, n_pad=40, e_pad=96):
    """Numpy plan arrays (ids_sorted, src_sorted, in_degree, offsets,
    node_mask) of a random padded batch with isolated nodes (the last node
    of every graph receives no edge) and padding edges."""
    gs = []
    for n in (7, 12, 5):
        e = int(rng.integers(n, 2 * n))
        gs.append((rng.integers(0, n, e).astype(np.int32),
                   rng.integers(0, n - 1, e).astype(np.int32),
                   rng.normal(size=(n, 9)).astype(np.float32),
                   rng.normal(size=(e, 3)).astype(np.float32)))
    g = TG.batch_graphs(gs, n_pad=n_pad, e_pad=e_pad)
    lay = TLY.host_layout(g)
    plan = {k: getattr(lay, k).numpy() for k in
            ("ids_sorted", "src_sorted", "in_degree", "offsets")}
    plan["node_mask"] = g.node_mask.numpy()
    return plan


# (n_pad, n_real) of one graph: N that cuts a 16- and a 32-row tile, and a
# graph whose last tiles hold only padding rows
TILE_CASES = ((1, 1), (31, 31), (33, 33), (4097, 4097), (4096, 1000))


def tile_plan_arrays(rng, n_pad, n_real, exact=False):
    """Plan arrays, as :func:`plan_arrays` gives them, of one graph of
    ``n_real`` nodes padded to ``n_pad``; in-degrees 0-3, or with ``exact``
    0, 1, 2 or 4 as :func:`exact_plan_arrays` makes them."""
    deg = rng.choice([0, 1, 2, 4] if exact else [0, 1, 2, 3], size=n_real)
    r = np.repeat(np.arange(n_real), deg).astype(np.int32)
    s = rng.integers(0, n_real, r.size).astype(np.int32)
    g = TG.from_numpy(s, r, rng.normal(size=(n_real, 9)).astype(np.float32),
                      rng.normal(size=(r.size, 3)).astype(np.float32),
                      n_pad=n_pad, e_pad=r.size + 7)
    lay = TLY.host_layout(g)
    plan = {k: getattr(lay, k).numpy() for k in
            ("ids_sorted", "src_sorted", "in_degree", "offsets")}
    plan["node_mask"] = g.node_mask.numpy()
    return plan


def hub_degrees(rng, n):
    """In-degrees of ``n`` destinations for the "hub" case: two hubs (300
    edges, and 1000, past the ``edge_softmax.WARP_EDGES`` a warp holds in
    registers), degrees 0, 1, ``THREAD_EDGES`` and one more (either side of
    a thread's segment in ``edge_softmax``) and 33 (past a warp's lanes),
    then in-degrees 0-3."""
    head = ST.HUB_DEGREES
    return np.concatenate([head, rng.integers(0, 4, n - len(head))])


def segment_case(rng, case):
    """Numpy (ids_sorted, offsets, n) of a sorted plan: "empty_and_padding"
    (gaps and the last 4 segments empty, padding ids n at the end),
    "all_padding" (no real edge), "wide" (64 segments, the last 10
    isolated, padding at the end), "hub" (64 segments of
    :func:`hub_degrees`, padding at the end)."""
    if case == "all_padding":
        n, ids = 16, np.full((24,), 16, np.int32)
    elif case == "hub":
        n = 64
        ids = np.repeat(np.arange(n), hub_degrees(rng, n))
        ids = np.concatenate([ids, np.full((29,), n)]).astype(np.int32)
    else:
        n, e, pad = (20, 90, 17) if case == "empty_and_padding" else (64, 150, 30)
        ids = np.sort(rng.integers(0, n - (4 if n == 20 else 10), e))
        ids = np.concatenate([ids, np.full((pad,), n)]).astype(np.int32)
    offsets = np.searchsorted(ids, np.arange(n + 1), side="left").astype(np.int32)
    return ids, offsets, n


def spec_operands(rng, gamma, n, e, f=12):
    """((phi, ops, gamma), numpy operands) exercising every slot of
    ``gamma`` in fp32."""
    kw = dict(msrc=rng.normal(size=(n, f)), x_res=rng.normal(size=(n, f)),
              b1=rng.normal(size=(f,)))
    if gamma == "gcn":
        kw = dict(msrc=kw["msrc"], x_res=kw["x_res"],
                  nop=rng.normal(size=(n, 1)))
    elif gamma == "gin":
        kw.update(w1=rng.normal(size=(f, 2 * f)) * 0.3,
                  b1=rng.normal(size=(2 * f,)),
                  eop=rng.normal(size=(e, f)),
                  w2=rng.normal(size=(2 * f, f)) * 0.3,
                  b2=rng.normal(size=(f,)))
    elif gamma == "pna":
        kw.update(w1=rng.normal(size=(12 * f, f)) * 0.2,
                  nop=np.abs(rng.normal(size=(n, 3))) + 0.5)
    else:
        kw.update(w1=rng.normal(size=(3 * f, f)) * 0.2,
                  nop=np.abs(rng.normal(size=(n, 1))) + 0.1,
                  ew=rng.normal(size=(e, 1)))
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    phi = "add_relu" if gamma == "gin" else "copy"
    ops = {"gcn": ("sum",), "gin": ("sum",),
           "pna": ("sum", "sqsum", "max", "min"), "dgn": ("sum", "wsum")}[gamma]
    return (phi, ops, gamma), kw


def exact_plan_arrays(rng, n_pad=40, e_pad=128):
    """Plan arrays as :func:`plan_arrays` gives them, of a batch whose
    in-degrees are 0, 1, 2 or 4: with :func:`exact_operands` every
    aggregate, mean and gamma tower is exact in fp32, whatever the order
    of the sums and whether a product is fused into an add."""
    gs = []
    for n in (7, 12, 5):
        r = np.repeat(np.arange(n), rng.choice([0, 1, 2, 4], size=n))
        gs.append((rng.integers(0, n, r.size).astype(np.int32),
                   r.astype(np.int32),
                   rng.normal(size=(n, 9)).astype(np.float32),
                   rng.normal(size=(r.size, 3)).astype(np.float32)))
    g = TG.batch_graphs(gs, n_pad=n_pad, e_pad=e_pad)
    lay = TLY.host_layout(g)
    plan = {k: getattr(lay, k).numpy() for k in
            ("ids_sorted", "src_sorted", "in_degree", "offsets")}
    plan["node_mask"] = g.node_mask.numpy()
    return plan


def exact_operands(rng, gamma, n, e, f=12):
    """((phi, ops, gamma), numpy operands) of an int8 fused layer whose
    aggregates are exact in fp32: msrc, x_res and eop multiples of 1/8 in
    [-4, 4], ew powers of two, nop multiples of 1/8; w1 int8 with
    per-column scales w1_scale (GIN: hidden width 2f, f32 w2)."""
    eighths = lambda *shape: rng.integers(-32, 33, size=shape) / 8.0
    h1 = 2 * f if gamma == "gin" else f
    k1 = {"gin": f, "pna": 12 * f, "dgn": 3 * f}[gamma]
    kw = dict(msrc=eighths(n, f), x_res=eighths(n, f),
              w1_scale=rng.uniform(1e-3, 1e-2, size=(h1,)),
              b1=0.1 * rng.normal(size=(h1,)))
    if gamma == "gin":
        kw.update(eop=eighths(e, f), w2=rng.normal(size=(h1, f)) * 0.3,
                  b2=rng.normal(size=(f,)))
    elif gamma == "pna":
        kw["nop"] = rng.integers(4, 17, size=(n, 3)) / 8.0
    else:
        kw.update(nop=eighths(n, 1) / 2.0,
                  ew=rng.choice([-1.0, 1.0], size=(e, 1))
                  * 2.0 ** rng.integers(-2, 2, size=(e, 1)))
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    kw["w1"] = rng.integers(-127, 128, size=(k1, h1)).astype(np.int8)
    phi = "add_relu" if gamma == "gin" else "copy"
    ops = {"gin": ("sum",), "pna": ("sum", "sqsum", "max", "min"),
           "dgn": ("sum", "wsum")}[gamma]
    return (phi, ops, gamma), kw


def gin_probe_weights(f=12):
    """int8 GIN weights that make the fused layer's output q * rs exactly:
    w1 = [I, -I] (scale 1, bias 0) splits relu(q rs) and relu(-q rs), and
    w2 = [I; -I] adds them back, so the output shows the quantized tower."""
    eye = np.eye(f)
    return dict(w1=np.concatenate([eye, -eye], 1).astype(np.int8),
                w1_scale=np.ones((2 * f,), np.float32),
                b1=np.zeros((2 * f,), np.float32),
                w2=np.concatenate([eye, -eye], 0).astype(np.float32),
                b2=np.zeros((f,), np.float32))


def assert_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol["atol"] + tol["rtol"] * np.abs(want)), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
def test_node_mlp_kernel_matches_plain(cuda, activation):
    gen = torch.Generator().manual_seed(0)
    for m, k, n in ((37, 9, 100), (4097, 100, 200), (1, 200, 1), (65, 3, 63)):
        x = torch.randn((m, k), generator=gen).to(cuda)
        w = (torch.randn((k, n), generator=gen) * (2.0 / (k + n)) ** 0.5).to(cuda)
        b = torch.randn((n,), generator=gen).to(cuda)
        before = NM.launches
        got = kops.node_mlp(x, w, b, activation, mode="kernel")
        assert NM.launches == before + 1
        want = kops.node_mlp(x, w, b, activation, mode="reference")
        assert NM.launches == before + 1
        assert_close(got.cpu().numpy(), want.cpu().numpy(), TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
@pytest.mark.parametrize("n", [1, 8, 63, 200])
def test_node_mlp_variants_match_plain(cuda, activation, n):
    """Every variant: narrow (N 1, 8), shallow (K 3, 9) and tiled (K 37,
    100, 1040: 4- and 16-byte copies, one and several K slices, a ring
    refilled past K 256; N 63: 4-byte copies of w and stores of y), at
    ragged M; K = 100 also from a view 4 bytes past a 16-byte boundary."""
    gen = torch.Generator().manual_seed(n)
    for k in (3, 9, 37, 100, 1040):
        for m in (1, 37, 4097):
            w = (torch.randn((k, n), generator=gen) * (2.0 / (k + n)) ** 0.5).to(cuda)
            b = torch.randn((n,), generator=gen).to(cuda)
            xs = [torch.randn((m, k), generator=gen).to(cuda)]
            if k == 100:
                xs.append(torch.randn((m * k + 1,), generator=gen).to(cuda)[1:].view(m, k))
            for x in xs:
                want_variant = NM.variant(m, k, n)
                before = dict(NM.launches_by_variant)
                got = kops.node_mlp(x, w, b, activation, mode="kernel")
                want = kops.node_mlp(x, w, b, activation, mode="reference")
                assert NM.launches_by_variant == dict(
                    before, **{want_variant: before[want_variant] + 1})
                assert_close(got.cpu().numpy(), want.cpu().numpy(), TOL)


@pytest.mark.parametrize("gamma", GAMMAS)
def test_fused_mp_kernel_matches_plain(cuda, gamma):
    """A padded batch, then N cutting a tile (1, 31, 33, 4097) and a graph
    whose last 96 tiles are all padding (``TILE_CASES``)."""
    rng = np.random.default_rng(5)
    plans = [plan_arrays(rng)] + [tile_plan_arrays(rng, *c) for c in TILE_CASES]
    for plan in plans:
        n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
        (phi, ops, _), kw = spec_operands(rng, gamma, n, e)
        spec = TMP.MPSpec(phi, ops, gamma)
        args = [to_t(plan[k], cuda) for k in PLAN_ARGS]
        kw = {k: to_t(v, cuda) for k, v in kw.items()}
        before = FM.launches
        got = kops.fused_mp(spec, *args, mode="kernel", **kw)
        assert FM.launches == before + 1
        want = kops.fused_mp(spec, *args, mode="reference", **kw)
        assert_close(got.cpu().numpy(), want.cpu().numpy(),
                     PNA_TOL if gamma == "pna" else TOL)
        assert (got.cpu().numpy()[~plan["node_mask"]] == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn((8, 4), device=cuda)
    w = torch.randn((4, 3), device=cuda)
    b = torch.zeros(3, device=cuda)
    before = NM.launches
    with pytest.raises(ValueError, match="contiguous"):
        NM.node_mlp(x.t().contiguous().t(), w, b)
    with pytest.raises(TypeError):
        NM.node_mlp(x.double(), w, b)
    with pytest.raises(ValueError, match="chain"):
        NM.node_mlp(x, w.t().contiguous(), b)
    assert NM.launches == before
    # int8: quantized operands must be int8, with their scales
    before = (FM.launches, QM.launches)
    rng = np.random.default_rng(6)
    plan = exact_plan_arrays(rng)
    n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
    (phi, ops, gamma), kw = exact_operands(rng, "dgn", n, e)
    spec = TMP.MPSpec(phi, ops, gamma, "int8")
    args = [to_t(plan[k], cuda) for k in PLAN_ARGS]
    kw = {k: to_t(v, cuda) for k, v in kw.items()}
    with pytest.raises(TypeError, match="w1"):
        kops.fused_mp(spec, *args, mode="kernel", **dict(kw, w1=kw["w1"].float()))
    with pytest.raises(ValueError, match="w1_scale"):
        kops.fused_mp(spec, *args, mode="kernel", **dict(kw, w1_scale=None))
    # PNA at F = 256: no block size's shared memory fits
    (phi, ops, gamma), kw = spec_operands(rng, "pna", n, e, f=256)
    with pytest.raises(ValueError, match="shared memory"):
        kops.fused_mp(TMP.MPSpec(phi, ops, gamma), *args, mode="kernel",
                      **{k: to_t(v, cuda) for k, v in kw.items()})
    x_q = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    w_q = torch.zeros((4, 3), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError, match="x_q"):
        QM.quant_node_mlp(x, w_q, torch.ones(3, device=cuda), b)
    with pytest.raises(ValueError, match="w_q"):
        QM.quant_node_mlp(x_q, w_q.t().contiguous(), torch.ones(3, device=cuda), b)
    with pytest.raises(ValueError, match="row_scale"):
        QM.quant_node_mlp(x_q, w_q, torch.ones(3, device=cuda), b,
                          row_scale=torch.ones((8,), device=cuda))
    assert (FM.launches, QM.launches) == before


def test_empty_outputs_launch_nothing(cuda):
    w = torch.randn((4, 3), device=cuda)
    b = torch.zeros(3, device=cuda)
    before = (NM.launches, FM.launches)
    assert NM.node_mlp(torch.empty((0, 4), device=cuda), w, b).shape == (0, 3)
    z = torch.zeros(0, dtype=torch.int32, device=cuda)
    x = torch.empty((0, 4), device=cuda)
    out = FM.fused_mp(TMP.MPSpec("copy", ("sum",), "gcn"),
                      torch.zeros(1, dtype=torch.int32, device=cuda), z, z,
                      z.bool(), x, x, nop=torch.empty((0, 1), device=cuda))
    assert out.shape == (0, 4)
    assert (NM.launches, FM.launches) == before


def test_gin_engine_on_card_matches_reference(cuda):
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import models as TM
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = TM.paper_config("gin", num_layers=2, hidden=32)
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(4)]
    before = (NM.launches, FM.launches)
    outs, _, _ = GNNEngine(cfg, params, fused=True, device=cuda).infer_stream(graphs)
    assert NM.launches > before[0] and FM.launches > before[1]
    ref_cfg = dataclasses.replace(cfg, kernel_mode="reference")
    refs, _, _ = GNNEngine(ref_cfg, params, fused=True, device=cuda).infer_stream(graphs)
    np.testing.assert_allclose(np.concatenate(outs), np.concatenate(refs),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float16, torch.float64])
def test_node_mlp_dispatch_feeds_the_kernel_fp32(cuda, dtype):
    """``ops.node_mlp`` runs the fp32 kernel on ``x.float()`` and returns
    the input's dtype, as ``node_mlp_ref`` does (an fp32 sum rounded the
    other way may move the cast by one step: an f16 ulp, 2^-10 relative, or
    1 in int32); the wrapper itself still refuses the dtype."""
    gen = torch.Generator().manual_seed(3)
    x = (4 * torch.randn((37, 9), generator=gen)).to(dtype).to(cuda)
    w = (0.3 * torch.randn((9, 100), generator=gen)).to(cuda)
    b = torch.randn((100,), generator=gen).to(cuda)
    before = NM.launches
    got = kops.node_mlp(x, w, b, "none", mode="kernel")
    assert NM.launches == before + 1
    want = kops.node_mlp(x, w, b, "none", mode="reference")
    assert got.dtype == want.dtype == dtype
    tol = dict(rtol=2.0 ** -10, atol=1e-5) if dtype == torch.float16 else TOL
    assert_close(got.double().cpu().numpy(), want.double().cpu().numpy(),
                 dict(rtol=0, atol=1) if dtype == torch.int32 else tol)
    with pytest.raises(TypeError):
        NM.node_mlp(x, w, b)


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_gin_stream_with_64_bit_features_matches_cpu(cuda, dtype):
    """int64 and float64 node features narrow to 32 bits as JAX's
    ``jnp.asarray`` does; the card's stream equals the CPU path's."""
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import models as TM
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = TM.paper_config("gin", num_layers=2, hidden=32)
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    graphs = [(s, r, np.abs(np.rint(4 * nf)).astype(dtype), ef) for s, r, nf, ef in
              (g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(4))]
    outs, _, _ = GNNEngine(cfg, params, fused=True, device=cuda).infer_stream(graphs)
    cpu, _, _ = GNNEngine(cfg, params, fused=True, device="cpu").infer_stream(graphs)
    np.testing.assert_allclose(np.concatenate(outs), np.concatenate(cpu),
                               rtol=1e-4, atol=1e-5)


def plain_in_edge_order(fn):
    """``fn()`` under PyTorch's deterministic algorithms: ``index_add_``
    then sums each segment in edge order (a stable sort, then a sequential
    sum), as the segment kernels do.  Its atomics otherwise add a hub's values in a
    varying order, and its long sums then differ by more than TOL where
    they are near 0."""
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("op", ["sum", "mean", "sqsum", "max", "min"])
def test_segment_reduce_kernel_matches_plain(cuda, op):
    """Every case of :func:`segment_case` (hubs too), at F read as float4
    (64, 100), float2 (6) and one float (1, 3, 101); the plain version sums
    in edge order (:func:`plain_in_edge_order`)."""
    rng = np.random.default_rng(20)
    for case in ("empty_and_padding", "all_padding", "wide", "hub"):
        ids, offsets, n = segment_case(rng, case)
        for f in (1, 3, 6, 64, 100, 101):
            values = to_t(rng.normal(size=(ids.shape[0], f)).astype(np.float32), cuda)
            args = (values, to_t(ids, cuda), to_t(offsets, cuda), n, op)
            before = SR.launches
            got = kops.segment_reduce(*args, mode="kernel")
            want = plain_in_edge_order(lambda: kops.segment_reduce(*args, mode="reference"))
            torch.cuda.synchronize()
            assert SR.launches == before + 1
            assert_close(got.cpu(), want.cpu(), TOL)


@pytest.mark.parametrize("heads", [1, 4])
def test_edge_softmax_kernel_matches_plain(cuda, heads):
    """Every case of :func:`segment_case`: with "hub", segments a thread
    serves (degree <= 16), a warp from registers (17, 33, 300) and a warp
    in three passes (1000).  Weights sum to 1 within 1e-5; padding rows 0."""
    rng = np.random.default_rng(21)
    for case in ("empty_and_padding", "all_padding", "wide", "hub"):
        ids, offsets, n = segment_case(rng, case)
        for spread in (1.0, 80.0):
            logits = rng.uniform(-spread, spread, size=(ids.shape[0], heads))
            args = (to_t(logits.astype(np.float32), cuda), to_t(ids, cuda),
                    to_t(offsets, cuda), n)
            got = kops.edge_softmax(*args, mode="kernel")
            want = kops.edge_softmax(*args, mode="reference")
            torch.cuda.synchronize()
            assert_close(got.cpu(), want.cpu(), TOL)
            got = got.cpu().numpy()
            assert (got[ids >= n] == 0).all()
            sums = np.zeros((n, heads))
            np.add.at(sums, ids[ids < n], got[ids < n])
            live = np.diff(offsets) > 0
            assert np.all(np.abs(sums[live] - 1) <= 1e-5)


@pytest.mark.parametrize("f", [1, 2, 3, 6, 64, 100, 101])
def test_segment_reduce_vector_widths_agree(cuda, f):
    """``values`` whose data starts one float past a 16-byte boundary
    (``big[1:]`` viewed as (E, F)) takes the one-float path; the aligned
    copy takes float4 where F is a multiple of 4, float2 where F is even.
    Both match the plain version and each other bit for bit (the same
    sequential sums)."""
    rng = np.random.default_rng(22)
    ids, offsets, n = segment_case(rng, "hub")
    e = ids.shape[0]
    big = to_t(rng.normal(size=(e * f + 1,)).astype(np.float32), cuda)
    shifted = big[1:].view(e, f)
    aligned = shifted.clone()
    plan = (to_t(ids, cuda), to_t(offsets, cuda), n)
    out = torch.empty((n, f), device=cuda)
    assert SR.vector_width(f, shifted, out) == 1
    assert SR.vector_width(f, aligned, out) == (4 if f % 4 == 0 else 2 if f % 2 == 0 else 1)
    for op in SR.OP_CODES:
        got = [kops.segment_reduce(v, *plan, op, mode="kernel") for v in (aligned, shifted)]
        want = plain_in_edge_order(
            lambda: kops.segment_reduce(aligned, *plan, op, mode="reference"))
        torch.cuda.synchronize()
        assert_close(got[0].cpu(), want.cpu(), TOL)
        assert torch.equal(got[0], got[1]), op


def test_segment_kernels_are_deterministic(cuda):
    """Two launches on the same inputs give the same bits (no atomics)."""
    rng = np.random.default_rng(23)
    ids, offsets, n = segment_case(rng, "hub")
    plan = (to_t(ids, cuda), to_t(offsets, cuda), n)
    values = to_t(rng.normal(size=(ids.shape[0], 64)).astype(np.float32), cuda)
    logits = to_t(rng.normal(size=(ids.shape[0], 4)).astype(np.float32), cuda)
    for op in SR.OP_CODES:
        a, b = (kops.segment_reduce(values, *plan, op, mode="kernel") for _ in range(2))
        assert torch.equal(a, b), op
    a, b = (kops.edge_softmax(logits, *plan, mode="kernel") for _ in range(2))
    assert torch.equal(a, b)


def test_segment_kernels_empty_outputs_launch_nothing(cuda):
    before = (SR.launches, ES.launches)
    off = torch.zeros(1, dtype=torch.int32, device=cuda)
    assert SR.segment_reduce(torch.empty((5, 4), device=cuda), off, 0).shape == (0, 4)
    assert ES.edge_softmax(torch.empty((0, 4), device=cuda), off, 0).shape == (0, 4)
    assert (SR.launches, ES.launches) == before


def test_gat_engine_on_card_matches_reference(cuda):
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import models as TM
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = TM.paper_config("gat", num_layers=2)
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(4)]
    before = (NM.launches, SR.launches, ES.launches)
    outs, _, _ = GNNEngine(cfg, params, device=cuda).infer_stream(graphs)
    after = (NM.launches, SR.launches, ES.launches)
    assert all(a > b for a, b in zip(after, before))
    ref_cfg = dataclasses.replace(cfg, kernel_mode="reference")
    refs, _, _ = GNNEngine(ref_cfg, params, device=cuda).infer_stream(graphs)
    np.testing.assert_allclose(np.concatenate(outs), np.concatenate(refs),
                               rtol=1e-4, atol=1e-5)


def test_fused_gin_wider_than_the_kernel_is_refused(cuda):
    """A ``fused=True`` GIN engine at F = 300, past ``fused_mp.MAX_FEATURES``,
    raises the wrapper's ValueError naming the limit before any fused_mp
    launch: the port has no size-based way to the plain version (JAX's
    ``ops.fused_mp`` takes its reference above its VMEM budget).  The CPU
    path serves the same model (``tests/test_torch_models.py``)."""
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import models as TM
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = TM.paper_config("gin", num_layers=2, hidden=300)
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(2)]
    before = FM.launches
    with pytest.raises(ValueError, match=rf"F=300 outside \(0, {FM.MAX_FEATURES}\]"):
        GNNEngine(cfg, params, fused=True, device=cuda).infer_stream(graphs)
    assert FM.launches == before


# ------------------------------------------------------------------ int8


def _qmlp_case(gen, m, k, n, row_scale, device):
    x_q = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    scale = torch.rand((n,), generator=gen) * 9e-3 + 1e-3
    b = torch.randn((n,), generator=gen)
    rs = torch.rand((m, 1), generator=gen) * 0.1 + 1e-3 if row_scale else None
    return [None if t is None else t.to(device) for t in (x_q, w_q, scale, b, rs)]


@pytest.mark.parametrize("row_scale", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
def test_quant_node_mlp_kernel_matches_plain(cuda, activation, row_scale):
    """|kernel - plain| <= 1e-6 + 1e-6 |plain| (the same exact integer
    accumulators and the same rounded tail; gelu's tanh may differ by an
    ulp), as JAX's kernel test holds its Pallas kernel."""
    gen = torch.Generator().manual_seed(1)
    for m, k, n in ((37, 9, 100), (4097, 100, 200), (1, 200, 100), (65, 3, 63)):
        x_q, w_q, scale, b, rs = _qmlp_case(gen, m, k, n, row_scale, cuda)
        before = QM.launches
        got = kops.quant_node_mlp(x_q, w_q, scale, b, activation, row_scale=rs,
                                  mode="kernel")
        assert QM.launches == before + 1
        want = kops.quant_node_mlp(x_q, w_q, scale, b, activation, row_scale=rs,
                                   mode="reference")
        assert QM.launches == before + 1
        assert_close(got.cpu().numpy(), want.cpu().numpy(),
                     dict(rtol=1e-6, atol=1e-6))


def test_quant_node_mlp_kernel_accumulates_exactly(cuda):
    """scale 1 (a 0-d scale, broadcast by the wrapper), bias 0: the output
    is the exact integer product, computed in int64."""
    gen = torch.Generator().manual_seed(2)
    for m, k, n in ((40, 96, 24), (129, 960, 80), (3, 1, 5)):
        x_q, w_q, _, _, _ = _qmlp_case(gen, m, k, n, False, cuda)
        got = kops.quant_node_mlp(x_q, w_q, torch.tensor(1.0, device=cuda),
                                  torch.zeros(n, device=cuda), "none", mode="kernel")
        exact = x_q.cpu().long() @ w_q.cpu().long()
        assert torch.equal(got.cpu().long(), exact)


@pytest.mark.parametrize("gamma", ["gin", "pna", "dgn"])
def test_fused_mp_int8_kernel_matches_plain(cuda, gamma):
    """Exact aggregates (``exact_operands``): the towers, their int8
    quantization and the int32 accumulators agree bit for bit, so PNA's and
    DGN's outputs are equal; GIN's fp32 second linear sums in another
    order (2e-5, JAX's INT8_TOL), and its probe weights show q * rs equal.
    The exact batch, then ``TILE_CASES``' ragged and dead tiles."""
    rng = np.random.default_rng(7)
    plans = [exact_plan_arrays(rng)] + [tile_plan_arrays(rng, *c, exact=True)
                                        for c in TILE_CASES]
    for plan in plans:
        n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
        (phi, ops, _), kw = exact_operands(rng, gamma, n, e)
        spec = TMP.MPSpec(phi, ops, gamma, "int8")
        args = [to_t(plan[k], cuda) for k in PLAN_ARGS]
        cases = [kw] + ([dict(kw, **gin_probe_weights())] if gamma == "gin" else [])
        for i, case in enumerate(cases):
            case = {k: to_t(v, cuda) for k, v in case.items()}
            before = FM.launches
            got = kops.fused_mp(spec, *args, mode="kernel", **case).cpu().numpy()
            assert FM.launches == before + 1
            want = kops.fused_mp(spec, *args, mode="reference", **case).cpu().numpy()
            if gamma == "gin" and i == 0:
                assert_close(got, want, dict(rtol=0, atol=2e-5))
            else:
                np.testing.assert_array_equal(got, want)
            assert (got[~plan["node_mask"]] == 0).all()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_fused_mp_sixteen_row_tiles_match_plain(cuda, precision):
    """PNA at F = 100 (K1 1200) passes 227 KB of shared memory at 32 rows,
    so it runs the 16-row instance (half the threads in the products, 16
    tile words a thread in the int8 row maxima).  fp32 within PNA's
    tolerance; int8 on exact aggregates bit for bit.  The padded batch,
    then ``TILE_CASES``' ragged and dead tiles."""
    int8 = precision == "int8"
    assert FM.rows_for(100, 4, 1200, 0, int8) == 16
    rng = np.random.default_rng(11)
    plans = [exact_plan_arrays(rng) if int8 else plan_arrays(rng)]
    plans += [tile_plan_arrays(rng, *c, exact=int8) for c in TILE_CASES]
    for plan in plans:
        n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
        make = exact_operands if int8 else spec_operands
        (phi, ops, _), kw = make(rng, "pna", n, e, f=100)
        spec = TMP.MPSpec(phi, ops, "pna", precision)
        args = [to_t(plan[k], cuda) for k in PLAN_ARGS]
        kw = {k: to_t(v, cuda) for k, v in kw.items()}
        before = FM.launches, FM.int8_launches
        got = kops.fused_mp(spec, *args, mode="kernel", **kw).cpu().numpy()
        assert (FM.launches, FM.int8_launches) == (before[0] + 1, before[1] + int8)
        want = kops.fused_mp(spec, *args, mode="reference", **kw).cpu().numpy()
        if int8:
            np.testing.assert_array_equal(got, want)
        else:
            assert_close(got, want, PNA_TOL)
        assert (got[~plan["node_mask"]] == 0).all()


def test_int8_engine_on_card_matches_reference(cuda):
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import models as TM
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = TM.paper_config("gin", num_layers=2, hidden=32)
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(4)]
    before = (QM.launches, FM.launches)
    outs, _, _ = GNNEngine(cfg, params, precision="int8", fused=True,
                           device=cuda).infer_stream(graphs)
    assert QM.launches > before[0] and FM.launches > before[1]
    ref_cfg = dataclasses.replace(cfg, kernel_mode="reference")
    refs, _, _ = GNNEngine(ref_cfg, params, precision="int8", fused=True,
                           device=cuda).infer_stream(graphs)
    fp32, _, _ = GNNEngine(cfg, params, fused=True, device=cuda).infer_stream(graphs)
    got, want, fp32 = (np.concatenate(a) for a in (outs, refs, fp32))
    assert np.abs(got - want).mean() <= 0.2 * np.abs(want - fp32).mean() + 1e-5


def dynamic_rows(rng, m, k):
    """fp32 rows for the int8-dynamic recipe: normal values at per-row
    ranges 1e-3 .. 1e2; row 0 all zero (the 1e-8 floor); from row 1 every
    third row ties, (j + 1/2) 2^-e with one +-127 2^-e (rs = 2^-e exactly)."""
    x = (rng.normal(size=(m, k)) * 10.0 ** rng.uniform(-3, 2, size=(m, 1))).astype(np.float32)
    x[0] = 0.0
    for r in range(1, m, 3):
        e = int(rng.integers(-3, 20))
        x[r] = (rng.integers(-127, 127, size=k) + 0.5) * 2.0 ** -e
        x[r, rng.integers(0, k)] = (-1) ** r * 127 * 2.0 ** -e
    return x


@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
def test_quant_node_mlp_dynamic_kernel_matches_plain(cuda, activation):
    """The dynamic entry (rows quantized in the kernel) against its plain
    version, |kernel - plain| <= 1e-6 + 1e-6 |plain| (the same int8 rows and
    exact accumulators; gelu's tanh may differ by an ulp).  Includes K past
    one slice, past w whole in shared memory (K 2000, N 256: the ring) and
    N past one block (257), at ragged M; one launch each, on the dynamic
    entry."""
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(3)
    for m, k, n in ((37, 9, 100), (4097, 100, 200), (1, 200, 100), (65, 3, 63),
                    (130, 960, 80), (40, 2000, 256), (20, 300, 257)):
        _, w_q, scale, b, _ = _qmlp_case(gen, m, k, n, False, cuda)
        x = to_t(dynamic_rows(rng, m, k), cuda)
        before = dict(QM.launches_by_entry)
        got = kops.quant_node_mlp_dynamic(x, w_q, scale, b, activation, mode="kernel")
        assert QM.launches_by_entry == dict(before, dynamic=before["dynamic"] + 1)
        want = kops.quant_node_mlp_dynamic(x, w_q, scale, b, activation, mode="reference")
        assert QM.launches_by_entry == dict(before, dynamic=before["dynamic"] + 1)
        assert_close(got.cpu().numpy(), want.cpu().numpy(), dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("k", [9, 64, 100, 33])
def test_quant_node_mlp_dynamic_x_q_probe(cuda, k):
    """An identity w_q (K = N), w_scale 1, bias 0, no activation: the output
    is the kernel's x_q * rs, equal to the plain version's bit for bit on
    all-zero rows, tie rows (round half to even) and ragged M."""
    rng = np.random.default_rng(k)
    eye = torch.eye(k, dtype=torch.int8, device=cuda)
    one, zero = torch.ones(k, device=cuda), torch.zeros(k, device=cuda)
    for m in (37, 4097):
        x = to_t(dynamic_rows(rng, m, k), cuda)
        got = kops.quant_node_mlp_dynamic(x, eye, one, zero, "none", mode="kernel")
        want = kops.quant_node_mlp_dynamic(x, eye, one, zero, "none", mode="reference")
        q, rs = kref.quantize_rows(x)
        assert torch.equal(got, want) and torch.equal(want, q * rs)
        assert int(((x / rs).remainder(1.0) == 0.5).sum()) > 0


def test_quant_node_mlp_dynamic_wrapper_checks(cuda):
    """fp32 x, w_scale of shape (N,) or (), no launch for an empty M, and a
    refusal (ValueError) where K passes one block's shared memory."""
    x = torch.randn((8, 4), device=cuda)
    w_q = torch.ones((4, 3), dtype=torch.int8, device=cuda)
    b = torch.zeros(3, device=cuda)
    before = dict(QM.launches_by_entry)
    with pytest.raises(TypeError, match="x"):
        QM.quant_node_mlp_dynamic(x.to(torch.int8), w_q, torch.ones(3, device=cuda), b)
    with pytest.raises(ValueError, match="w_scale"):
        QM.quant_node_mlp_dynamic(x, w_q, torch.ones(4, device=cuda), b)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((8, 60000), device=cuda)
        QM.quant_node_mlp_dynamic(big, torch.zeros((60000, 3), dtype=torch.int8, device=cuda),
                                  torch.ones(3, device=cuda), b)
    out = QM.quant_node_mlp_dynamic(torch.empty((0, 4), device=cuda), w_q,
                                    torch.ones(3, device=cuda), b)
    assert out.shape == (0, 3) and QM.launches_by_entry == before
    got = QM.quant_node_mlp_dynamic(x, w_q, torch.tensor(0.5, device=cuda), b)
    want = kref.quant_node_mlp_dynamic_ref(x, w_q, torch.tensor(0.5, device=cuda), b)
    assert torch.equal(got, want)
    assert QM.launches_by_entry == dict(before, dynamic=before["dynamic"] + 1)


def test_gat_int8_forward_launches_six_dynamic(cuda):
    """GAT in int8 at paper width: one forward still launches quant_node_mlp
    6 times (the encoder and the 5 layers' projections), all on the dynamic
    entry, and no separate row-quantization ops: 12 at the warm (the eager
    forward and the CUDA-graph capture), none at a replay."""
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import models as TM
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = TM.paper_config("gat")
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    graph = [g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(1)]
    eng = GNNEngine(cfg, params, precision="int8", fused=True, device=cuda)
    before = dict(QM.launches_by_entry)
    eng.infer_stream(graph)  # warm: an eager forward, then the capture
    assert QM.launches_by_entry == dict(before, dynamic=before["dynamic"] + 12)
    warm = dict(QM.launches_by_entry)
    eng.infer_stream(graph)  # a replay runs no wrapper
    assert QM.launches_by_entry == warm


def test_quant_node_mlp_empty_output_launches_nothing(cuda):
    before = QM.launches
    out = QM.quant_node_mlp(torch.empty((0, 4), dtype=torch.int8, device=cuda),
                            torch.zeros((4, 3), dtype=torch.int8, device=cuda),
                            torch.ones(3, device=cuda), torch.zeros(3, device=cuda))
    assert out.shape == (0, 3) and QM.launches == before


# ---------------------------------------------------------------- flash attention

FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}


def _attention_inputs(device, b, hq, hkv, s, d, dtype, bshd, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def one(h):
        if bshd:  # the serving path's (B, S, H, D) tensors, as (B, H, S, D) views
            return torch.randn((b, s, h, d), generator=gen).to(device, dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen).to(device, dtype)

    return one(hq), one(hkv), one(hkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,s,d,window,softcap,bshd", [
    (4, 2, 77, 16, 0, 0.0, True),
    (4, 4, 130, 128, 0, 0.0, False),
    (8, 1, 200, 64, 48, 0.0, True),
    (4, 2, 65, 256, 0, 20.0, False),
    (2, 2, 1, 8, 0, 0.0, True),
    (4, 2, 100, 32, 16, 0.0, False),
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, hq, hkv, s, d, window,
                                              softcap, bshd):
    q, k, v = _attention_inputs(cuda, 2, hq, hkv, s, d, dtype, bshd)
    before = FA.launches
    got = kops.flash_attention(q, k, v, window=window, softcap=softcap, mode="kernel")
    want = kops.flash_attention(q, k, v, window=window, softcap=softcap, mode="reference")
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    # the output takes q's layout: a (B, S, H, D) view stays one
    assert got.transpose(1, 2).is_contiguous() == bshd
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


# the mma route (bf16 at D 64 / 128 / 256): S 1, 37, 512, 1000 at each D,
# Hq / Hkv 1, 2 and 16, windows, softcaps, (B, S, H, D) views, non-causal
MMA_CASES = [  # (hq, hkv, s, d, causal, window, softcap, bshd)
    (16, 16, 1, 64, True, 0, 0.0, True),
    (2, 1, 37, 64, True, 0, 0.0, False),
    (16, 1, 512, 64, True, 100, 0.0, True),
    (4, 2, 1000, 64, True, 0, 30.0, False),
    (16, 8, 1, 128, True, 0, 0.0, False),
    (16, 16, 37, 128, True, 16, 0.0, True),
    (16, 1, 512, 128, True, 0, 0.0, True),
    (2, 1, 1000, 128, True, 300, 20.0, True),
    (4, 2, 200, 128, False, 0, 0.0, False),
    (16, 16, 1, 256, True, 0, 50.0, True),
    (16, 1, 37, 256, True, 0, 0.0, False),
    (2, 2, 512, 256, True, 128, 0.0, True),
    (16, 8, 1000, 256, True, 0, 0.0, False),
    (4, 4, 300, 256, False, 64, 0.0, True),
]


@pytest.mark.parametrize("hq,hkv,s,d,causal,window,softcap,bshd", MMA_CASES)
def test_flash_attention_mma_route_matches_plain(cuda, hq, hkv, s, d, causal, window,
                                                 softcap, bshd):
    q, k, v = _attention_inputs(cuda, 2, hq, hkv, s, d, torch.bfloat16, bshd, seed=s + d)
    assert FA.route(q.dtype, d) == "mma"
    before = dict(FA.launches_by_route)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = kops.flash_attention(q, k, v, mode="kernel", **kw)
    want = kops.flash_attention(q, k, v, mode="reference", **kw)
    torch.cuda.synchronize()
    assert FA.launches_by_route == dict(before, mma=before["mma"] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    if s > 1:  # at S = 1 both layouts are contiguous
        assert got.transpose(1, 2).is_contiguous() == bshd
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    # the same inputs through the CUDA-core design, forced
    simt = FA.flash_attention(q, k, v, force_route="simt", **kw)
    torch.testing.assert_close(simt.float(), want.float(), **FLASH_TOL[torch.bfloat16])


def test_flash_attention_mma_route_refuses_misaligned_views(cuda):
    b, h, s, d = 1, 4, 64, 128
    q, k, v = _attention_inputs(cuda, b, h, h, s, d, torch.bfloat16, False)
    flat = torch.randn(b * h * s * d + 1, device=cuda).to(torch.bfloat16)
    offset = flat[1:].view(b, h, s, d)                     # 2 bytes past 16
    padded = torch.randn((b, h, s, d + 4), device=cuda).to(torch.bfloat16)[..., :d]
    before = (FA.launches, dict(FA.launches_by_route))
    for bad in (offset, padded):                           # row stride 132
        with pytest.raises(ValueError, match="16-byte"):
            FA.flash_attention(bad, k, v)
        with pytest.raises(ValueError, match="16-byte"):
            FA.flash_attention(q, k, bad)
    with pytest.raises(ValueError, match="no instance"):
        FA.flash_attention(q.float(), k.float(), v.float(), force_route="mma")
    assert (FA.launches, FA.launches_by_route) == before
    # the simt route takes the same views
    got = FA.flash_attention(offset, k, v, force_route="simt")
    want = kops.flash_attention(offset, k, v, mode="reference")
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _attention_inputs(cuda, 1, 4, 2, 16, 32, torch.float32, False)
    before = FA.launches
    bad = [
        dict(q=q.half(), k=k.half(), v=v.half()),           # dtype
        dict(q=q, k=k.bfloat16(), v=v),                      # mixed dtypes
        dict(q=q[..., :24], k=k[..., :24], v=v[..., :24]),   # head dim 24
        dict(q=q, k=k[:, :, :8], v=v[:, :, :8]),             # S differs
        dict(q=q[:, :3], k=k, v=v),                          # Hq % Hkv
        dict(q=q[..., ::2], k=k[..., ::2], v=v[..., ::2]),   # feature stride 2
    ]
    for kw in bad:
        with pytest.raises((ValueError, TypeError)):
            FA.flash_attention(**kw)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, v, window=-1)
    assert FA.launches == before
    empty = torch.empty((1, 4, 0, 32), device=cuda)
    assert FA.flash_attention(empty, empty[:, :2], empty[:, :2]).shape == (1, 4, 0, 32)
    assert FA.launches == before


# MLA's (D, Dv) = (96, 64) (MiniCPM3's prefill: nope 64 + rope 32, v 64):
# ragged S (1, 63, 65, 1025), H 40 as served, GQA, a window, a softcap
MLA_CASES = [  # (hq, hkv, s, window, softcap, bshd)
    (40, 40, 1, 0, 0.0, True),
    (40, 40, 63, 0, 0.0, True),
    (40, 40, 65, 0, 0.0, False),
    (40, 40, 1025, 0, 0.0, True),
    (8, 2, 200, 48, 0.0, False),
    (4, 4, 130, 0, 30.0, True),
]


def _mla_inputs(device, b, hq, hkv, s, dtype, bshd, seed):
    """q (B, Hq, S, 96), k (B, Hkv, S, 96), v (B, Hkv, S, 64)."""
    gen = torch.Generator().manual_seed(seed)

    def one(h, d):
        if bshd:
            return torch.randn((b, s, h, d), generator=gen).to(device, dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen).to(device, dtype)

    return one(hq, 96), one(hkv, 96), one(hkv, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,s,window,softcap,bshd", MLA_CASES)
def test_flash_attention_mla_instance_matches_plain(cuda, dtype, hq, hkv, s, window,
                                                    softcap, bshd):
    """The (96, 64) instance on its route (bf16: mma; fp32: simt) and, for
    bf16, the simt route forced on the same inputs: the output is (B, Hq,
    S, 64) in q's layout, within FLASH_TOL of the plain version (scale
    1 / sqrt(96))."""
    q, k, v = _mla_inputs(cuda, 2, hq, hkv, s, dtype, bshd, seed=s + hq)
    chosen = FA.route(dtype, 96, 64)
    assert chosen == ("mma" if dtype == torch.bfloat16 else "simt")
    before = dict(FA.launches_by_route)
    kw = dict(window=window, softcap=softcap)
    got = kops.flash_attention(q, k, v, mode="kernel", **kw)
    want = kops.flash_attention(q, k, v, mode="reference", **kw)
    torch.cuda.synchronize()
    assert FA.launches_by_route == dict(before, **{chosen: before[chosen] + 1})
    assert got.dtype == dtype and got.shape == (2, hq, s, 64)
    if s > 1:
        assert got.transpose(1, 2).is_contiguous() == bshd
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        simt = FA.flash_attention(q, k, v, force_route="simt", **kw)
        torch.testing.assert_close(simt.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("d, dv", [(96, 32), (64, 96), (24, 16), (128, 64)])
def test_flash_attention_refuses_uninstantiated_head_dims(cuda, d, dv):
    """A (D, Dv) pair without an instance raises on both routes and
    launches nothing: no padding to a wider head, no fallback."""
    gen = torch.Generator().manual_seed(d + dv)
    q, k = (torch.randn((1, 4, 16, d), generator=gen).to(cuda, torch.bfloat16)
            for _ in range(2))
    v = torch.randn((1, 4, 16, dv), generator=gen).to(cuda, torch.bfloat16)
    before = (FA.launches, dict(FA.launches_by_route))
    for force in (None, "simt", "mma"):
        with pytest.raises(ValueError, match="no instance"):
            FA.flash_attention(q, k, v, force_route=force)
    with pytest.raises(ValueError, match="no instance"):
        kops.flash_attention(q, k, v, mode="kernel")
    assert (FA.launches, FA.launches_by_route) == before


def test_lm_server_on_card_matches_reference(cuda):
    """Reduced ChatGLM3 in fp32: the server's flash-kernel prefill against
    its reference mode (plain attention on the card), then the decode
    logits teacher-forced on the kernel server's tokens.  The flash
    wrapper counts where it runs: the first ``generate`` warms prefill
    eagerly and captures it (2 x num_layers launches), a second one only
    replays the graphs and counts nothing."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import LMServer, ServeConfig

    cfg = get_reduced("chatglm3-6b", dtype="float32")
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    scfg = ServeConfig(max_batch=2, prompt_len=24, cache_len=40, max_new_tokens=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (13, 24)]
    before = FA.launches
    srv = LMServer(params, cfg, scfg, device=cuda)
    gen, _ = srv.generate(prompts)
    assert FA.launches == before + 2 * cfg.num_layers
    np.testing.assert_array_equal(srv.generate(prompts)[0], gen)
    assert FA.launches == before + 2 * cfg.num_layers
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
    toks = np.zeros((2, 24), np.int64)
    for i, pr in enumerate(prompts):
        toks[i, -len(pr):] = pr
    tokens = torch.from_numpy(toks).to(cuda)
    forced = torch.from_numpy(gen).to(cuda)
    outs = []
    for mode in ("kernel", "reference"):
        cache, last, t = lm.prefill(params, {"tokens": tokens}, cfg, 40, kernel_mode=mode)
        steps = [last]
        for i in range(gen.shape[1]):
            logits, cache = lm.decode_step(params, cache, forced[:, i:i + 1], t + i, cfg)
            steps.append(logits)
        outs.append(torch.stack(steps))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


def _eager_greedy(params, cfg, scfg, prompts, device, extras=None):
    """The eager loop of ``lm.prefill`` / ``lm.decode_step`` at int
    positions, greedy, as JAX's ``LMServer.generate`` runs it (``extras``:
    a VLM's patches or an audio model's frames, max_batch rows)."""
    from repro_torch.models import lm

    toks = np.zeros((scfg.max_batch, scfg.prompt_len), np.int32)
    for i, pr in enumerate(prompts):
        toks[i, -len(pr):] = pr
    batch = {"tokens": torch.from_numpy(toks).to(device),
             **{k: torch.from_numpy(v).to(device) for k, v in (extras or {}).items()}}
    cache, last, t = lm.prefill(params, batch, cfg, scfg.cache_len)
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    out = []
    for i in range(scfg.max_new_tokens):
        out.append(tok[:, 0])
        logits, cache = lm.decode_step(params, cache, tok, t + i, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return torch.stack(out, 1).cpu().numpy()[:len(prompts)]


def test_moe_lm_server_on_card_matches_reference(cuda):
    """Reduced Qwen3-MoE in fp32: the server's flash-kernel prefill and its
    decode logits, teacher-forced on the server's tokens, against its
    reference mode (plain attention on the card); the first ``generate``
    launches 2 x num_layers flash kernels (warm + capture), a second one
    none and gives the same tokens."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import LMServer, ServeConfig

    cfg = get_reduced("qwen3-moe-30b-a3b", dtype="float32")
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    scfg = ServeConfig(max_batch=2, prompt_len=24, cache_len=40, max_new_tokens=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (13, 24)]
    before = FA.launches
    srv = LMServer(params, cfg, scfg, device=cuda)
    gen, _ = srv.generate(prompts)
    np.testing.assert_array_equal(srv.generate(prompts)[0], gen)
    assert FA.launches == before + 2 * cfg.num_layers
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
    toks = np.zeros((2, 24), np.int64)
    for i, pr in enumerate(prompts):
        toks[i, -len(pr):] = pr
    tokens = torch.from_numpy(toks).to(cuda)
    forced = torch.from_numpy(gen).to(cuda)
    outs = []
    for mode in ("kernel", "reference"):
        cache, last, t = lm.prefill(params, {"tokens": tokens}, cfg, 40, kernel_mode=mode)
        steps = [last]
        for i in range(gen.shape[1]):
            logits, cache = lm.decode_step(params, cache, forced[:, i:i + 1], t + i, cfg)
            steps.append(logits)
        outs.append(torch.stack(steps))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


def test_moe_decode_replay_equals_the_eager_step(cuda):
    """Under deterministic algorithms a reduced Qwen3-MoE server's captured
    decode step (top-k routing, the slot dispatch's sort and gathers, the
    expert GEMMs) gives its eager step's cache, token and output bit for
    bit from the same state."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import LMServer, ServeConfig

    cfg = get_reduced("qwen3-moe-30b-a3b", head_dim=64)
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(6), cfg)
    scfg = ServeConfig(max_batch=4, prompt_len=24, cache_len=40, max_new_tokens=8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (9, 24, 17, 3)]
    torch.use_deterministic_algorithms(True)
    try:
        srv = LMServer(params, cfg, scfg, device=cuda)
        srv.generate(prompts)
        srv.prefill_graph.replay()  # position and step back to the prompt's end
        state = [srv._tok, srv._pos, srv._step, srv._out] + [
            w for c in srv._cache for w in c.values()]
        start = [w.clone() for w in state]
        srv.decode_graph.replay()
        replayed = [w.clone() for w in state]
        for w, w0 in zip(state, start):
            w.copy_(w0)
        srv._decode()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(replayed, state))
    assert not all(torch.equal(a, b) for a, b in zip(replayed, start))  # a step ran


# reduced configs the card serves: MiniCPM3 at its served MLA head dims (the
# flash kernel's (96, 64) instance; the reduced (24, 16) has none)
CARD_REDUCED = {"minicpm3-4b": dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
                                    head_dim=96)}


def _attention_layers(cfg) -> int:
    return sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.num_layers))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ("chatglm3-6b", "gemma3-12b", "starcoder2-15b",
                                  "qwen3-moe-30b-a3b", "mixtral-8x7b", "minicpm3-4b",
                                  "jamba-v0.1-52b", "rwkv6-1.6b", "internvl2-26b",
                                  "whisper-base"))
def test_lm_graphs_give_the_eager_loops_tokens(cuda, arch, dtype):
    """The captured prefill and decode step give the eager loop's tokens,
    token for token; a second ``generate`` captures nothing; a prefill
    replay runs one flash kernel an attention layer (MiniCPM3 all of its,
    Jamba one in eight, RWKV-6 none; the VLM's over patches + prompt, the
    audio decoder's beside the encoder's plain attention) and a decode
    replay none (by the profiler: a replay runs no wrapper)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import LMServer, ServeConfig

    cfg = get_reduced(arch, dtype=dtype, **CARD_REDUCED.get(arch, {}))
    n_attn = _attention_layers(cfg)
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(1), cfg)
    scfg = ServeConfig(max_batch=3, prompt_len=24, cache_len=40, max_new_tokens=8)
    rng = np.random.default_rng(2)
    srv = LMServer(params, cfg, scfg, device=cuda)
    launches = []
    for n in (2, 3):  # the second call: other prompts on the same graphs
        prompts = [rng.integers(1, cfg.vocab_size, k) for k in rng.integers(5, 25, n)]
        extra = lm.extra_input(cfg, scfg.max_batch)  # patches, frames or none
        extras = {} if extra is None else {
            extra[0]: rng.normal(size=extra[1]).astype(np.float32)}
        before = FA.launches
        gen, stats = srv.generate(prompts, extras=extras or None)
        launches.append(FA.launches - before)
        np.testing.assert_array_equal(
            gen, _eager_greedy(params, cfg, scfg, prompts, cuda, extras))
        assert srv.captures == 2 and stats["decode_s_per_token"] > 0
    # warm + capture of prefill, then a generate that only replays
    assert launches == [2 * n_attn, 0]
    prefill = _device_names(srv.prefill_graph.replay)  # rewinds position and step
    decode = _device_names(srv.decode_graph.replay)  # <= 4 replays of 8 steps
    assert sum("flash_fwd" in n for n in prefill) == n_attn
    assert not any("flash_fwd" in n for n in decode)


@pytest.mark.parametrize("arch", ("minicpm3-4b", "jamba-v0.1-52b", "rwkv6-1.6b"))
def test_reduced_server_on_card_matches_its_cpu_run(cuda, arch):
    """A reduced server of each MLA / hybrid / SSM arch in fp32 on the card
    against the same weights on the CPU: prefill and teacher-forced decode
    logits within 1e-4 (fp32 summed in another order; the card's prefill
    attention is the flash kernel, the CPU's the plain version), the
    recurrent states after the run within 1e-4, and the card's tokens the
    CPU's argmax wherever the CPU's top-2 gap is over 1e-3."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import LMServer, ServeConfig

    cfg = get_reduced(arch, dtype="float32", capacity_factor=8.0,
                      **CARD_REDUCED.get(arch, {}))
    params = lm.init_params(torch.Generator().manual_seed(3), cfg)
    scfg = ServeConfig(max_batch=2, prompt_len=24, cache_len=40, max_new_tokens=6)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (13, 24)]
    srv = LMServer(params, cfg, scfg, device=cuda)
    gen, _ = srv.generate(prompts)
    toks = np.zeros((2, 24), np.int64)
    for i, pr in enumerate(prompts):
        toks[i, -len(pr):] = pr
    forced = torch.from_numpy(gen)
    runs = []
    for device, p in ((cuda, srv.params), ("cpu", params)):
        cache, last, t = lm.prefill(p, {"tokens": torch.from_numpy(toks).to(device)}, cfg,
                                    40)
        steps = [last]
        for i in range(gen.shape[1] - 1):
            logits, cache = lm.decode_step(p, cache, forced[:, i:i + 1].to(device), t + i,
                                           cfg)
            steps.append(logits)
        states = [w for c in cache for k, w in c.items() if k not in T.SEQ_CACHE_KEYS]
        runs.append((torch.stack(steps).cpu(), [w.cpu() for w in states]))
    (card, card_states), (cpu, cpu_states) = runs
    torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-4)
    for a, b in zip(card_states, cpu_states):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    top2 = torch.topk(cpu, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1] > 1e-3).T  # (B, steps)
    want = torch.argmax(cpu, dim=-1).T.numpy()
    assert (gen[sure.numpy()] == want[sure.numpy()]).all() and sure.float().mean() > 0.5


# ------------------------------------------------------------ CUDA graphs

# kernel symbol in the profiler's records -> the wrapper counter it answers to
KERNEL_SYMBOLS = (("node_mlp_", NM), ("fused_mp_kernel", FM),
                  ("segment_reduce_kernel", SR), ("edge_softmax_kernel", ES),
                  ("quant_mlp_kernel", QM))


def _graph_executor(cuda, model="gin", precision="fp32"):
    from repro_torch.gnn import models as TM
    from repro_torch.serve.executor import Executor

    cfg = (TM.paper_config("gat", num_layers=2) if model == "gat"
           else TM.paper_config(model, num_layers=2, hidden=32))
    ex = Executor(device=cuda)
    ex.register("m", cfg, TM.init(torch.Generator().manual_seed(0), cfg),
                precision=precision, fused=True)
    return ex


def _graph_inputs(ex, packed, k=8):
    from repro_torch.core import batching as TB
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream

    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(k)]
    if not packed:
        return [ex.prepare_stream(g) for g in graphs]
    budget = TB.BucketBudget(n_pad=512, e_pad=1536, g_pad=k)
    packed_graph, _ = TB.pack_graphs(graphs, budget, device=ex.device)
    return [ex.prepare_packed(packed_graph, budget)]


def _device_names(fn, tries=4):
    """Names of the device records of one call of ``fn``, which launches
    kernels; a profiler session whose record holds no kernel at all lost
    it, and is made again, up to ``tries`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if any(not n.startswith(("Memcpy", "Memset")) for n in names):
            return names
    raise AssertionError(f"the profiler recorded no kernel in {tries} sessions")


def _eager(ex, p):
    from repro_torch.gnn import models as TM

    tenant = ex.tenant()
    fn = TM.forward_program(tenant.cfg, num_graphs=p.num_graphs, fused=tenant.fused)
    with torch.inference_mode():
        return fn(tenant.params, *p.inputs)


def test_one_capture_per_signature_and_none_after_warm(cuda):
    ex = _graph_executor(cuda)
    preps = _graph_inputs(ex, packed=False)
    first = [ex.run(p)[0] for p in preps]
    sigs = len({p.signature for p in preps})
    assert ex.lowered_count == sigs > 0 and ex.compile_seconds > 0
    untimed = ex.untimed_seconds
    again = [ex.run(p)[0] for p in preps]
    assert ex.lowered_count == sigs and ex.untimed_seconds == untimed
    for a, b in zip(first, again):
        assert_close(a, b, TOL)


@pytest.mark.parametrize("model,precision,packed", [
    ("gin", "fp32", False), ("gin", "int8", False), ("gat", "fp32", True)])
def test_replay_equals_eager_bit_for_bit(cuda, model, precision, packed):
    """Under deterministic algorithms (``index_add_``'s atomics otherwise
    sum in a varying order) a replay's output is the eager forward's, bit
    for bit, on the same prepared batch."""
    torch.use_deterministic_algorithms(True)
    try:
        ex = _graph_executor(cuda, model, precision)
        for p in _graph_inputs(ex, packed):
            got, _ = ex.run(p)
            np.testing.assert_array_equal(got, _eager(ex, p).cpu().numpy())
    finally:
        torch.use_deterministic_algorithms(False)


def test_pending_runs_on_one_graph_do_not_alias(cuda):
    """Two runs of one captured graph dispatched before either is harvested:
    each returns its own batch's output (the static output is cloned at
    dispatch), harvested in reverse."""
    ex = _graph_executor(cuda)
    preps = _graph_inputs(ex, packed=False, k=16)
    p1 = preps[0]
    p2 = next(p for p in preps[1:] if p.signature == p1.signature)
    want1, want2 = ex.run(p1)[0], ex.run(p2)[0]
    r1, r2 = ex.run_async(p1), ex.run_async(p2)
    got2, got1 = r2.result()[0], r1.result()[0]
    assert ex.lowered_count == 1 and r1.done and r2.done
    assert_close(got1, want1, TOL)
    assert_close(got2, want2, TOL)
    assert not np.allclose(got1, got2)


@pytest.mark.parametrize("model,precision", [("gin", "fp32"), ("gat", "int8")])
def test_replay_launches_the_captured_kernels(cuda, model, precision):
    """The capture launches what one eager forward launches (the counters
    around the warm, less two eager forwards: the direct one and the warm's
    own), and the profiler finds those kernels, as many of each, in one
    replay, which itself moves no counter."""
    ex = _graph_executor(cuda, model, precision)
    p = _graph_inputs(ex, packed=False)[0]
    counts = lambda: [mod.launches for _, mod in KERNEL_SYMBOLS]
    before = counts()
    _eager(ex, p)
    eager = [a - b for a, b in zip(counts(), before)]
    ex.warm(p)
    captured = [a - b - 2 * e for a, b, e in zip(counts(), before, eager)]
    assert captured == eager and sum(eager) > 0
    before = counts()
    names = _device_names(lambda: ex.run(p))
    assert counts() == before
    replay = [sum(symbol in n for n in names) for symbol, _ in KERNEL_SYMBOLS]
    assert replay == captured


# ------------------------------------------- the dispatch census, the scheduler


def _census():
    from repro_torch.obs.metrics import default_registry

    return dict(default_registry().counter("kernels_dispatch_total").series())


def _census_of(fn) -> dict:
    before = _census()
    fn()
    return {k: v - before.get(k, 0.0) for k, v in _census().items()
            if v != before.get(k, 0.0)}


@pytest.mark.parametrize("model,precision", [("gin", "fp32"), ("gat", "int8")])
def test_census_counts_one_forward_per_warm_signature(cuda, model, precision):
    """K warm signatures count K x one forward's CPU census, all on
    path="kernel": the capture is counted, the eager warm forward and the
    replays are not; a second tenant of the same architecture and params
    structure (one JAX warm key) counts nothing more."""
    from repro_torch.serve.executor import Executor

    ex = _graph_executor(cuda, model, precision)
    preps = _graph_inputs(ex, packed=False)
    k = len({p.signature for p in preps})
    got = _census_of(lambda: [ex.run(p) for p in preps * 2])
    cpu = Executor(device="cpu")
    t = ex.tenant()
    cpu.register("m", t.cfg, _graph_executor_params(model), precision=precision,
                 fused=True)
    one = _census_of(lambda: cpu.run(cpu.prepare_stream(
        [g[:4] for g in _stream(1)][0])))
    assert k > 1 and all(path == "reference" for _, path in one)
    assert got == {(op, "kernel"): k * n for (op, _), n in one.items()}
    ex.register("twin", t.cfg, _graph_executor_params(model), precision=precision,
                fused=True)
    assert _census_of(lambda: [ex.run(p, model="twin") for p in preps]) == {}
    assert ex.lowered_count == 2 * k


def _graph_executor_params(model):
    from repro_torch.gnn import models as TM

    cfg = (TM.paper_config("gat", num_layers=2) if model == "gat"
           else TM.paper_config(model, num_layers=2, hidden=32))
    return TM.init(torch.Generator().manual_seed(0), cfg)


def _stream(k, seed=1):
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream

    return MoleculeStream(MOLHIV, seed=seed).take(k)


def test_scheduler_serial_and_pipelined_on_card(cuda):
    """A packed stream through the scheduler on the card: serial and
    pipelined loops flush the same requests and serve the same bits
    (deterministic algorithms), both within 1e-5 of per-graph
    ``infer_stream``; after the eager ladder prewarm a second run captures
    nothing and reports no compile time."""
    from repro_torch.serve.pipeline import PipelineConfig
    from repro_torch.serve.scheduler import StreamScheduler

    torch.use_deterministic_algorithms(True)
    try:
        ex = _graph_executor(cuda, "gat")
        graphs = [g[:4] for g in _stream(48)]
        ser = StreamScheduler(ex, capacity=4, prewarm="eager")
        rep = ser.run(graphs, qps=0.0, models=["m"] * len(graphs))
        captures = ex.lowered_count
        again = ser.run(graphs, qps=5000.0, models=["m"] * len(graphs))
        assert ex.lowered_count == captures and again.compile_s == 0.0
        pipe = StreamScheduler(ex, capacity=4, prewarm="eager",
                               pipeline=PipelineConfig(2, host_cost="measured"))
        prep = pipe.run(graphs, qps=0.0, models=["m"] * len(graphs))
        assert [f.rids for f in prep.flush_log] == [f.rids for f in rep.flush_log]
        for a, b in zip(rep.outputs, prep.outputs):
            np.testing.assert_array_equal(a, b)
        assert ex.lowered_count == captures
        base = [ex.run(ex.prepare_stream(g))[0] for g in graphs]
        for a, b in zip(rep.outputs, base):
            assert_close(a, b, TOL)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("stage", [True, False])
def test_pipelined_stream_on_a_cold_executor(cuda, stage):
    """The threaded runner on an executor with nothing captured: the warms
    (captures) run on the caller thread while the worker pins and copies;
    outputs equal ``infer_stream``'s bit for bit (deterministic
    algorithms), and the in-flight window holds."""
    from repro_torch.serve.pipeline import PipelinedStream

    torch.use_deterministic_algorithms(True)
    try:
        graphs = [g[:4] for g in _stream(24)]
        cold = _graph_executor(cuda)
        outs, stats = PipelinedStream(cold, inflight=2, stage=stage).run(graphs)
        warm = _graph_executor(cuda)
        base = [warm.run(warm.prepare_stream(g))[0] for g in graphs]
        assert stats["peak_inflight"] <= 2 and len(outs) == len(base)
        for a, b in zip(base, outs):
            np.testing.assert_array_equal(a, b)
        assert cold.lowered_count == len({warm.prepare_stream(g).signature
                                          for g in graphs})
    finally:
        torch.use_deterministic_algorithms(False)


# ------------------------------------------- per-call sorts and the library cache


@pytest.mark.parametrize("model", ["gin", "gat"])
def test_percall_replay_equals_the_shared_path(cuda, model):
    """``share_layout=False`` through the executor's CUDA graphs: outputs bit
    for bit the shared (unfused) executor's, under deterministic
    algorithms; GAT launches its segment kernels on the per-call plan."""
    from repro_torch.gnn import models as TM
    from repro_torch.serve.executor import Executor

    torch.use_deterministic_algorithms(True)
    try:
        cfg = (TM.paper_config("gat", num_layers=2) if model == "gat"
               else TM.paper_config(model, num_layers=2, hidden=32))
        params = TM.init(torch.Generator().manual_seed(0), cfg)
        ex = Executor(device=cuda)
        ex.register("shared", cfg, params)
        ex.register("percall", cfg, params, fused=True, share_layout=False)
        before = (ES.launches, SR.launches, FM.launches)
        for p in _graph_inputs(ex, packed=False):
            a, _ = ex.run(p, model="shared")
            b, _ = ex.run(p, model="percall")
            np.testing.assert_array_equal(a, b)
        assert FM.launches == before[2]
        if model == "gat":
            assert ES.launches > before[0] and SR.launches > before[1]
    finally:
        torch.use_deterministic_algorithms(False)


def test_aot_cache_builds_with_nvcc_then_hits(cuda, tmp_path):
    """A real ``nvcc`` build through the kernel-library cache: a miss
    writes the library back, the next lookup is a hit that runs no
    compiler, and the cached library loads with its C entry points."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.serve.aot import AOTCache, environment_fingerprint

    cache, saved = AOTCache(tmp_path / "aot"), _build._cache
    fingerprint = environment_fingerprint()
    assert fingerprint["device_name"] == torch.cuda.get_device_name(0)
    assert fingerprint["nvcc"] != "none" and fingerprint["driver"] != "none"
    runs = _build.nvcc_runs
    _build.use_cache(cache, fingerprint)
    try:
        logs = _build.build(["segment_reduce"])
        assert "registers" in logs["segment_reduce"] and _build.nvcc_runs == runs + 1
        assert cache.stats == {"hit": 0, "miss": 1, "stale": 0}
        assert _build.build(["segment_reduce"]) == {} and _build.nvcc_runs == runs + 1
        path = _build.ensure_library("segment_reduce")
        assert cache.stats["hit"] == 2 and str(path).startswith(cache.root)
        assert hasattr(ctypes.CDLL(str(path)), "segment_reduce_blocks")
    finally:
        _build._cache = saved


RESTART_CHILD = """
import sys
import numpy as np
import torch
from repro_torch.gnn import models as TM
from repro_torch.kernels import _build
from repro_torch.serve.aot import AOTCache
from repro_torch.serve.gnn_engine import GNNEngine
from repro_torch.data.pipeline import MOLHIV, MoleculeStream

torch.use_deterministic_algorithms(True)
cfg = TM.paper_config("gin", num_layers=2, hidden=32)
eng = GNNEngine(cfg, TM.init(torch.Generator().manual_seed(0), cfg), fused=True,
                aot_cache=AOTCache(sys.argv[1]))
graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=1).take(8)]
outs, _, _ = eng.infer_stream(graphs)
np.save(sys.argv[2], np.concatenate(outs))
s = eng.executor.aot_stats()
print("RESTART hit=%d miss=%d stale=%d nvcc_runs=%d" % (
    s["hit"], s["miss"], s["stale"], _build.nvcc_runs))
"""


def test_restarted_process_runs_no_nvcc(cuda, tmp_path):
    """Process A fills a fresh cache while it serves GIN; process B, given
    only the cache directory, serves the same outputs bit for bit
    (deterministic algorithms) with every library a hit and no ``nvcc``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    runs = []
    for tag in ("a", "b"):
        r = subprocess.run([sys.executable, "-c", RESTART_CHILD, str(tmp_path / "aot"),
                            str(tmp_path / f"{tag}.npy")], capture_output=True,
                           text=True, env=env, timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        line = next(l for l in r.stdout.splitlines() if l.startswith("RESTART"))
        runs.append(dict(f.split("=") for f in line.split()[1:]))
    a, b = runs
    assert int(a["miss"]) > 0 and int(a["nvcc_runs"]) == int(a["miss"])
    assert int(b["hit"]) > 0 and b["miss"] == b["stale"] == b["nvcc_runs"] == "0"
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))


# ---------------------------------------------------------------------------
# training: gradients through the flash kernel, a train step on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("b,hq,hkv,s,d,dv,window,softcap",
                         [(2, 8, 2, 100, 64, 64, 0, 0.0), (1, 8, 8, 70, 96, 64, 0, 0.0),
                          (2, 4, 2, 130, 128, 128, 32, 30.0)])
def test_flash_function_gradients_match_autograd_of_plain(cuda, dtype, b, hq, hkv, s, d,
                                                          dv, window, softcap):
    """``ops.FlashAttention`` (the kernel's forward, the plain backward)
    against autograd of ``flash_attention_ref`` on fp32 copies of the
    inputs: dq, dk, dv at the flash tolerances; the kernel launches once,
    on the route ``route`` names."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(31)
    q, k, v, do = (torch.randn(shape, generator=gen).to(cuda, dt).transpose(1, 2)
                   for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, dv),
                                 (b, s, hq, dv)))
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    before = dict(FA.launches_by_route)
    out = kops.flash_attention(q, k, v, mode="kernel", window=window, softcap=softcap)
    chosen = FA.route(dt, d, dv)
    assert FA.launches_by_route == dict(before, **{chosen: before[chosen] + 1})
    got = torch.autograd.grad(out, (q, k, v), do)
    # the plain forward's autograd on fp32 copies (in bf16 it would sum a
    # KV head's group of per-head gradients in bf16)
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = kref.flash_attention_ref(q32, k32, v32, window=window, softcap=softcap)
    want = torch.autograd.grad(ref, (q32, k32, v32), do.float())
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1.6e-2,
                                                                       atol=1.6e-2)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


def test_blocked_attention_on_cuda_keeps_a_grad_fn(cuda):
    """The train step's attention on the card: the kernel's output carries
    the Function's backward, so the q / k / v projections get gradients
    (the serving path, with no gradient needed, gets the bare output)."""
    from repro_torch.models import layers as TL

    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((2, 64, h, 64), generator=gen).to(cuda, torch.bfloat16)
               .requires_grad_(True) for h in (8, 2, 2))
    out = TL.blocked_attention(q, k, v, mode="kernel")
    assert type(out.grad_fn).__name__ == "TransposeBackward0"
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionBackward"
    out.float().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
               for t in (q, k, v))
    with torch.no_grad():
        assert TL.blocked_attention(q, k, v, mode="kernel").grad_fn is None


@pytest.mark.parametrize("arch", ("chatglm3-6b", "gemma3-12b", "minicpm3-4b",
                                  "rwkv6-1.6b"))
def test_reduced_train_steps_on_card(cuda, arch):
    """Two train steps of a reduced model on the card (bf16, remat): finite
    losses, a finite non-zero gradient on every leaf through the flash
    kernel (two launches an attention layer a step: forward and the remat
    recompute), and the first step's loss and grad_norm within 1e-2 / 2 %
    of reference mode on a copy of the weights."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.loop import device_batch, loss_and_grads, make_train_step

    kw = CARD_REDUCED.get(arch, {} if arch == "rwkv6-1.6b" else {"head_dim": 64})
    cfg = dataclasses.replace(get_reduced(arch, dtype="bfloat16", **kw), remat=True)
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(2), cfg)
    data = iter(SyntheticTokens(TokenPipelineConfig(vocab_size=cfg.vocab_size, batch=2,
                                                    seq_len=64)))
    batch = device_batch(next(data), cuda)
    loss, _, grads = loss_and_grads(params, batch, cfg)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in adamw.leaves(grads))
    ref_loss, _, ref_grads = loss_and_grads(adamw.tree_map(torch.clone, params), batch, cfg,
                                            kernel_mode="reference")
    assert abs(float(loss) - float(ref_loss)) <= 1e-2
    gn, ref_gn = float(adamw.global_norm(grads)), float(adamw.global_norm(ref_grads))
    assert abs(gn - ref_gn) <= 2e-2 * ref_gn
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
    opt = adamw.init(params)
    n_attn = _attention_layers(cfg)
    for i in range(2):
        before = FA.launches
        params, opt, _, m = step(params, opt, None, batch if i == 0 else
                                 device_batch(next(data), cuda))
        assert np.isfinite(float(m["loss"])) and FA.launches - before == 2 * n_attn
    assert int(opt["step"]) == 2


def test_captured_train_step_equals_eager_on_card(cuda):
    """``train.loop.make_runner`` on the card: a reduced ChatGLM3-6B's step
    (bf16, remat, the flash kernel) captured once and replayed gives the
    eager step's losses and grad norms on the same batches, from copies of
    the same weights, within 1e-5 relative (the same kernels on the same
    inputs, under deterministic algorithms; the warm step, the first,
    runs on a side stream), and its optimizer step count."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import runner as TR
    from repro_torch.train.loop import device_batch, make_runner, make_train_step

    cfg = dataclasses.replace(get_reduced("chatglm3-6b", dtype="bfloat16", head_dim=64),
                              remat=True)
    data = SyntheticTokens(TokenPipelineConfig(vocab_size=cfg.vocab_size, batch=2,
                                               seq_len=64))
    batches = [device_batch(b, cuda) for _, b in zip(range(4), iter(data))]
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(3), cfg)
    twin = adamw.tree_map(torch.clone, params)
    torch.use_deterministic_algorithms(True)
    try:
        opt, eager = adamw.init(params), []
        for b in batches:
            params, opt, _, m = step(params, opt, None, b)
            eager.append((float(m["loss"]), float(m["grad_norm"])))
        cap = make_runner(step, twin, adamw.init(twin), None, cuda)
        assert isinstance(cap, TR.CapturedStep)
        got = []
        for b in batches:
            m = cap(b)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        assert cap.graph is not None
    finally:
        torch.use_deterministic_algorithms(False)
    assert np.allclose(got, eager, rtol=1e-5, atol=0), (got, eager)
    assert int(cap.state["opt"]["step"]) == int(opt["step"]) == 4
    cap.close()


def _eager_runner(monkeypatch):
    """Every runner of ``train.runner`` the eager one, on the card too."""
    from repro_torch.train import runner as TR

    monkeypatch.setattr(TR, "captures", lambda device, backend="none": False)


@pytest.mark.parametrize("compression", [False, True])
def test_captured_train_equals_the_eager_runner_on_card(cuda, compression, monkeypatch,
                                                         tmp_path):
    """``train()`` on the card (one CUDA graph a step) against the eager
    runner on the same batches from the same weights, under deterministic
    algorithms: 12 steps, checkpoints every 4, a failure at step 10 restored
    from step 8 in place (one capture for the run); the same steps and
    events, every history row's loss, ce, grad_norm and lr within 1e-5
    relative, and the last checkpoint equals the live tree bit for bit."""
    import dataclasses

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
    from repro_torch.optim import adamw
    from repro_torch.train import runner as TR
    from repro_torch.train.loop import LoopConfig, train

    cfg = dataclasses.replace(get_reduced("chatglm3-6b", dtype="bfloat16", head_dim=64),
                              remat=True)
    data = SyntheticTokens(TokenPipelineConfig(vocab_size=cfg.vocab_size, batch=2,
                                               seq_len=64))

    def run(tag):
        return train(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12),
                     LoopConfig(steps=12, log_every=1, ckpt_every=4, max_retries=1,
                                ckpt_dir=str(tmp_path / tag), grad_compression=compression),
                     data, inject_failure_at=10, device=cuda)

    torch.use_deterministic_algorithms(True)
    try:
        before = (TR.capture_count, TR.replay_count)
        got = run("captured")
        graphs = (TR.capture_count - before[0], TR.replay_count - before[1])
        with monkeypatch.context() as m:
            _eager_runner(m)
            want = run("eager")
    finally:
        torch.use_deterministic_algorithms(False)
    steps = [h["step"] for h in got["history"]]
    assert steps == [h["step"] for h in want["history"]] == list(range(1, 11)) + [9, 10, 11,
                                                                                  12]
    assert graphs == (1, len(steps) - 1)
    failures = lambda out: [e["step"] for e in out["events"] if e["event"] == "failure"]
    assert failures(got) == failures(want) == [10]
    for g, w in zip(got["history"], want["history"]):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, g, w)
    live = {"params": got["params"], "opt": got["opt_state"]}
    step, back = CheckpointManager(str(tmp_path / "captured")).restore(template=live)
    assert step == 12
    for a, b in zip(adamw.leaves(back), adamw.leaves(live)):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)


def test_gin_example_captured_equals_its_eager_step_on_card(cuda, monkeypatch, tmp_path):
    """``examples/torch_train_gin_molhiv.py`` on the card, its step one CUDA
    graph, against its eager step over 10 steps under deterministic
    algorithms: the losses and every parameter leaf within 1e-4 of the
    leaf's (the loss's) largest magnitude, phase 15's gradient tolerance."""
    import importlib.util
    from pathlib import Path

    from repro_torch.optim import adamw
    from repro_torch.train import runner as TR

    spec = importlib.util.spec_from_file_location(
        "torch_train_gin_molhiv",
        Path(__file__).resolve().parent.parent / "examples" / "torch_train_gin_molhiv.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    torch.use_deterministic_algorithms(True)
    try:
        before = (TR.capture_count, TR.replay_count)
        got = ex.main(["10", "--ckpt-dir", str(tmp_path / "a")])
        graphs = (TR.capture_count - before[0], TR.replay_count - before[1])
        with monkeypatch.context() as m:
            _eager_runner(m)
            want = ex.main(["10", "--ckpt-dir", str(tmp_path / "b")])
    finally:
        torch.use_deterministic_algorithms(False)
    assert graphs == (1, 9)
    scale = max(abs(x) for x in want["losses"])
    assert all(abs(a - b) <= 1e-4 * scale for a, b in zip(got["losses"], want["losses"]))
    for a, b in zip(adamw.leaves(got["params"]), adamw.leaves(want["params"])):
        assert a.device.type == "cuda"
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), a.shape


# flash_attention on DTensors (the train loop's mesh branch): 2 gloo ranks
# sharing the card, each rank's block of q (batch, heads) through the
# kernel under local_map; argv rank, world, init, out file
_FLASH_WORLD = r"""
import json, sys
import torch
import torch.distributed as dist

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch import runtime as RT
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops

res = []
# (mesh, B, Hq, Hkv, S, D, dtype): heads cut and kv heads cut with them;
# kv heads whole (one KV head); the batch cut; fp32 on the simt route
for (d, m), b, hq, hkv, s, dd, dt in (((1, 2), 2, 8, 2, 128, 128, torch.bfloat16),
                                      ((1, 2), 2, 8, 1, 128, 128, torch.bfloat16),
                                      ((2, 1), 4, 4, 2, 96, 64, torch.bfloat16),
                                      ((1, 2), 2, 4, 2, 64, 64, torch.float32)):
    mesh = RT.make_debug_mesh(d, m, device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((b, h, s, dd), generator=g, device="cuda").to(dt)
               for h in (hq, hkv, hkv))
    do = torch.randn((b, hq, s, dd), generator=g, device="cuda").to(dt)
    with RT.use_mesh(mesh), RT.active_rules(RT.batch_rules(mesh, b)):
        qd, kd, vd = (RT.logical_constraint(
            DTensor.from_local(t, mesh.device_mesh, [Replicate(), Replicate()]),
            ("batch", ax, None, None)) for t, ax in ((q, "heads"), (k, "kv_heads"),
                                                      (v, "kv_heads")))
        qd, kd, vd = (t.detach().requires_grad_(True) for t in (qd, kd, vd))
        before = FA.launches
        o = kops.flash_attention(qd, kd, vd, causal=True)
        launched = FA.launches - before
        o.backward(DTensor.from_local(do, mesh.device_mesh, [Replicate(), Replicate()])
                   .redistribute(placements=o.placements))
    # the same kernel (and the plain backward) on the whole tensors
    qw, kw, vw = (t.detach().requires_grad_(True) for t in (q, k, v))
    want = kops.flash_attention(qw, kw, vw, causal=True)
    want.backward(do)
    same = lambda a, w: bool(torch.equal(a.full_tensor(), w))
    rel = lambda a, w: float((a.full_tensor().float() - w.float()).abs().max()
                             / w.float().abs().max())
    res.append(dict(launched=launched, kv_whole=hkv % m != 0,
                    out=same(o, want.detach()), dq=same(qd.grad, qw.grad),
                    dk=rel(kd.grad, kw.grad), dv=rel(vd.grad, vw.grad),
                    dkv_same=same(kd.grad, kw.grad) and same(vd.grad, vw.grad)))
with open(out + f".{rank}", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def test_flash_on_each_ranks_block_matches_plain(cuda, tmp_path):
    """The train loop's mesh branch runs the flash kernel on each rank's
    (batch, head) block under ``local_map`` (``kernels.ops._flash_sharded``):
    with two gloo ranks sharing the card, every rank launches it once a
    call, and the gathered output and dq equal the same kernel's (and plain
    backward's) on the whole tensors bit for bit (every (batch, head) is
    computed alone); so do dk and dv where the kv heads are cut with the q
    heads.  A kv head whole on every rank gets each rank's share of its
    gradient, summed in the tensors' dtype: within 1.6e-2 of its largest
    magnitude (the bf16 bound of ``chip_smoke.FLASH_TOL``)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    script = tmp_path / "flash_world.py"
    script.write_text(_FLASH_WORLD)
    init = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", init,
                               str(tmp_path / "out")], env=env, cwd=str(root),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-3000:] for o in outs]
    import json

    for r in range(2):
        for case in json.loads((tmp_path / f"out.{r}").read_text()):
            assert case["launched"] == 1 and case["out"] and case["dq"], case
            assert case["dkv_same"] or (case["kv_whole"]
                                        and max(case["dk"], case["dv"]) <= 1.6e-2), case


# ---------------------------------------------------------------- GNN training
#
# Under grad each GNN wrapper runs its kernel inside ``ops.KernelFunction``
# (the plain version's gradient).  Tolerance: max|g_kernel - g_reference|
# <= 1e-4 max|g_reference| per leaf in fp32 (PNA 3e-3: its std passes
# 0.5 / std back, and where neighbours send nearly equal messages the
# variance is rounding noise: reference mode against itself differs by up
# to ~1e-3 there on the card), as
# ``chip_smoke.py``'s ``GNN_GRAD_TOL``.

GNN_GRAD_TOL = {"fp32": 1e-4, "pna": 3e-3}


def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gnn_batch(device, n=16):
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream, laplacian_eigvec

    raw = MoleculeStream(MOLHIV, seed=0).take(n)
    g = TG.batch_graphs([r[:4] for r in raw], n * 64, n * 192, device=device)
    y = torch.tensor([float(r[4]) for r in raw], device=device)
    eig = np.zeros((n * 64,), np.float32)
    eig[:sum(r[2].shape[0] for r in raw)] = np.concatenate(
        [laplacian_eigvec(r[0], r[1], r[2].shape[0]) for r in raw])
    return g, y, to_t(eig, device)


def _gnn_loss_grads(params, g, y, eig, cfg, fused):
    from repro_torch.gnn import apply
    from repro_torch.optim import adamw

    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        out = apply(params, g, cfg, eigvec=eig if cfg.model == "dgn" else None,
                    num_graphs=y.shape[0], fused=fused)[: y.shape[0], 0]
        loss = torch.mean(torch.clamp(out, min=0) - out * y
                          + torch.log1p(torch.exp(-torch.abs(out))))
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return out, grads


@pytest.mark.parametrize("model,fused", [(m, f) for m in ("gcn", "gin", "gin_vn", "gat",
                                                          "pna", "dgn")
                                         for f in (False, True) if not (f and m == "gat")])
def test_gnn_gradients_in_kernel_mode_match_reference_mode(cuda, model, fused):
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.gnn import init

    cfg = get_gnn_config(model, kernel_mode="kernel")
    params = init(torch.Generator().manual_seed(0), cfg, cuda)
    g, y, eig = _gnn_batch(cuda)
    before = NM.launches
    out, got = _gnn_loss_grads(params, g, y, eig, cfg, fused)
    assert NM.launches > before
    _, want = _gnn_loss_grads(params, g, y, eig,
                              dataclasses.replace(cfg, kernel_mode="reference"), fused)
    tol = GNN_GRAD_TOL["pna" if model == "pna" else "fp32"]
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        if b.abs().max() > 0:
            assert a.abs().max() > 0, i
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), (model, i)


def test_gnn_wrappers_under_grad_return_the_functions_output(cuda):
    g, _, _ = _gnn_batch(cuda, n=4)
    lay = TLY.build_layout(g)
    x = torch.randn(g.num_nodes, 16, device=cuda, requires_grad=True)
    w = torch.randn(16, 8, device=cuda, requires_grad=True)
    b = torch.zeros(8, device=cuda, requires_grad=True)
    e = lay.perm.shape[0]
    z = torch.randn(e, 4, device=cuda, requires_grad=True)
    outs = {
        "node_mlp": kops.node_mlp(x, w, b, mode="kernel"),
        "segment_reduce": kops.segment_reduce(z, lay.ids_sorted, lay.offsets, g.num_nodes,
                                              "max", mode="kernel", perm=lay.perm),
        "edge_softmax": kops.edge_softmax(z, lay.ids_sorted, lay.offsets, g.num_nodes,
                                          mode="kernel", perm=lay.perm),
        "quant_node_mlp_dynamic": kops.quant_node_mlp_dynamic(
            x, torch.randint(-127, 128, (16, 8), dtype=torch.int8, device=cuda),
            torch.full((8,), 1e-2, device=cuda, requires_grad=True), b, mode="kernel"),
    }
    for name, out in outs.items():
        assert type(out.grad_fn).__name__ == "KernelFunctionBackward", name
        assert torch.isfinite(torch.autograd.grad(out.sum(), x if "mlp" in name else z)[0]).all()
    with torch.no_grad():
        assert kops.node_mlp(x, w, b, mode="kernel").grad_fn is None


def test_train_example_step_runs_the_node_mlp_kernel(cuda):
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.optim import adamw

    ex = _example("torch_train_gin_molhiv")
    cfg = get_gnn_config("gin")
    params = init(torch.Generator().manual_seed(0), cfg, cuda)
    opt = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=3, weight_decay=0.01)
    g, y = ex.make_batch(MoleculeStream(MOLHIV, seed=0), None, 0, device=cuda)
    before = NM.launches
    losses = []
    for _ in range(3):
        params, opt, loss, acc = ex.step_fn(params, opt, opt_cfg, cfg, g, y)
        losses.append(float(loss))
    # 17 linears a forward; the step runs it under grad and for the accuracy
    assert NM.launches - before == 3 * 2 * 17
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert int(opt["step"]) == 3
