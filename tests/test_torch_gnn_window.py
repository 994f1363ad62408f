"""The sharded GNN forward's window of the plan, on a gloo world of 2 CPU
ranks: a rank's in-edges as a window of the plan's own length (E_pad) that
starts at its first owned edge, the slots past its last one masked, so
that nothing is read back to the host and the forward can be captured.

Node outputs of one batch sharded against the same forward whole, bit for
bit (every reduction runs per destination in the plan's edge order; GIN+VN
pools a graph's rows across ranks, two partial sums: within tolerance), on
the shared plan and on the per-call-sort path, for a bucket both ranks hold
real rows of and one whose last rank owns no edge (its rows all padding).
``Tensor.item`` / ``tolist`` and the other reads back to the host raise
while the rank's inputs are cut and the forward runs.  Also which
executors capture their forwards, by device, ranks and backend, and that
a sharded executor is freed with its last reference.
"""
import json

import pytest

from test_torch_distributed import WORLD_PREAMBLE, run_world

MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")
BITS_MODELS = ("gcn", "gin", "gat", "pna", "dgn")
TOL = 1e-5  # GIN+VN: max |sharded - whole| / max |whole|
N_PAD, E_PAD = 64, 192

_SCRIPT = WORLD_PREAMBLE + r"""
import contextlib, dataclasses, json
from repro_torch import runtime as RT
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.core import layout as LY
from repro_torch.core import message_passing as MP
from repro_torch.gnn import init
from repro_torch.gnn import models as M
from repro_torch.runtime import partitioning as PT
from repro_torch.serve.executor import Executor

N_PAD, E_PAD = 64, 192
READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@contextlib.contextmanager
def no_host_reads(log):
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(name):
        def read(self, *a, **k):
            log.append(name)
            raise RuntimeError(f"Tensor.{name} read a tensor back to the host")
        return read

    for name in READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def graphs(k, lo, hi, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(lo, hi))
        e = int(rng.integers(n, 2 * n))
        out.append((rng.integers(0, n, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32),
                    rng.normal(size=(n, 9)).astype(np.float32),
                    rng.normal(size=(e, 3)).astype(np.float32)))
    return out


# both ranks hold real rows (40-60 of 64); the last rank's rows all
# padding (at most 30 of 64 real), so it owns no edge
BUCKETS = {"both": graphs(4, 10, 16, 0), "empty": graphs(2, 8, 16, 1)}
mesh = RT.make_flat_mesh(2, axis="data", device="cpu")
res = {"reads": []}
for model in ("gcn", "gin", "gin_vn", "gat", "pna", "dgn"):
    cfg = dataclasses.replace(get_gnn_config(model), task="node")
    params = init(torch.Generator().manual_seed(0), cfg)
    ex = Executor(buckets=((N_PAD, E_PAD),), device="cpu", mesh=mesh)
    fused = model != "gat"
    for bucket, gs in BUCKETS.items():
        p = ex.prepare_batched(gs, len(gs), N_PAD, E_PAD, with_eigvec=model == "dgn")
        g, eig, _ = p.inputs
        for path, share in (("plan", True), ("per-call", False)):
            with torch.inference_mode(), ex._mesh_scope():
                shard = PT.row_shard(g.num_nodes)
                whole = M.apply(params, g, cfg, eigvec=eig, num_graphs=len(gs),
                                share_layout=share, fused=fused)
                log = []
                with no_host_reads(log):
                    plan = LY.build_layout(g) if share else None
                    lg, le, ll = MP.shard_inputs(g, eig, plan, shard)
                    out = M.apply(params, lg, cfg, eigvec=le, num_graphs=len(gs),
                                  layout=ll, share_layout=share, fused=fused)
                res["reads"] += log
                edges = MP.owned_edges(LY.build_layout(g), shard)
                key = f"{model} {bucket} {path}"
                res[key] = dict(
                    bits=bool(torch.equal(out, whole)),  # node rows: whole on every rank
                    err=float((out - whole).abs().max() / whole.abs().max()),
                    window=int(edges.index.shape[0]), owned=int(edges.owned.sum()),
                    masked_ids=(None if ll is None else
                                sorted(set(ll.ids_sorted[~edges.owned].tolist()))),
                    mask_equals_owned=bool(torch.equal(lg.edge_mask, edges.owned)))
# a sharded executor goes with its last reference, its program records
# (and on the card its CUDA graphs) with it: no reference cycle holds it
import gc, weakref
gc.disable()
cfg = get_gnn_config("gin")
ex = Executor(buckets=((N_PAD, E_PAD),), device="cpu", mesh=mesh)
ex.register("gin", cfg, init(torch.Generator().manual_seed(0), cfg), fused=True)
ex.run(ex.prepare_batched(BUCKETS["both"], 4, N_PAD, E_PAD))
freed = weakref.ref(ex)
del ex
res["freed"] = freed() is None
gc.enable()
every = [None] * world
dist.all_gather_object(every, res)
if rank == 0:
    print(json.dumps(every))
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, from one 2-rank world."""
    out = run_world(_SCRIPT, 2, tmp_path_factory.mktemp("gnn_window"))
    return json.loads(out[0].strip().splitlines()[-1])


@pytest.mark.parametrize("path", ["plan", "per-call"])
@pytest.mark.parametrize("bucket", ["both", "empty"])
@pytest.mark.parametrize("model", MODELS)
def test_window_node_outputs_equal_the_whole_forward(ranks, model, bucket, path):
    """Sharded node outputs (whole on every rank) against the whole
    forward: bit for bit, GIN+VN within 1e-5 of its largest."""
    for r in ranks:
        case = r[f"{model} {bucket} {path}"]
        if model in BITS_MODELS:
            assert case["bits"], case
        else:
            assert case["err"] <= TOL, case


def test_cutting_the_inputs_and_the_forward_read_nothing_back(ranks):
    """No ``Tensor.item`` / ``tolist`` / ``numpy`` / ``bool`` / ``int`` /
    ``float`` / ``index`` while the plan is built, the rank's inputs cut and
    its forward run (each raises there; a sharded forward that read one
    back would fail its case)."""
    assert all(r["reads"] == [] for r in ranks), [r["reads"] for r in ranks]


def test_window_is_the_plans_length_with_its_tail_masked(ranks):
    """Each rank's window has E_pad slots; its owned slots (the graph's
    ``edge_mask``) split the real edges between the ranks; the masked
    slots carry the out-of-range destination ``n_local`` in the rank's
    plan; the last rank of the "empty" bucket owns no edge."""
    n_local = N_PAD // 2
    for model in MODELS:
        for bucket in ("both", "empty"):
            cases = [r[f"{model} {bucket} plan"] for r in ranks]
            assert all(c["window"] == E_PAD and c["mask_equals_owned"] for c in cases)
            assert all(c["masked_ids"] in ([], [n_local]) for c in cases), cases
            if bucket == "empty":
                assert cases[1]["owned"] == 0 and cases[0]["owned"] > 0
            else:
                assert all(c["owned"] > 0 for c in cases)


def test_a_sharded_executor_goes_with_its_last_reference(ranks):
    """Its forwards' closures hold the mesh and rules, not the executor, so
    it is freed (on the card with its CUDA graphs) as the last reference
    goes, with the cycle collector off: at the same point on every rank,
    before the process group is destroyed."""
    assert all(r["freed"] for r in ranks)


@pytest.mark.parametrize("device,ranks_,backend,want", [
    ("cuda", 1, "none", True), ("cuda", 1, "gloo", True), ("cuda", 1, "nccl", True),
    ("cuda", 4, "nccl", True), ("cuda", 2, "gloo", False), ("cpu", 1, "none", False),
    ("cpu", 2, "gloo", False)])
def test_which_executors_capture(device, ranks_, backend, want):
    """A forward is captured on the card, on one rank or on an NCCL mesh;
    a gloo mesh of several ranks runs eagerly (a gloo collective cannot
    be captured), and so does the CPU."""
    from repro_torch.serve.executor import captures

    assert captures(device, ranks_, backend) is want
