"""Sharded GNN serving of the port on a gloo world of 2 CPU ranks, against
the port's unsharded engine and the JAX package's unsharded outputs
(counterparts of ``tests/test_gnn_serving.py``'s and
``tests/test_stream_scheduler.py``'s sharded tests).

JAX computes its outputs here, in this process: the six paper models at
paper width (params from ``jax.random.PRNGKey(0)``, carried to the ranks
by ``repro_torch.convert.from_jax_params``) batched 4 graphs to a (64,
192) bucket, so that both ranks hold real rows, and GIN packed through
JAX's ``StreamScheduler`` (capacity 2).  The world (one process a rank,
180 s limit) serves the same graphs through ``GNNEngine(mesh=...)`` and
the unsharded engine, fp32 and GIN int8 packed, and a (65, 192) bucket
whose 65 rows do not divide the axis (it serves whole on every rank, with
nothing all-gathered), and GIN through the scheduler again, as a stream
with arrivals, each rank reading a clock of its own.  Tolerance: rtol 1e-4 / atol 1e-5,
JAX's bound for its sharded serving.
"""
import numpy as np
import pytest
import torch

import jax

from repro.gnn import models as JM
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro.serve.scheduler import StreamScheduler as JScheduler
from repro_torch.convert import from_jax_params
from test_torch_distributed import WORLD_PREAMBLE, run_world

MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")
N_PAD, E_PAD, BATCH = 64, 192, 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _jcfg(model):
    if model == "gin_vn":
        return JM.paper_config("gin", virtual_node=True)
    return JM.paper_config(model)


def _graphs(cfg, k=8):
    """JAX's sharded-serving graphs (seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(k):
        n = int(rng.integers(6, 16))
        e = int(rng.integers(n, 2 * n))
        out.append((rng.integers(0, n, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32),
                    rng.normal(size=(n, cfg.feat_dim)).astype(np.float32),
                    rng.normal(size=(e, cfg.edge_dim)).astype(np.float32)))
    return out


_SCRIPT = WORLD_PREAMBLE + r"""
from pathlib import Path
from repro_torch import runtime as RT
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.runtime import partitioning as PT
from repro_torch.serve.gnn_engine import GNNEngine
from repro_torch.serve.scheduler import StreamScheduler

d = Path(sys.argv[4])
N_PAD, E_PAD, BATCH = 64, 192, 4
mesh = RT.make_flat_mesh(2, axis="data", device="cpu")
data = np.load(d / "graphs.npz")
graphs = [tuple(data[f"{i}_{k}"] for k in range(4)) for i in range(len(data.files) // 4)]
out = {}
for model in ("gcn", "gin", "gin_vn", "gat", "pna", "dgn"):
    cfg = get_gnn_config(model)
    params = torch.load(d / f"{model}.pt")
    eig = model == "dgn"
    fused = model != "gat"
    plain = GNNEngine(cfg, params, device="cpu", fused=fused)
    sharded = GNNEngine(cfg, params, device="cpu", fused=fused, mesh=mesh)
    assert sharded.rules["nodes"] == ("data",)
    out[f"{model} plain"] = plain.infer_batched(graphs, BATCH, N_PAD, E_PAD, with_eigvec=eig)[0]
    PT.reset_collective_bytes()
    out[f"{model} sharded"] = sharded.infer_batched(graphs, BATCH, N_PAD, E_PAD, with_eigvec=eig)[0]
    out[f"{model} gathered"] = np.array(PT.collective_bytes["all_gather"])
# a stream with arrivals (4096 qps) in which each rank's executor reads a
# clock of its own: rank r's advances 2**-11 * 4**r s a reading, so each
# rank measures its own flush times, and rank 1's alone would choose other
# rungs and shed other requests; the unsharded engine reads rank 1's clock
from repro_torch.serve.clock import Clock


class Stepping(Clock):
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def now(self):
        self.t += self.step
        return self.t

    def advance_to(self, t_s):
        return self.now()


cfg = get_gnn_config("gin")
params = torch.load(d / "gin.pt")
stream = graphs * 3
for case, kw in (("max-wait", dict(max_wait_s=2**-11)),
                 ("slo", dict(max_wait_s=2**-11, slo_s=2**-9))):
    for tag, m, step in (("plain", None, 2**-9), ("sharded", mesh, 2**-11 * 4**rank)):
        eng = GNNEngine(cfg, params, device="cpu", fused=True, mesh=m)
        eng.executor.clock = Stepping(step)
        rep = StreamScheduler(eng, capacity=4, **kw).run(stream, qps=4096.0)
        served = [o for o in rep.outputs if o is not None]
        out[f"{case} stream {tag}"] = np.stack(served)
        out[f"{case} schedule {tag}"] = np.array(
            [(f.rids[0], len(f.rids), f.rung_multiple, f.at_s, f.done_s)
             for f in rep.flush_log] + [(s.rid, 0, 0, 0.0, 0.0) for s in rep.shed])
cfg = get_gnn_config("gin")
params = torch.load(d / "gin.pt")
for precision in ("fp32", "int8"):
    reps = [StreamScheduler(GNNEngine(cfg, params, device="cpu", precision=precision,
                                      fused=True, mesh=m), capacity=2).run(graphs, qps=0.0)
            for m in (None, mesh)]
    out[f"gin {precision} packed plain"] = np.stack(reps[0].outputs)
    out[f"gin {precision} packed sharded"] = np.stack(reps[1].outputs)
PT.reset_collective_bytes()
out["replicated sharded"] = GNNEngine(cfg, params, device="cpu", fused=True, mesh=mesh
                                      ).infer_batched(graphs, BATCH, N_PAD + 1, E_PAD)[0]
out["replicated gathered"] = np.array(PT.collective_bytes["all_gather"])
out["replicated plain"] = GNNEngine(cfg, params, device="cpu", fused=True
                                    ).infer_batched(graphs, BATCH, N_PAD + 1, E_PAD)[0]
np.savez(d / f"rank{rank}.npz", **out)
print("DONE", flush=True)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX's outputs, each rank's outputs) for every case."""
    d = tmp_path_factory.mktemp("gnn_sharded")
    graphs = _graphs(_jcfg("gin"))
    np.savez(d / "graphs.npz", **{f"{i}_{k}": a for i, g in enumerate(graphs)
                                  for k, a in enumerate(g)})
    want = {}
    for model in MODELS:
        jcfg = _jcfg(model)
        jp = JM.init(jax.random.PRNGKey(0), jcfg)
        torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, jp)), d / f"{model}.pt")
        fused = model != "gat"
        want[model] = JEngine(jcfg, jp, fused=fused).infer_batched(
            graphs, BATCH, N_PAD, E_PAD, with_eigvec=model == "dgn")[0]
        if model == "gin":
            rep = JScheduler(JEngine(jcfg, jp, fused=True), capacity=2).run(graphs, qps=0.0)
            want["gin packed"] = np.stack([np.asarray(o) for o in rep.outputs])
    outs = run_world(_SCRIPT, 2, d / "world", args=(d,))
    assert all("DONE" in o for o in outs), outs
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return want, ranks


@pytest.mark.parametrize("model", MODELS)
def test_sharded_batched_matches_unsharded_and_jax(served, model):
    want, ranks = served
    for got in ranks:
        np.testing.assert_allclose(got[f"{model} sharded"], got[f"{model} plain"], **TOL)
        np.testing.assert_allclose(got[f"{model} sharded"], want[model], **TOL)
        assert got[f"{model} gathered"] > 0  # the layers read their sources remotely


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_sharded_packed_gin_through_the_scheduler(served, precision):
    want, ranks = served
    for got in ranks:
        sharded = got[f"gin {precision} packed sharded"]
        np.testing.assert_allclose(sharded, got[f"gin {precision} packed plain"], **TOL)
        if precision == "fp32":
            np.testing.assert_allclose(sharded, want["gin packed"], **TOL)


@pytest.mark.parametrize("case", ["max-wait", "slo"])
def test_stream_with_arrivals_keeps_one_schedule_on_every_rank(served, case):
    """Each rank measures its own flush times, on a clock of its own; each
    flush's time is the slowest rank's, so both ranks take the unsharded
    engine's flushes, rungs and sheds on the slower clock, and serve its
    outputs (JAX's bound)."""
    _, ranks = served
    plain = ranks[0][f"{case} schedule plain"]
    assert len(np.unique(plain[:, 2])) > 1 or (plain[:, 1] == 0).any()  # rungs or sheds
    for got in ranks:
        np.testing.assert_array_equal(got[f"{case} schedule sharded"], plain)
        np.testing.assert_allclose(got[f"{case} stream sharded"],
                                   got[f"{case} stream plain"], **TOL)


def test_bucket_that_does_not_divide_serves_replicated(served):
    _, ranks = served
    for got in ranks:
        assert got["replicated gathered"] == 0
        np.testing.assert_allclose(got["replicated sharded"], got["replicated plain"], **TOL)


def test_every_rank_returns_the_same_outputs(served):
    _, (r0, r1) = served
    for key in r0:
        if key.endswith("sharded"):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
