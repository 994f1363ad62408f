"""The pipelined stream loop (``StreamScheduler(..., pipeline=...)``) on a
mesh: gloo worlds of 2 and 4 CPU ranks serve GIN (paper width, a node
task, fused) as a stream with arrivals through the sharded executor, each
rank reading a clock of its own (rank r's advances 2**-11 * 4**r s a
reading; arrivals, the wait, the SLO and the scripted pack seconds in
units of the slowest step), against the unsharded pipelined run on the slowest rank's clock.

Each flush's compute seconds and each flush's host pack seconds are the
slowest rank's (one all-reduce MAX each a flush), so every rank takes the
unsharded run's flushes and sheds, float for float, and serves its node
outputs bit for bit.  Two host costs: a scripted per-flush sequence, and
``"measured"`` (each rank's own pack seconds on its own clock, agreed by
the all-reduce).
"""
import numpy as np
import pytest

from test_torch_distributed import WORLD_PREAMBLE, run_world

_SCRIPT = WORLD_PREAMBLE + r"""
import dataclasses
from pathlib import Path
from repro_torch import runtime as RT
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.gnn import init as gnn_init
from repro_torch.serve.clock import Clock
from repro_torch.serve.gnn_engine import GNNEngine
from repro_torch.serve.pipeline import PipelineConfig
from repro_torch.serve.scheduler import StreamScheduler

torch.use_deterministic_algorithms(True)
d = Path(sys.argv[4])


class Stepping(Clock):
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def now(self):
        self.t += self.step
        return self.t

    def advance_to(self, t_s):
        return self.now()


cfg = dataclasses.replace(get_gnn_config("gin"), task="node")
params = gnn_init(torch.Generator().manual_seed(0), cfg)
graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(16)]
mesh = RT.make_flat_mesh(world, axis="data", device="cpu")
slow = 2**-11 * 4**(world - 1)  # the slowest rank's step: the stream's time unit
COSTS = {"scripted": [slow / 2, 2 * slow, slow], "measured": "measured"}
out = {}
for case, host_cost in COSTS.items():
    for tag, m, step in (("plain", None, slow),
                         ("sharded", mesh, 2**-11 * 4**rank)):
        eng = GNNEngine(cfg, params, device="cpu", fused=True, mesh=m)
        eng.executor.clock = Stepping(step)
        rep = StreamScheduler(eng, capacity=4, max_wait_s=slow, slo_s=3 * slow,
                              pipeline=PipelineConfig(inflight=2, host_cost=host_cost)
                              ).run(graphs, qps=16 / slow)
        out[f"{case} flushes {tag}"] = np.array(
            [(f.rids[0], len(f.rids), f.rung_multiple, f.misses, f.at_s, f.start_s,
              f.done_s, f.compute_s) for f in rep.flush_log])
        out[f"{case} sheds {tag}"] = np.array(
            [(s.rid, s.at_s, s.projected_delay_s) for s in rep.shed]).reshape(-1, 3)
        served = [o for o in rep.outputs if o is not None]
        out[f"{case} served {tag}"] = np.array([i for i, o in enumerate(rep.outputs)
                                                if o is not None])
        out[f"{case} nodes {tag}"] = np.concatenate(served)
np.savez(d / f"rank{rank}.npz", **out)
print("DONE", flush=True)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def world(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"pipeline_mesh{request.param}")
    outs = run_world(_SCRIPT, request.param, d / "world", args=(d,))
    assert all("DONE" in o for o in outs), outs
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(request.param)]


@pytest.mark.parametrize("case", ["scripted", "measured"])
def test_every_rank_takes_the_unsharded_pipelined_flushes(world, case):
    plain = world[0][f"{case} flushes plain"]
    assert len(plain) > 1 and len(np.unique(plain[:, 2])) > 1  # several rungs
    assert len(world[0][f"{case} sheds plain"])  # and admission shed some
    for got in world:
        np.testing.assert_array_equal(got[f"{case} flushes sharded"],
                                      got[f"{case} flushes plain"])
        np.testing.assert_array_equal(got[f"{case} flushes sharded"], plain)
        np.testing.assert_array_equal(got[f"{case} sheds sharded"],
                                      got[f"{case} sheds plain"])


@pytest.mark.parametrize("case", ["scripted", "measured"])
def test_every_rank_serves_the_unsharded_node_outputs_bit_for_bit(world, case):
    for got in world:
        np.testing.assert_array_equal(got[f"{case} served sharded"],
                                      got[f"{case} served plain"])
        np.testing.assert_array_equal(got[f"{case} nodes sharded"],
                                      got[f"{case} nodes plain"])


def test_measured_pack_seconds_are_the_slowest_ranks(world):
    """Under ``"measured"`` each rank packs on its own clock; the agreed
    pack seconds put every dispatch a whole slowest step past its pack's
    start, which a faster rank alone would not."""
    n = len(world)
    slowest = 2**-11 * 4**(n - 1)
    f = world[0]["measured flushes sharded"]
    first_at, first_start = f[0, 4], f[0, 5]
    assert first_start - first_at == pytest.approx(slowest, rel=0, abs=1e-12)
