"""The port's model of costs (``repro_torch.roofline``), counterpart of
``tests/test_roofline.py`` with the recorder in place of HLO parsing:

* a fake world of 4 ranks (a child process: the world is process-global)
  issues an all-reduce, an all-gather, a reduce-scatter and an all-to-all
  of known bytes, by ``torch.distributed`` and by DTensor (functional
  collectives, the all-to-all op), and each record holds its result bytes,
  group size and the ring cost;
* ``cell_roofline``, ``collective_seconds`` and ``summarize_collectives``
  against JAX's on the same records, the terms rescaled by the ratio of
  the two hardware constants (1e-12 relative); the bf16 correction as
  JAX's;
* ``model_flops`` and ``active_param_count`` equal to JAX's, exactly, for
  all ten configs: reduced on the port's real parameters, full size on the
  port's fake tensors, each against JAX's ``eval_shape`` tree;
* the per-device FLOP counter never counts DTensor's propagation at global
  shapes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import params as JP
from repro import roofline as JR
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import lm as JLM
from repro_torch import roofline as R
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parent.parent


def _child(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


_COLLECTIVES = r"""
import json, logging
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
logging.disable(logging.WARNING)
from repro_torch import roofline as R
from repro_torch.launch import dryrun as D
from repro_torch.runtime import compat

D.fake_world(4)
mesh = compat.make_mesh((4,), ("x",), device="cpu")
x = torch.ones(8, 16, dtype=torch.bfloat16)  # 256 bytes
out = {}
with R.CollectiveRecorder() as rec:
    dist.all_reduce(x)
    dist.all_gather_into_tensor(x.new_empty(32, 16), x)
    dist.reduce_scatter_tensor(x.new_empty(2, 16), x)
    dist.all_to_all_single(torch.empty_like(x), x)
out["c10d"] = rec.records
with D.fake_mode(), D._dtensor_as_on_cards(), R.CollectiveRecorder() as rec:
    f = DTensor.from_local(torch.ones(8, 16), mesh.device_mesh, [Shard(0)], run_check=False)
    f.redistribute(mesh.device_mesh, [Replicate()])
    f.redistribute(mesh.device_mesh, [Shard(1)])
out["dtensor"] = rec.records
out["counts"] = rec.counts
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world_records():
    return _child(_COLLECTIVES)


def test_fake_world_collectives_hold_the_ring_cost(fake_world_records):
    recs = fake_world_records["c10d"]
    assert [r["op"] for r in recs] == ["all-reduce", "all-gather", "reduce-scatter",
                                       "all-to-all"]
    ar, ag, rs, a2a = recs
    assert all(r["group_size"] == 4 and r["dtype"] == "bf16" for r in recs)
    assert (ar["result_bytes"], ag["result_bytes"], rs["result_bytes"],
            a2a["result_bytes"]) == (256, 1024, 64, 256)
    assert ar["wire_bytes"] == 2 * 256 * 3 / 4
    assert ag["wire_bytes"] == 1024 * 3 / 4
    assert rs["wire_bytes"] == 64 * 3
    assert a2a["wire_bytes"] == 256 * 3 / 4


def test_dtensor_redistributions_are_recorded_as_on_cards(fake_world_records):
    """Shard -> Replicate is a functional all-gather of the whole (each
    rank's 8 x 16 fp32 block, 512 bytes, gathered from 4); Shard(0) ->
    Shard(1) is the card's all-to-all (a CPU mesh would all-gather and
    chunk)."""
    ag, a2a = fake_world_records["dtensor"]
    assert ag["op"] == "all-gather" and ag["result_bytes"] == 4 * 8 * 16 * 4
    assert ag["group_size"] == 4 and ag["dtype"] == "f32"
    assert a2a["op"] == "all-to-all" and a2a["group_size"] == 4
    assert a2a["result_bytes"] == 8 * 16 * 4  # the rank's block, resharded
    assert a2a["wire_bytes"] == a2a["result_bytes"] * 3 / 4
    counts = fake_world_records["counts"]
    assert counts["all_gather"][0] == 1 and counts["all_to_all"][0] == 1


RECORDS = [
    {"op": "all-reduce", "result_bytes": int(1e9), "group_size": 16,
     "wire_bytes": 2 * 1e9 * 15 / 16, "dtype": "f32"},
    {"op": "all-gather", "result_bytes": 4096, "group_size": 2,
     "wire_bytes": 2048.0, "dtype": "bf16"},
    {"op": "reduce-scatter", "result_bytes": int(3e6), "group_size": 16,
     "wire_bytes": 45e6, "dtype": "bf16"},
    {"op": "all-to-all", "result_bytes": 777, "group_size": 8,
     "wire_bytes": 777 * 7 / 8, "dtype": "s32"},
]


def test_summary_and_collective_seconds_are_jax_s_rescaled():
    assert R.summarize_collectives(RECORDS) == JR.summarize_collectives(RECORDS)
    for pod in (None, 2):
        got = R.collective_seconds(RECORDS, pod_group_size=pod)
        # each record's seconds rescale by the ratio of its link's bandwidth
        want = sum(c["wire_bytes"] / (R.DCI_BW if pod and c["group_size"] == pod
                                      else R.ICI_BW) for c in RECORDS)
        jax_s = JR.collective_seconds(RECORDS, pod_group_size=pod)
        jax_rescaled = sum(
            (c["wire_bytes"] / (JR.DCI_BW if pod and c["group_size"] == pod else JR.ICI_BW))
            * ((JR.DCI_BW / R.DCI_BW) if pod and c["group_size"] == pod
               else (JR.ICI_BW / R.ICI_BW)) for c in RECORDS)
        assert got == pytest.approx(want, rel=1e-12)
        assert jax_rescaled == pytest.approx(got, rel=1e-12) and jax_s > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cell_roofline_terms_are_jax_s_rescaled(multi_pod):
    rec = {"flops_per_device": 3.1e14, "bytes_per_device": 7.7e11,
           "memory": {"argument_bytes": int(2e10), "output_bytes": int(1e9),
                      "temp_bytes": int(5e9)},
           "collectives": RECORDS, "multi_pod": multi_pod,
           "model_flops_per_device": 1.9e14}
    got, want = R.cell_roofline(rec), JR.cell_roofline(rec)
    assert got["compute_s"] == pytest.approx(want["compute_s"] * JR.PEAK_FLOPS / R.PEAK_FLOPS,
                                             rel=1e-12)
    for k in ("memory_s", "memory_s_hlo"):
        assert got[k] == pytest.approx(want[k] * JR.HBM_BW / R.HBM_BW, rel=1e-12)
    coll = sum(c["wire_bytes"] / (R.DCI_BW if multi_pod and c["group_size"] == 2
                                  else R.ICI_BW) for c in RECORDS)
    assert got["collective_s"] == pytest.approx(coll, rel=1e-12)
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    terms = {"compute": got["compute_s"], "memory": got["memory_s"],
             "collective": got["collective_s"]}
    assert got["bound"] == max(terms, key=terms.get)
    assert got["step_lower_bound_s"] == max(terms.values())
    assert got["roofline_fraction"] == pytest.approx(got["compute_s"] / max(terms.values()))


def test_unit_terms_and_the_pod_link():
    """JAX's unit cases on H100 constants: 1 s of compute, args + 2 x temps
    of memory, 2 s of collectives; a pod-axis group costed at InfiniBand."""
    rec = {"flops_per_device": R.PEAK_FLOPS, "bytes_per_device": R.HBM_BW * 10,
           "memory": {"argument_bytes": int(R.HBM_BW * 0.1), "output_bytes": 0,
                      "temp_bytes": int(R.HBM_BW * 0.1)},
           "collectives": [{"op": "all-reduce", "result_bytes": 1, "group_size": 16,
                            "wire_bytes": R.ICI_BW * 2.0, "dtype": "bf16"}],
           "model_flops_per_device": R.PEAK_FLOPS * 0.5}
    rf = R.cell_roofline(rec)
    assert np.isclose(rf["compute_s"], 1.0) and np.isclose(rf["memory_s"], 0.3)
    assert np.isclose(rf["collective_s"], 2.0) and rf["bound"] == "collective"
    assert np.isclose(rf["roofline_fraction"], 0.5)
    assert np.isclose(rf["useful_flops_ratio"], 0.5)
    pod = [{"op": "all-reduce", "result_bytes": 1, "group_size": 2,
            "wire_bytes": R.DCI_BW, "dtype": "bf16"}]
    assert np.isclose(R.collective_seconds(pod, pod_group_size=2), 1.0)
    assert np.isclose(R.collective_seconds(pod), R.DCI_BW / R.ICI_BW)


def test_h100_constants_and_no_tpu_figure():
    assert (R.PEAK_BF16_FLOP_S, R.PEAK_FP32_FLOP_S, R.PEAK_INT8_OPS) == (989e12, 67e12, 1979e12)
    assert (R.PEAK_HBM_BYTES_S, R.NVLINK_BYTES_S, R.IB_BYTES_S) == (3.35e12, 450e9, 50e9)
    assert (R.PEAK_FLOPS, R.HBM_BW, R.ICI_BW, R.DCI_BW) == (
        R.PEAK_BF16_FLOP_S, R.PEAK_HBM_BYTES_S, R.NVLINK_BYTES_S, R.IB_BYTES_S)
    for tpu in (JR.PEAK_FLOPS, JR.HBM_BW, JR.DCI_BW):
        assert tpu not in (R.PEAK_FLOPS, R.HBM_BW, R.DCI_BW)


def test_bf16_correction_is_jax_s():
    colls = [{"op": "all-reduce", "result_bytes": int(1e9), "group_size": 4,
              "wire_bytes": 1e9, "dtype": "f32"},
             {"op": "all-reduce", "result_bytes": int(1e3), "group_size": 4,
              "wire_bytes": 1e3, "dtype": "f32"},
             {"op": "all-gather", "result_bytes": int(1e9), "group_size": 4,
              "wire_bytes": 1e9, "dtype": "bf16"}]
    for bf16 in (True, False):
        assert R.bf16_normalization_correction(colls, bf16) == \
            JR.bf16_normalization_correction(colls, bf16)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax_reduced_on_real_params(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    # JAX's count reads shapes and axes only: its abstract tree suffices
    jtree = jax.eval_shape(lambda key: JLM.init_params(key, jcfg), jax.random.PRNGKey(0))
    axes = lm.param_axes(cfg)
    assert R.active_param_count(params, axes) == JR.active_param_count(jtree)
    for kind in ("train", "prefill", "decode"):
        assert R.model_flops(cfg, params, 4096.0, kind) == \
            JR.model_flops(jcfg, jtree, 4096.0, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax_full_size_on_fake_tensors(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, jcfg = get_config(arch), jget_config(arch)
    with FakeTensorMode():
        params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    jtree = jax.eval_shape(lambda key: JLM.init_params(key, jcfg), jax.random.PRNGKey(0))
    assert JP.is_param(jax.tree.leaves(jtree, is_leaf=JP.is_param)[0])
    tokens = 256.0 * 4096
    assert R.active_param_count(params, lm.param_axes(cfg)) == JR.active_param_count(jtree)
    assert R.model_flops(cfg, params, tokens, "train") == \
        JR.model_flops(jcfg, jtree, tokens, "train")


_PROPAGATION = r"""
import json, logging
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
logging.disable(logging.WARNING)
from repro_torch import roofline as R
from repro_torch.launch import dryrun as D
from repro_torch.runtime import compat

D.fake_world(4)
dm = compat.make_mesh((2, 2), ("data", "model"), device="cpu").device_mesh
out = {}
for fake in (False, True):
    ctx = D.fake_mode() if fake else torch.no_grad()
    with ctx, R.FlopCounter() as fc:
        x = DTensor.from_local(torch.ones(8, 64), dm, [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.ones(64, 32), dm, [Replicate(), Shard(1)], run_check=False)
        torch.matmul(x, w)
    out[str(fake)] = [fc.flops]
print(json.dumps(out))
"""


def test_flop_counter_counts_the_local_op_only():
    """(16, 64) @ (64, 64) over a 2x2 mesh: the rank multiplies its (8, 64)
    block by its (64, 32) columns, 2 * 8 * 64 * 32 FLOPs, on real and on
    fake tensors (DTensor's global-shape pass not counted)."""
    got = _child(_PROPAGATION)
    for fake in ("False", "True"):
        assert got[fake][0] == 2 * 8 * 64 * 32, got
