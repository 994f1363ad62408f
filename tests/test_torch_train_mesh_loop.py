"""The loop's mesh branch beyond a plain run, on CPU gloo worlds, reduced
ChatGLM3-6B in fp32 against JAX's mesh-less ``train()`` on the same weights
and batches (``torch_train_mesh_util``):

  * ``grad_compression=True`` on ``make_debug_mesh(1, 2)`` (``batch_rules``)
    and ``(2, 1)`` (``fsdp_rules``) against JAX's compressed run: each
    block quantized against its tensor's global amax.  Held as
    ``test_torch_train.py`` holds the mesh-less compressed run
    (``HISTORY_RTOL`` / ``PARAMS_TOL`` with compression: an element one ulp
    apart can round to the next int8 quantum);
  * ``inject_failure_at=3`` on the same two meshes, a checkpoint every 2
    steps: the loop restores step 2 (placed on the mesh) and ends at step
    4, as JAX's run with the same injection does, with JAX's history
    (held as ``test_torch_train_mesh.py`` holds a plain run's);
  * elastic: a 4-rank world trains 2 steps on a 2x2 mesh and saves; a
    2-rank world resumes from that checkpoint on 1x2 and trains to step 4,
    against JAX resuming its own step-2 checkpoint.
"""
import pytest

import torch_train_mesh_util as U
from test_torch_train import HISTORY_RTOL, PARAMS_TOL

import numpy as np

ARCH = "chatglm3-6b"
MESHES = (((1, 2), "default"), ((2, 1), "fsdp"))


def mtag(kind, mesh, rules) -> str:
    return f"{kind}_{mesh[0]}x{mesh[1]}_{rules}"


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("meshloop")
    ref = U.jax_reference(ARCH)
    U.write_inputs(wd, ARCH, ref["init"])
    jax = {"compression": U.jax_reference(ARCH, compression=True),
           "failure": U.jax_reference(ARCH, steps=4, inject_failure_at=3, ckpt_every=2)}
    meshless = {"failure": U.port_meshless(ARCH, ref["init"], steps=4,
                                           inject_failure_at=3, ckpt_every=2)}
    jdir = wd / "jax_elastic"
    U.jax_reference(ARCH, steps=2, ckpt_every=2, ckpt_dir=str(jdir), total_steps=4)
    jax["elastic"] = U.jax_reference(ARCH, steps=4, ckpt_every=2, ckpt_dir=str(jdir))
    pdir = str(wd / "port_elastic")
    U.run_port(wd, 4, [dict(arch=ARCH, mesh=[2, 2], rules="default", tag="save",
                            steps=2, total_steps=4, ckpt_every=2, ckpt_dir=pdir)])
    runs = [dict(arch=ARCH, mesh=[1, 2], rules="default", tag="elastic", steps=4,
                 ckpt_every=2, ckpt_dir=pdir)]
    for mesh, rules in MESHES:
        runs.append(dict(arch=ARCH, mesh=list(mesh), rules=rules,
                         tag=mtag("compression", mesh, rules), compression=True))
        runs.append(dict(arch=ARCH, mesh=list(mesh), rules=rules,
                         tag=mtag("failure", mesh, rules), steps=4, inject_failure_at=3,
                         ckpt_every=2))
    return jax, meshless, U.run_port(wd, 2, runs)


@pytest.mark.parametrize("mesh,rules", MESHES)
def test_compressed_training_on_a_mesh_matches_jax(loop_runs, mesh, rules):
    jax, _, got = loop_runs
    run, want = got[mtag("compression", mesh, rules)], jax["compression"]
    assert len(run["history"]) == len(want["history"])
    for g, w in zip(run["history"], want["history"]):
        for k in U.HISTORY_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=HISTORY_RTOL[True], err_msg=k)
    for k, w in want["params"].items():
        np.testing.assert_allclose(run["params"][k], w, err_msg=k, **PARAMS_TOL[True])


@pytest.mark.parametrize("mesh,rules", MESHES)
def test_injected_failure_restores_on_the_mesh(loop_runs, mesh, rules):
    jax, meshless, got = loop_runs
    run, want = got[mtag("failure", mesh, rules)], jax["failure"]
    assert [tuple(e) for e in run["events"]] == want["events"] == [(3, "failure")]
    # steps 1-3, the failure at step 3 (the fourth step), step 2's
    # checkpoint restored, steps 3-4 again
    assert [h["step"] for h in run["history"]] == [h["step"] for h in want["history"]] \
        == [1, 2, 3, 3, 4]
    U.assert_history_close(run["history"], want["history"], meshless["failure"]["history"])


def test_elastic_restore_from_2x2_onto_1x2(loop_runs):
    jax, _, got = loop_runs
    run, want = got["elastic"], jax["elastic"]
    assert [h["step"] for h in run["history"]] == [h["step"] for h in want["history"]] \
        == [3, 4]
    for g, w in zip(run["history"], want["history"]):
        for k in U.HISTORY_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=U.RTOL, err_msg=k)
    # the resumed parameters are placed by the 1x2 mesh's rules
    assert run["placements"] == U.expected_placements(ARCH, (1, 2), "default",
                                                      want["params"])
