"""The port's mesh branch of LM training on a 4-rank CPU gloo world: reduced
ChatGLM3-6B (dense) and Qwen3-MoE-30B-A3B (MoE) in fp32, three steps on
``make_debug_mesh(2, 2)`` under ``batch_rules`` and ``fsdp_rules`` (4 runs
in one world), against JAX's mesh-less ``train()`` on the same weights and
batches (``torch_train_mesh_util``), with the checks of
``test_torch_train_mesh.py``:

  * every step's loss and grad_norm within 1e-5 relative, and the gathered
    parameters within 1e-5 + 1e-5 |JAX| (both widened by twice the port's
    own mesh-less distance from JAX: the util's RTOL note);
  * the parameters and the AdamW moments are DTensors placed as
    ``resolve_spec`` resolves their logical axes (JAX's
    ``tree_shardings``).

JAX's own mesh branch on a 2x2 mesh of 4 forced host devices (a
subprocess) is held too: against JAX's mesh-less run within 1e-5, and the
port's 2x2 run against it by the same rule as against the mesh-less one.
"""
import torch_train_mesh_util as U

ARCHS = ("chatglm3-6b", "qwen3-moe-30b-a3b")
MESHES = ((2, 2),)
PRESETS = ("default", "fsdp")
CASES = [(a, m, r) for a in ARCHS for m in MESHES for r in PRESETS]


(runs, test_history_matches_jax, test_gathered_params_match_jax,
 test_params_and_moments_placed_by_the_rules) = U.mesh_tests(ARCHS, CASES, world=4)


def test_port_2x2_matches_jax_own_mesh_branch(runs, tmp_path):
    refs, got = runs
    ref, meshless = refs["chatglm3-6b"]
    U.write_inputs(tmp_path, "chatglm3-6b", ref["init"])
    jax_mesh = U.jax_mesh_history("chatglm3-6b", tmp_path)
    assert [h["step"] for h in jax_mesh] == [1, 2, 3]
    for g, w in zip(jax_mesh, ref["history"]):
        for k in U.HISTORY_KEYS:
            assert abs(g[k] - w[k]) <= U.RTOL * abs(w[k]), (k, g[k], w[k])
    U.assert_history_close(got[U.tag("chatglm3-6b", (2, 2), "default")]["history"],
                           jax_mesh, meshless["history"])
