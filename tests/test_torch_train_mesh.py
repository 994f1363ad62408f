"""The port's mesh branch of LM training on 2-rank CPU gloo worlds: reduced
ChatGLM3-6B (dense) and Qwen3-MoE-30B-A3B (MoE) in fp32, three steps on
``make_debug_mesh(1, 2)`` and ``(2, 1)`` under ``batch_rules`` and
``fsdp_rules`` (8 runs in one world), against JAX's mesh-less
``train()`` on the same weights and batches (``torch_train_mesh_util``):

  * every step's loss and grad_norm within 1e-5 relative, and the gathered
    parameters within 1e-5 + 1e-5 |JAX| (both widened by twice the port's
    own mesh-less distance from JAX: the util's RTOL note);
  * the parameters and the AdamW moments are DTensors placed as
    ``resolve_spec`` resolves their logical axes (JAX's
    ``tree_shardings``).

The 2x2 mesh runs in ``test_torch_train_mesh_2x2.py``; the other families,
compression, failure injection, elastic restore and the launcher in the
other ``test_torch_train_mesh_*.py`` files.
"""
import torch_train_mesh_util as U

ARCHS = ("chatglm3-6b", "qwen3-moe-30b-a3b")
MESHES = ((1, 2), (2, 1))
PRESETS = ("default", "fsdp")
CASES = [(a, m, r) for a in ARCHS for m in MESHES for r in PRESETS]


(runs, test_history_matches_jax, test_gathered_params_match_jax,
 test_params_and_moments_placed_by_the_rules) = U.mesh_tests(ARCHS, CASES, world=2)
