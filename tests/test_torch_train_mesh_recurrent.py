"""The port's mesh branch of LM training for Mixtral-8x7B (MoE, 4 experts),
Jamba-v0.1 (the hybrid period: Mamba's scan under ``local_map`` over
(batch, inner), attention and MoE layers) and RWKV6-1.6B (the time mix's
recurrence under ``local_map`` over (batch, heads)), each once on a 2-rank
CPU gloo world, ``make_debug_mesh(1, 2)`` under ``batch_rules``.  Reduced
configs in fp32, three steps, against JAX's mesh-less ``train()`` with the
checks and tolerances of ``torch_train_mesh_util``.
"""
import torch_train_mesh_util as U

ARCHS = ("mixtral-8x7b", "jamba-v0.1-52b", "rwkv6-1.6b")
CASES = [(a, (1, 2), "default") for a in ARCHS]

(runs, test_history_matches_jax, test_gathered_params_match_jax,
 test_params_and_moments_placed_by_the_rules) = U.mesh_tests(ARCHS, CASES, world=2)
