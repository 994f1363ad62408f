"""The port's mesh branch of LM training for the families beyond
``test_torch_train_mesh.py``'s dense and MoE ones, each once on a 2-rank CPU
gloo world, ``make_debug_mesh(1, 2)`` under ``batch_rules`` (the model axis
takes heads, mlp, vocab, experts and Mamba's inner dim): Gemma-3's window and
softcap, StarCoder2's tied head (logits over the vocab-sharded ``embed.T``),
MiniCPM3's MLA (latent projections replicated), InternVL2's patches and
Whisper-base's encoder, cross-attention and frames.
Reduced configs in fp32, three steps, against JAX's mesh-less ``train()``
with the checks and tolerances of ``torch_train_mesh_util``.
"""
import torch_train_mesh_util as U

ARCHS = ("gemma3-12b", "starcoder2-15b", "minicpm3-4b", "internvl2-26b", "whisper-base")
CASES = [(a, (1, 2), "default") for a in ARCHS]

(runs, test_history_matches_jax, test_gathered_params_match_jax,
 test_params_and_moments_placed_by_the_rules) = U.mesh_tests(ARCHS, CASES, world=2)
