"""PyTorch + CUDA port of the GenGNN reproduction (``src/repro`` is the
JAX reference it is tested against).

The package mirrors ``repro``'s module layout so each module's counterpart
is found by name.  It imports ``torch`` and ``numpy`` only — never ``jax``
and nothing of ``repro`` (``tests/test_torch_models.py`` enforces that).

Entry points (``serve.gnn_engine.GNNEngine``, ``serve.executor.Executor``,
``serve.engine.LMServer``, ``launch.serve``) run on ``device="cuda"``
unless the caller asks for the CPU.  The GNNs' dense linears and whole
fused message-passing layers, and the dense LMs' prefill attention, run
through hand-written CUDA kernels (``kernels/csrc``); on CPU tensors the
same wrappers use their plain PyTorch versions (``kernels/ref.py``).
"""
