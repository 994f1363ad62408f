"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  csrc/node_mlp.cu   NE PE: tiled fp32 linear + bias + activation
  csrc/quant_mlp.cu  quantized NE PE: int8 x int8 -> int32 (__dp4a), fused
                     requantize + bias + activation
  csrc/fused_mp.cu   fused (phi, A, gamma) message-passing layer, fp32 or
                     with gamma's int8 first linear
  csrc/segment_reduce.cu  sorted-segment sum/mean/sqsum/max/min over the plan
  csrc/edge_softmax.cu    GAT's per-destination, per-head edge softmax
  csrc/flash_attention.cu causal / windowed GQA attention, online softmax
                     (the LM substrate's prefill attention), fp32 or bf16
  node_mlp.py, quant_mlp.py, fused_mp.py, segment_reduce.py, edge_softmax.py,
  flash_attention.py ctypes wrappers of the six kernels (+ launch counters)
  _build.py          nvcc build (sm_90a) at first use, into build/repro_torch/
                     or a fingerprinted cache (serve/aot.py)
  ops.py             dispatch: kernel for CUDA tensors, ref.py for CPU ones
  ref.py             plain PyTorch versions (the correctness contract)
"""
