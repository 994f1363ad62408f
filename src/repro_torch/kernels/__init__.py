"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  csrc/node_mlp.cu   NE PE: tiled fp32 linear + bias + activation
  csrc/fused_mp.cu   fused (phi, A, gamma) message-passing layer, fp32
  csrc/segment_reduce.cu  sorted-segment sum/mean/sqsum/max/min over the plan
  csrc/edge_softmax.cu    GAT's per-destination, per-head edge softmax
  node_mlp.py, fused_mp.py, segment_reduce.py, edge_softmax.py
                     ctypes wrappers of the four kernels (+ launch counters)
  _build.py          nvcc build (sm_90a) into build/repro_torch/, at first use
  ops.py             dispatch: kernel for CUDA tensors, ref.py for CPU ones
  ref.py             plain PyTorch versions (the correctness contract)
"""
