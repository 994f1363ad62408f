"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  csrc/node_mlp.cu   NE PE: tiled fp32 linear + bias + activation
  csrc/fused_mp.cu   fused (phi, A, gamma) message-passing layer, fp32
  node_mlp.py        ctypes wrapper of node_mlp.cu (+ launch counter)
  fused_mp.py        ctypes wrapper of fused_mp.cu (+ launch counter)
  _build.py          nvcc build (sm_90a) into build/repro_torch/, at first use
  ops.py             dispatch: kernel for CUDA tensors, ref.py for CPU ones
  ref.py             plain PyTorch versions (the correctness contract)
"""
