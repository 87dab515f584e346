"""Device kernels of the port: hand-written CUDA (``csrc/``) behind
wrappers that run the plain PyTorch version on CPU tensors.

- :mod:`tfkaldi_tpu_torch.ops.fused_mlp`: ``fused_ffn_block``
- :mod:`tfkaldi_tpu_torch.ops.frame_preemph`: ``frame_preemph``
- :mod:`tfkaldi_tpu_torch.ops.bn_fused_bwd`: ``bn_dgrad`` (the backward of
  ``BnReluLayer``)

Each module keeps its kernel's launch count in its ``launches`` global.
"""
