"""PyTorch/CUDA port of the ``repro`` model stack, for one NVIDIA Hopper card.

The JAX package ``repro`` is the reference this package is tested against;
nothing here imports it (or JAX).  Slice 1 covers greedy serving of dense
attention decoders: ``launch.serve`` -> ``serve.decode`` ->
``models.transformer`` -> ``kernels.ops``, whose prefill attention runs the
hand-written CUDA kernel in ``kernels/csrc/flash_attention.cu`` on a CUDA
tensor.
"""
