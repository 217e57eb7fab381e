"""PyTorch/CUDA port of the ``repro`` model stack, for one NVIDIA Hopper card.

The JAX package ``repro`` is the reference this package is tested against;
nothing here imports it (or JAX).  It covers greedy serving of decoders
built from ``attn``, ``local``, ``rglru`` and ``mamba`` blocks (qwen3-32b,
falcon-mamba-7b, recurrentgemma-9b): ``launch.serve`` -> ``serve.decode`` ->
``models.transformer`` -> ``kernels.ops``.  On a CUDA tensor, prefill runs
the hand-written CUDA kernels in ``kernels/csrc/``: flash attention, the
mamba1 selective scan and the RG-LRU recurrence.
"""
