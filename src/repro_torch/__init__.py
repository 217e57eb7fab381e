"""PyTorch/CUDA port of the ``repro`` model stack, for one NVIDIA Hopper card.

The JAX package ``repro`` is the reference this package is tested against;
nothing here imports it (or JAX).  It covers greedy serving of decoders
built from ``attn``, ``local``, ``rglru`` and ``mamba`` blocks (qwen3-32b,
falcon-mamba-7b, recurrentgemma-9b): ``launch.serve`` -> ``serve.decode`` ->
``models.transformer`` -> ``kernels.ops``.  On a CUDA tensor, prefill runs
the hand-written CUDA kernels in ``kernels/csrc/``: flash attention, the
mamba1 selective scan and the RG-LRU recurrence.  Training
(``launch.train``) checkpoints through the paper's file-system stack:
``core`` is a copy of ``repro.core`` (BaseFS, the consistency layers, the
cost model, the fault plane, the formal model and its checker), and
``checkpoint`` ports the reference's ``CheckpointManager``.  The rest of the
paper's system is copied too: ``io`` (the synthetic workloads and SCR),
``data.dlio`` (the preloaded DL-ingest store, which ``data.pipeline``'s
``TokenPipeline`` feeds to the train step) and ``analysis`` (race checks,
litmus fuzzing, the DES-invariant lint).  ``examples`` holds runnable twins
of the reference's ingest, train-and-checkpoint and quickstart examples.
"""
