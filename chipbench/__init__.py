"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
:mod:`chipbench.harness` for how a cell's files are found by name.
"""
