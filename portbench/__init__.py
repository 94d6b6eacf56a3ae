"""The benchmark of the PyTorch and CUDA port (``finch_tpu_torch``).

``python3 portbench/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once (``run.py``); the cells,
metrics and their files are named in ``BENCHMARK.json`` at the root of
the repository (``harness.py`` says how each file is found). Nothing
here imports the JAX package or JAX.
"""
