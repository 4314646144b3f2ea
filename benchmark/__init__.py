"""The benchmark of the PyTorch/CUDA port (``spmv_topk_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and
prints its result as the last line of standard output.
"""
