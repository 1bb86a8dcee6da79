"""Benchmark of dpvo_torch, the PyTorch / CUDA port of DPVO, on NVIDIA GPUs.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

BENCHMARK.json at the root of the checkout lists the workloads (cells):
each names a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json, which also gives the number of clients). Spans (spans/<name>.json), per-layer metric
readers (metrics/<name>.py) and roofline bounds (bounds/<name>.py) are
found by name, so a cell or a metric is added by adding files. The plain
reference that decides `correct` is reference/; it imports nothing of
dpvo_torch.
"""
