"""portbench: the benchmark of the PyTorch/CUDA port ``tpugan_torch``.

One command runs one cell once (``python3 -m portbench.run --workload NAME
--seed N --seconds S --trace 0|1``). Everything a cell needs is found by
name: ``BENCHMARK.json`` at the checkout's root lists the configurations,
cells and metrics; ``configs/<config>.json`` holds a configuration's sizes,
``configs/<config>.py`` drives the port through it, ``reference/<config>.py``
is its plain PyTorch reference, ``workloads/<cell>.json`` a cell's traffic
and limits, and ``metrics/<metric>.py`` reads one per-layer metric. A module
file takes the name with ``-`` and ``.`` written as ``_``.

Nothing here imports JAX or the JAX package ``tpugan``; the references
import nothing of ``tpugan_torch``.
"""
