"""The benchmark of the PyTorch/CUDA port (``pytorch_distributed_tpu_torch``).

One command runs one cell once, on the machine it is started on::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything the harness needs is found by name under this folder: a
configuration in ``configs/<config>.json``, a cell (its traffic, strategy
and correctness limits) in ``cells/<cell>.json``, the code that builds a
model family's trainer and inputs in ``drivers/<driver>.py``, a per-layer
metric's reader in ``metrics/<metric>.py`` and the kernel-name patterns of
a kernel family in ``kernels/<family>.json``. ``BENCHMARK.json`` at the
root lists the cells, the metrics and their bounds.

The yardstick lives here and not in the program: the plain fp32
references (``reference/``), the operation and byte counts and the table
of peaks (``counts.py``), the reading of the device trace (``trace.py``)
and the comparison that decides ``correct`` (``judge.py``). Nothing here
imports JAX or the JAX package, and the references import nothing of the
port.
"""
