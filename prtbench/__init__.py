"""prtbench: the benchmark of the PyTorch and CUDA renderer
(``parallelraytracing_tpu_torch``).

One command runs one cell once::

    python3 -m prtbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; each configuration,
traffic mix, per-layer metric, kernel-to-layer name map and cell's limits
is a file of its own here (``configs/``, ``traffic/``, ``metrics/``,
``layers/``, ``checks/``), found by its name.  ``reference.py`` is the
plain PyTorch path tracer that decides ``correct``; it imports nothing of
the renderer.
"""
