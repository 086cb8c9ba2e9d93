"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

Everything a cell is made of is found by name from files:

* ``configs/<config>.json`` — the deployment's sizes, with its plain
  reference beside it as ``configs/<config>_ref.py``;
* ``traffic/<traffic>.json`` — the mix's parameters, read by the general
  generator that the file names (``generators/<generator>.py``);
* ``limits/<workload>.json`` — each number the correctness check compares,
  with its limit;
* ``metrics/<metric>.py`` — one reader a metric, end-to-end or per layer.

``yardstick/`` holds what later changes to the program must not move:
the NVML readings, the profiler's classifier and interval arithmetic, the
peaks and the work of each roofline.
Nothing here imports ``jax`` or the JAX package ``repro``, and the
references import nothing of ``repro_torch``.
"""
