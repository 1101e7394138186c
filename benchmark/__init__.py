"""The benchmark of dladmm_tpu_torch, the PyTorch and CUDA port.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the CUDA card(s) of this
machine and prints one JSON line last. Everything is found by name:
``configs/<config>.json`` (sizes, recipe, source), ``traffic/<mix>.json``
(the mix's parameters and the ``kind`` of its driver,
``traffic/<kind>.py``), ``metrics/<metric>.py`` (one reader per
per-layer metric). ``yardstick/`` (peaks and bounds, the generator's
arithmetic, the trace reading) and ``reference/`` (the plain PyTorch
solver, loss, gradients and optimizer) are frozen here, so the program
under test cannot move them.
"""
