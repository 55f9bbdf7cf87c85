"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the checkout's root names each cell as one
configuration and one traffic mix; ``python3 -m opbench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one (``run.py``).
Everything is found by name, so a cell, a configuration, a traffic mix
or a per-layer metric is added by adding a file and an entry:

  configs/<config>.json   the configuration as it is run: the Table-3
                          row the matrix matches and the generator's
                          window, the value type, the ``SpgemmConfig``
                          fields, the check's limits and what it assumes;
  traffic/<traffic>.json  the traffic mix: the driver it names and the
                          driver's parameters;
  drivers/<driver>.py     a driver, ``Driver``: how one product is made
                          (the closed loop of ``harness.ClosedLoop``);
  metrics/<metric>.py     a per-layer metric's reader, ``read(ctx)``.

The yardstick lives here too: Table 3 and the generator of a matrix
with a Table-3 row's statistics (``matrices.py``, its window found by
``calibrate.py``), the operand made from the seed (``operands.py``), the
plain reference and the comparison that decides ``correct``
(``reference.py``), the counts of bytes and operations and the card's
peaks (``counts.py``), the reduction of a profiler trace (``trace.py``),
and the readings the check's limits were set from (``limits.py``).
Nothing here imports JAX or the JAX package ``repro``.
"""
