"""The benchmark of ``cartpole_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
result line. Everything a cell needs is data found by name: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, which names the driver in ``drivers/``), the
limits of its correctness check (``limits/<cell>.json``) and one reader per
per-layer metric (``metrics/<metric>.py``). The plain reference that
decides ``correct`` is ``reference/``, which imports nothing of the port.
"""
