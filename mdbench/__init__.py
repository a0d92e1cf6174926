"""The benchmark of the PyTorch + CUDA port, ``mdhelper_tpu_torch``.

``python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once, from the root of
a checkout, on the machine's CUDA cards.  Everything that belongs to one
configuration, traffic mix, per-layer metric, trajectory generator or
reference sits in a file of its own under this folder, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``generators/<generator>.py`` and
``reference/<kind>.py``.
"""
