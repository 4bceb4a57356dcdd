"""The benchmark of the PyTorch/CUDA port (``kepler_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Everything a cell needs is found by name:
``configs/<config>.json`` (the deployment), ``traffic/<traffic>.json``
(the mix, naming its driver in ``drivers/``), ``limits/<cell>.json``
(the limits of the comparison that decides ``correct``) and
``metrics/<metric>.py`` (one reader per metric). ``reference/`` is the
plain PyTorch reference the comparison holds the port to; it imports
nothing of the port.
"""
