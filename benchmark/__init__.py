"""The benchmark of the PyTorch/CUDA port (``audio_inpainting_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one GPU and prints one JSON line.
Everything a cell needs is found by name: its configuration
(``configs/<name>.json``, which names a driver in ``drivers/`` and a
check in ``checks/``), its traffic mix (``workloads/<name>.json``), the
limits of its correctness check (``limits/<cell>.json``) and its
per-layer metrics (``layer_metrics/<metric>.py``). ``reference/`` is the
plain PyTorch reference that decides ``correct``; it imports nothing of
the port.
"""
