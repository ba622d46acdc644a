"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``cell.py`` finds the
cell's files by name and builds the result line; ``drivers/`` run the
traffic mixes; ``reference/`` is the plain PyTorch that decides
``correct``; ``metrics/`` are the per-layer readers (what several share
is in ``readers.py``); ``flops.py`` and ``trace.py`` are the yardstick's
arithmetic and trace reduction; ``controls.py`` reads the numbers that
the limits were set from.
Importing this package loads nothing of the program.
"""
