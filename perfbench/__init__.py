"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` for one seed. Everything a
cell is made of is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/``, the plain reference of its model in
``reference/``, the engine that serves it in ``engines/`` and, for a loop
other than the generator's ``closed`` and ``open``, the loop in
``loops/``; each metric's reader in ``metrics/``, each kernel's name
table in ``kernels/`` and its operation and byte count in ``counts/``, and
the limit of each compared number in ``limits/``. ``control.py`` reads
the numbers a limit is set from, ``knee.py`` sweeps an open mix's rate.
Nothing here imports JAX or the JAX package ``repro``; ``reference/``
imports nothing of ``repro_torch`` either.
"""
