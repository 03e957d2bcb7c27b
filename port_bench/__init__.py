"""The benchmark of ``petal_decomposition_tpu_torch`` on one NVIDIA card.

``run.py`` runs one cell once.  Everything that belongs to one
configuration, traffic mix, cell or metric sits in a file of its own,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: a model's settings and its data's shapes;
* ``traffic/<traffic>.json``: the entry the window drives and how its
  input is placed;
* ``limits/<cell>.json``: the limit of each number ``correct`` compares;
* ``families/<family>.py``: a model family's data, model and comparison,
  with its plain reference in ``reference/<family>.py`` and its
  operation counts in ``counts/<family>.py``;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader a
  metric.

Nothing here imports ``jax`` or the JAX package.
"""
