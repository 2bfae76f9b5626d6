"""The benchmark of the PyTorch and CUDA port (``das_diff_veh_tpu_torch``).

Everything is found by name, so that a later change adds a cell, a
configuration, a traffic mix or a per-layer metric as new files and edits
none that is there:

- ``BENCHMARK.json`` names each cell's configuration and traffic mix;
- ``benchmark/configs/<config>.json`` is the deployment, and its ``system``
  key names the adapter ``harness/systems/<system>.py`` that drives the
  program for it;
- ``benchmark/traffic/<mix>.json`` is the mix, parameters only, which the
  general generator in :mod:`harness.traffic` reads; its ``driver`` key names
  the adapter's entry (a batch folder, direct calls, or the serving engine);
- ``benchmark/metrics/<metric>.py`` reads one per-layer metric from the spans,
  counters and device trace of a ``--trace 1`` run.

The yardstick lives here too: the plain reference (``benchmark/reference``),
the traffic generator (:mod:`harness.traffic`), the reduction of the device
trace (:mod:`harness.trace`), and the comparisons that decide ``correct``
(in each system adapter).  Nothing here
imports JAX or the JAX package.
"""
