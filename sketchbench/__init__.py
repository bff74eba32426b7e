"""sketchbench — the benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the root of the repository is the manifest. The
harness finds everything that belongs to one configuration, traffic mix or
metric by its name there:

  configs/<config>.json    a deployment: its sizes, its source and its plan
  traffic/<traffic>.json   a mix of parameters read by one general runner
  runners/<runner>.py      the code that runs the system under a mix
  metrics/<metric>.py      a reader that takes one metric from a run

A cell runs with ``python3 sketchbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Nothing here
imports ``jax``, ``jaxlib`` or the JAX package ``repro``; ``reference.py``
imports nothing of the port either.
"""
