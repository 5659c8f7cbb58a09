"""The benchmark of the PyTorch port (``repro_torch``) on NVIDIA GPUs.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that belongs to one configuration, traffic
mix, graph generator or per-layer metric is a file of its own here,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment (generator, scale, engine
  settings, the public source and what was cut from it);
* ``traffic/<traffic>.json``: the runner of the window and its
  parameters (start state, edits, ``arrivals_per_s`` for an open loop);
* ``runners/<runner>.py``: how one path of the program is set up on the
  cell's inputs, what one call of the window is, and what the reference
  answers (``Part``, ``reference_answer``, ``validate``);
* ``graphs/<generator>.py``: ``edges(scale, edge_factor, params,
  generator, device)``, the raw edge list made on the device from a seed;
* ``metrics/<metric>.py``: ``read(ctx)``, one metric, end to end or per
  layer, or ``None`` where the run has nothing to read it from.

Nothing here imports JAX or the JAX package ``repro``; from the port it
takes only the system under test (``bucketize`` and ``decompose``).
"""
