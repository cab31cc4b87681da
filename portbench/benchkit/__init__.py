"""The yardstick of the port's benchmark: everything a run needs that is
not the system under test.

* :mod:`benchkit.configs` reads a configuration file and builds the port's
  ``ModelConfig`` from it;
* :mod:`benchkit.weights` draws a configuration's weights on the device
  from the seed, one generator a layer, so that the reference can draw any
  layer again by itself;
* :mod:`benchkit.traffic` turns a traffic file into requests or batches;
* :mod:`benchkit.work`, :mod:`benchkit.peaks` and :mod:`benchkit.stats`
  are the frozen formulas: operations and bytes of a kernel's calls, the
  card's peaks, percentiles;
* :mod:`benchkit.trace` reads the profiler's trace, and
  :mod:`benchkit.window` hands it, with the drivers' spans and the work
  they booked, to the per-layer readers;
* :mod:`benchkit.checks` holds the comparisons that decide ``correct``;
* :mod:`benchkit.harness` runs one cell and prints its result line.

Nothing here imports the port at module level: the drivers under
``portbench/drivers`` call it, and :func:`benchkit.configs.port_config`
reads its registry of configurations.
"""
