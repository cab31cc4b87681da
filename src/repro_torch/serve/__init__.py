"""LM serving of the port (counterpart of ``repro.serve``): the
continuous-batching engine, and the prefill and decode steps under mesh
shardings (``serve_step``)."""
