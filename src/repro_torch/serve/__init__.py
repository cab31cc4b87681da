"""LM serving of the port (counterpart of ``repro.serve``): the
continuous-batching engine. ``serve_step`` (mesh shardings) is not ported
yet."""
