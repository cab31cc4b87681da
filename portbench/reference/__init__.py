"""The plain float32 reference of the benchmark's models and of a training
step. It imports neither JAX, the JAX package, nor anything of the port:
only torch and the benchmark's own ``benchkit`` (the weights it draws
again from the seed, the configuration's layer kinds)."""
