"""Distribution of the port (counterpart of ``repro.distributed``):
logical-axis sharding on DeviceMesh and DTensor, and the distributed
optimisation tricks (compressed gradients, distributed LSE)."""
