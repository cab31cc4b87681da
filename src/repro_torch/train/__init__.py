"""Training (counterpart of ``repro.train``): AdamW, the train step, the
checkpointer and the fault-tolerant trainer."""
