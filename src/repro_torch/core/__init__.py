"""The face-recognition application: event log, micro-batching, models and
the streaming pipeline (counterpart of ``repro.core``)."""
