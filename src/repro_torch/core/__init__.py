"""The face-recognition application and the edge data center's models:
event log, micro-batching, models and the streaming pipeline; the Kafka
broker, its discrete-event simulation, the queueing model and the TCO
tables (counterpart of ``repro.core``)."""
