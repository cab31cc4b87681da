"""The face-recognition application and the edge data center's models:
event log, micro-batching, models and the streaming pipeline; the Kafka
broker, its discrete-event simulation, the queueing model and the TCO
tables; the paper's tax meter for one accelerated step (``taxmeter``) and
its Amdahl analytics (``acceleration``) (counterpart of ``repro.core``)."""
from repro_torch.core import acceleration, taxmeter  # noqa: F401
