"""``kernels_per_tick`` in the chat cell, read as in the code cell. The
chat cell's end-to-end metrics are the time to first token's tail and
the set-up; its host-paced rate is the per-layer
``output_tokens_per_s.chat``."""
from benchkit.harness import reader

read = reader("kernels_per_tick").read
