"""Model zoo of the port (counterpart of ``repro.models``): so far the dense
decoder-only family with GQA attention (llama3-8b)."""
