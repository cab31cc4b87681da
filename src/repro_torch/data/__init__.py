"""Synthetic inputs (counterpart of ``repro.data``)."""
