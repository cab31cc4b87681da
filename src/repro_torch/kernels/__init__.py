"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``csrc/`` holds the CUDA C++ sources (``sm_90a``), :mod:`.build` compiles
and loads them, and :mod:`.ops` is the entry the rest of the package
calls. Each kernel's wrapper carries a ``launches`` count.
"""
