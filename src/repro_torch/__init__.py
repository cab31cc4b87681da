"""PyTorch + CUDA port of the AI-tax reproduction (``src/repro``).

The package mirrors ``repro``'s layout and is held to it by the tests,
which feed both the same inputs. It imports ``torch`` and numpy, never
JAX and nothing of ``repro``: what it needs from modules there it keeps
as its own copy. Its kernels (:mod:`repro_torch.kernels`) are CUDA C++
written for the H100 (``sm_90a``), each with a plain PyTorch version
that runs only for CPU tensors.

Ported so far: the face-recognition frame path of
:class:`repro_torch.core.pipeline.StreamingPipeline` with device NMS; the
continuous-batching LM engine of
:class:`repro_torch.serve.engine.ServingEngine` on llama3-8b, qwen2.5-14b,
chameleon-34b, jamba-v0.1-52b, rwkv6-3b and granite-moe-3b-a800m; the
serving cluster of :class:`repro_torch.cluster.ServingCluster` with its
DES, queueing and TCO models, whose real-service replicas run the
identify stack; and the paper's tax meter for one accelerated step
(:class:`repro_torch.core.taxmeter.TaxedStep`) with its Amdahl analytics
(:mod:`repro_torch.core.acceleration`). Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when there is no card,
    so that nothing silently falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
